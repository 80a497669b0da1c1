"""The plain reference of the paired augmentation: per-sample keyed draws,
the thin-plate-spline warp (x_s, geometry changed) and the colour jitter
(x_a, appearance changed), in float32 (the TPS system solved in float64).

A sample's draws are a function of (seed, step, sample id) alone: the
``lowbias32`` integer hash on uint32 counters, the top 24 bits as uniforms,
Box-Muller for the normals. Draw order per sample: the jitter's 4 uniforms,
then the warp's 4 + 2·n_ctrl normals (log-scale, rotation, translation,
control-point displacements).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100_bench.reference.model import coord_grid

_M32 = 0xFFFFFFFF
_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def uniforms(seed: int, step: int, ids: np.ndarray, count: int) -> np.ndarray:
    """[B, count] float64 uniforms in (0, 1) of the samples ``ids`` at ``step``."""
    k = mix32(mix32(np.array([seed & _M32], np.uint32)) + _GOLDEN)
    k = mix32(k ^ np.uint32(step & _M32))
    keys = mix32((np.asarray(ids, np.int64).reshape(-1) & _M32).astype(np.uint32) ^ k)
    ctr = mix32(np.arange(count, dtype=np.uint32) * _GOLDEN)
    bits = mix32(mix32(keys[:, None] ^ ctr[None, :]))
    return ((bits >> np.uint32(8)).astype(np.float64) + 0.5) * (1.0 / (1 << 24))


def box_muller(u: np.ndarray) -> np.ndarray:
    m = u.shape[-1] // 2
    r = np.sqrt(-2.0 * np.log(u[:, :m]))
    theta = (2 * np.pi) * u[:, m:2 * m]
    return np.concatenate([r * np.cos(theta), r * np.sin(theta)], axis=-1)


class TPS:
    """Thin-plate splines on a grid × grid control lattice over [-1, 1]²;
    U(r) = r² log r². Weights [B, n + 3, 2]: n radial rows, then [b; A] on (1, y, x)."""

    def __init__(self, a: dict, device):
        g = a["tps_grid"]
        self.a, self.device, self.n = a, device, g * g
        lin = np.linspace(-1.0, 1.0, g)
        yy, xx = np.meshgrid(lin, lin, indexing="ij")
        ctrl = np.stack([yy.reshape(-1), xx.reshape(-1)], -1)
        d2 = np.sum((ctrl[:, None] - ctrl[None]) ** 2, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(d2 > 0, d2 * np.log(d2), 0.0)
        p = np.concatenate([np.ones((self.n, 1)), ctrl], -1)
        lmat = np.zeros((self.n + 3, self.n + 3))
        lmat[:self.n, :self.n], lmat[:self.n, self.n:], lmat[self.n:, :self.n] = k, p, p.T
        self.ctrl = torch.tensor(ctrl, dtype=torch.float32, device=device)
        self.l_inv = torch.tensor(np.linalg.inv(lmat), dtype=torch.float32, device=device)

    @property
    def n_normals(self) -> int:
        return 4 + 2 * self.n

    def solve(self, tgt: torch.Tensor) -> torch.Tensor:
        rhs = torch.cat([tgt, tgt.new_zeros(tgt.shape[:-2] + (3, 2))], dim=-2)
        return torch.einsum("ij,bjk->bik", self.l_inv, rhs)

    def from_normals(self, z: torch.Tensor) -> torch.Tensor:
        a = self.a
        s = torch.exp(z[:, 0] * a["tps_scale_sd"])
        th = z[:, 1] * a["tps_rot_sd"]
        rot = torch.stack([torch.stack([torch.cos(th), -torch.sin(th)], -1),
                           torch.stack([torch.sin(th), torch.cos(th)], -1)], -2)
        tgt = (torch.einsum("bij,nj->bni", s[:, None, None] * rot, self.ctrl)
               + (z[:, 2:4] * a["tps_trans_sd"])[:, None, :]
               + z[:, 4:].reshape(-1, self.n, 2) * a["tps_ctrl_sd"])
        return self.solve(tgt)

    def identity(self, b: int) -> torch.Tensor:
        return self.solve(self.ctrl.expand(b, self.n, 2))

    def basis(self, pts: torch.Tensor) -> torch.Tensor:
        d2 = torch.sum((pts[..., None, :] - self.ctrl) ** 2, -1)
        safe = torch.clamp(d2, min=1e-9)
        u = torch.where(d2 > 1e-9, safe * torch.log(safe), torch.zeros_like(safe))
        return torch.cat([u, torch.ones_like(pts[..., :1]), pts], -1)

    def transform(self, w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bpn,bnk->bpk", self.basis(pts), w)

    def jacobian(self, w: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        diff = pts[..., None, :] - self.ctrl
        d2 = torch.sum(diff * diff, -1)
        safe = torch.clamp(d2, min=1e-9)
        du = torch.where((d2 > 1e-9)[..., None], 2.0 * (torch.log(safe) + 1.0)[..., None] * diff,
                         torch.zeros_like(diff))
        j_rad = torch.einsum("bpnc,bna->bpac", du, w[:, :self.n])
        return w[:, self.n + 1:].transpose(-1, -2)[:, None] + j_rad

    def warp(self, w: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """Backward warp of img [B, H, W, C] by the flow T(u), border padding,
        bilinear taps at pixel-centre coordinates."""
        b, h, wd, c = img.shape
        yy, xx = coord_grid(h, wd, img.device)
        flow = self.transform(w, torch.stack([yy.reshape(-1), xx.reshape(-1)], -1).expand(b, -1, 2))
        fy = (flow[..., 0] + 1.0) * (0.5 * h) - 0.5
        fx = (flow[..., 1] + 1.0) * (0.5 * wd) - 0.5
        y0, x0 = torch.floor(fy), torch.floor(fx)
        wy, wx = (fy - y0)[..., None], (fx - x0)[..., None]
        y0, x0 = y0.long(), x0.long()
        flat = img.reshape(b, h * wd, c)

        def take(yi, xi):
            idx = yi.clamp(0, h - 1) * wd + xi.clamp(0, wd - 1)
            return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))

        top = take(y0, x0) + (take(y0, x0 + 1) - take(y0, x0)) * wx
        bot = take(y0 + 1, x0) + (take(y0 + 1, x0 + 1) - take(y0 + 1, x0)) * wx
        return (top + (bot - top) * wy).reshape(b, h, wd, c)


_RGB2YIQ = np.asarray([[0.299, 0.587, 0.114], [0.5959, -0.2746, -0.3213],
                       [0.2115, -0.5227, 0.3112]], np.float32)


def color_jitter(x: torch.Tensor, u: torch.Tensor, a: dict) -> torch.Tensor:
    """Brightness, contrast, saturation and hue (a rotation of YIQ's IQ plane)
    from uniforms u [B, 4]; clipped to [0, 1]."""
    def scaled(i, lo, hi):
        return (u[:, i] * (hi - lo) + lo)[:, None, None, None]

    bright = scaled(0, -a["brightness"], a["brightness"])
    contrast = scaled(1, 1.0 - a["contrast"], 1.0 + a["contrast"])
    sat = scaled(2, 1.0 - a["saturation"], 1.0 + a["saturation"])
    hue = u[:, 3] * (2 * a["hue"]) - a["hue"]
    rgb2yiq = torch.tensor(_RGB2YIQ, device=x.device)
    yiq2rgb = torch.tensor(np.linalg.inv(_RGB2YIQ).astype(np.float32), device=x.device)
    c, s = torch.cos(hue), torch.sin(hue)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1),
                       torch.stack([z, s, c], -1)], -2)
    x = torch.einsum("bhwc,bdc->bhwd", x, yiq2rgb @ rot @ rgb2yiq)
    gray = torch.einsum("bhwc,c->bhw", x, rgb2yiq[0])[..., None]
    x = gray + (x - gray) * sat
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(mean + (x - mean) * contrast + bright, 0.0, 1.0)


def make_pair(images: torch.Tensor, seed: int, step: int, ids: np.ndarray, tps: TPS,
              a: dict, warp_on: bool = True) -> dict:
    """x_s (warped), x_a (jittered) and the warp applied to x_s, for the
    samples ``ids`` at ``step``."""
    if a["warp_appearance_view"] or a["padding_mode"] != "border":
        raise ValueError("the reference implements border padding and an unwarped x_a")
    n = tps.n_normals
    u = uniforms(seed, step, ids, 4 + n + n % 2)
    z = np.concatenate([u[:, :4], box_muller(u[:, 4:])[:, :n]], axis=1).astype(np.float32)
    z = torch.tensor(z, device=images.device)
    w = tps.from_normals(z[:, 4:])
    b = images.shape[0]
    if not warp_on:
        w, x_s = tps.identity(b), images
    elif a["warp_fraction"] < 1.0:
        nw = min(b, max(1, math.ceil(b * a["warp_fraction"])))
        x_s = torch.cat([tps.warp(w[:nw], images[:nw]), images[nw:]], dim=0)
        w = torch.cat([w[:nw], tps.identity(b - nw)], dim=0)
    else:
        x_s = tps.warp(w, images)
    return {"x_s": x_s, "x_a": color_jitter(images, z[:, :4], a), "tps": w}
