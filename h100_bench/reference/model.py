"""The plain reference of the part-based disentangling model (Lorenz et al.,
CVPR 2019, "Unsupervised Part-Based Disentangling of Object Shape and
Appearance"), in float32 plain PyTorch, with no kernels.

Module names follow the program's ``state_dict`` keys, so one set of weights
made by the benchmark loads into both. Images and part maps are NHWC at the
public methods; convolutions run on NCHW tensors.

    shape stream:      logits = ShapeEncoder(x) → per-part spatial softmax → (μ, Σ)
    appearance stream: f = AppearanceEncoder(x_s); a_k = Σ_u p_k(u) f(u) / Σ_u p_k(u)
    decoder:           at each scale, φ_k(u) = exp(−½ (u−μ_k)ᵀ Λ_k (u−μ_k)) and
                       Σ_k φ_k ⊗ proj(a_k), concatenated with the upsampled trunk
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


# ------------------------------------------------------------------ part ops

def coord_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre coordinates in [-1, 1], (y, x), each [H, W] f32."""
    ys = -1.0 + (2.0 * (np.arange(h, dtype=np.float32) + 0.5)) / h
    xs = -1.0 + (2.0 * (np.arange(w, dtype=np.float32) + 0.5)) / w
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return torch.tensor(yy, device=device), torch.tensor(xx, device=device)


def spatial_moments(logits: torch.Tensor):
    """Per-part softmax over the pixels of logits [B, H, W, K] → (p, μ [B, K, 2],
    Σ [B, K, 2, 2]), from the raw moments E[y], E[x], E[y²], E[yx], E[x²]."""
    b, h, w, k = logits.shape
    p = torch.softmax(logits.float().reshape(b, h * w, k), dim=1)
    yy, xx = coord_grid(h, w, logits.device)
    y, x = yy.reshape(-1), xx.reshape(-1)
    basis = torch.stack([y, x, y * y, y * x, x * x], dim=-1)              # [HW, 5]
    ey, ex, eyy, eyx, exx = torch.einsum("bnk,nm->bkm", p, basis).unbind(-1)
    mu = torch.stack([ey, ex], dim=-1)
    cyy, cyx, cxx = eyy - ey * ey, eyx - ey * ex, exx - ex * ex
    sigma = torch.stack([torch.stack([cyy, cyx], -1), torch.stack([cyx, cxx], -1)], -2)
    return p.reshape(b, h, w, k), mu, sigma


def precision(sigma: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """(Σ + eps·I)⁻¹ in closed form, the determinant floored at eps²."""
    a, bq, d = sigma[..., 0, 0] + eps, sigma[..., 0, 1], sigma[..., 1, 1] + eps
    inv_det = 1.0 / torch.clamp(a * d - bq * bq, min=eps * eps)
    return torch.stack([torch.stack([d * inv_det, -bq * inv_det], -1),
                        torch.stack([-bq * inv_det, a * inv_det], -1)], -2)


def render(mu: torch.Tensor, lam: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Gaussian blobs [B, H, W, K] of centres μ and precisions Λ."""
    yy, xx = coord_grid(h, w, mu.device)
    dy = yy[None, :, :, None] - mu[:, None, None, :, 0]
    dx = xx[None, :, :, None] - mu[:, None, None, :, 1]
    d = (lam[:, None, None, :, 0, 0] * dy * dy + 2.0 * lam[:, None, None, :, 0, 1] * dy * dx
         + lam[:, None, None, :, 1, 1] * dx * dx)
    return torch.exp(-0.5 * torch.clamp(d, min=0.0))


def assemble(blobs: torch.Tensor, app: torch.Tensor) -> torch.Tensor:
    """Σ_k φ_k(u) a_k: blobs [B, H, W, K], app [B, K, C] → [B, H, W, C]."""
    b, h, w, k = blobs.shape
    return torch.bmm(blobs.reshape(b, h * w, k), app).reshape(b, h, w, app.shape[-1])


def pool_appearance(feats: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    """a_k = Σ_u p_k(u) f(u) / (Σ_u p_k(u) + 1e-8): [B, K, C]."""
    b, h, w, c = feats.shape
    p = parts.reshape(b, h * w, -1)
    num = torch.bmm(p.transpose(1, 2), feats.reshape(b, h * w, c))
    return num / (p.sum(dim=1).unsqueeze(-1) + 1e-8)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ------------------------------------------------------------------ blocks

class Conv(nn.Conv2d):
    """Square kernel, stride 1, "SAME" padding."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__(cin, cout, kernel, padding=kernel // 2)


class GroupNorm(nn.GroupNorm):
    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-6)


class ConvBlock(nn.Module):
    """(GroupNorm) → ReLU → conv."""

    def __init__(self, cin: int, cout: int, kernel: int, norm: bool):
        super().__init__()
        self.norm = GroupNorm(min(8, cin), cin) if norm else None
        self.conv = Conv(cin, cout, kernel)

    def forward(self, x):
        if self.norm is not None:
            x = self.norm(x)
        return self.conv(F.relu(x))


class ResBlock(nn.Module):
    """One GroupNorm at the entry (its output is also the skip's input), then
    1×1 (C/2) → 3×3 (C/2) → 1×1 (C) pre-activation convs, a 1×1 projection on
    the skip when the width changes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = max(cout // 2, 8)
        self.norm = GroupNorm(min(8, cin), cin)
        self.convs = nn.ModuleList([ConvBlock(cin, half, 1, False), ConvBlock(half, half, 3, False),
                                    ConvBlock(half, cout, 1, False)])
        self.skip = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        x = self.norm(x)
        y = x
        for conv in self.convs:
            y = conv(y)
        return (self.skip(x) if self.skip is not None else x) + y


class Hourglass(nn.Module):
    """3·depth + 1 ResBlocks, used depth first: skip, pooled, recurse, pooled."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        self.blocks = nn.ModuleList(ResBlock(features, features) for _ in range(3 * depth + 1))

    def forward(self, x):
        blocks = iter(self.blocks)

        def level(x, d):
            up = next(blocks)(x)
            low = next(blocks)(F.avg_pool2d(x, 2))
            low = level(low, d - 1) if d > 1 else next(blocks)(low)
            return up + upsample2x(next(blocks)(low))

        return level(x, self.depth)


class Stem(nn.Module):
    """Space-to-depth by ``stride`` (channels in (sy, sx, c) order), conv, ResBlock."""

    def __init__(self, features: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = Conv(3 * stride * stride, features // 2, 3)
        self.res = ResBlock(features // 2, features)

    def forward(self, x):
        b, h, w, c = x.shape
        s = self.stride
        x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
        return self.res(self.conv(nchw(x.reshape(b, h // s, w // s, s * s * c))))


def run(block: nn.Module, x, remat: bool):
    """``block(x)``; with ``remat`` under gradient, its activations are
    recomputed in the backward instead of kept (the same values, less memory)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


class Encoder(nn.Module):
    """Stem → hourglass(es) → GroupNorm-ReLU-1×1 → 1×1 head; NHWC out."""

    remat = False

    def __init__(self, m: dict, out: int, stacked: bool):
        super().__init__()
        self.stem = Stem(m["features"], m["stem_stride"])
        hgs = [Hourglass(m["depth"], m["features"]) for _ in range(m["n_stacks"])]
        if stacked:
            self.hourglasses = nn.ModuleList(hgs)
        else:
            self.hourglass = hgs[0]
        self.head_block = ConvBlock(m["features"], m["features"], 1, True)
        self.head = Conv(m["features"], out, 1)
        self.head_upsample = m["head_upsample"]

    def forward(self, x):
        x = run(self.stem, x, self.remat)
        for hg in (self.hourglasses if hasattr(self, "hourglasses") else [self.hourglass]):
            x = run(hg, x, self.remat)
        if self.head_upsample:
            x = upsample2x(x)
        return nhwc(self.head(self.head_block(x)))


class Decoder(nn.Module):
    remat = False

    def __init__(self, m: dict):
        super().__init__()
        self.n_scales = m["decoder_scales"]
        self.out_size = m["decoder_out_size"] or m["img_size"]
        widths = [m["decoder_features"][min(i, len(m["decoder_features"]) - 1)]
                  for i in range(self.n_scales)]
        self.app_proj = nn.ModuleList(nn.Linear(m["app_features"], f) for f in widths)
        blocks, prev = [], 0
        for i, f in enumerate(widths):
            blocks += [ResBlock(f if i == 0 else prev + f, f), ResBlock(f, f)]
            prev = f
        self.blocks = nn.ModuleList(blocks)
        self.to_rgb = Conv(widths[-1], 3, 1)

    def forward(self, mu, sigma, app):
        lam = precision(sigma)
        x = None
        for i in range(self.n_scales):
            res = self.out_size // 2 ** (self.n_scales - 1 - i)
            feat = nchw(assemble(render(mu, lam, res, res), self.app_proj[i](app)))
            x = feat if x is None else torch.cat([upsample2x(x), feat], dim=1)
            x = run(self.blocks[2 * i + 1], run(self.blocks[2 * i], x, self.remat), self.remat)
        return nhwc(torch.sigmoid(self.to_rgb(x)))


class PartNet(nn.Module):
    """The whole model; ``m`` is the configuration file's ``model`` group."""

    def __init__(self, m: dict, remat: bool = False):
        super().__init__()
        for key, want in (("norm", "block"), ("spatial_norm", "softmax"), ("pool_masks", "pixel"),
                          ("render_kernel", "gauss")):
            if m[key] != want:
                raise ValueError(f"the reference implements {key}={want!r}, not {m[key]!r}")
        self.m = m
        k = m["n_parts"] + (1 if m["background"] else 0)
        self.shape_enc = Encoder(m, k, stacked=True)
        self.app_enc = Encoder(m, m["app_features"], stacked=False)
        self.decoder = Decoder(m)
        for block in self.modules():
            if isinstance(block, (Encoder, Decoder)):
                block.remat = remat

    def shape_stats(self, logits):
        return spatial_moments(logits[..., : self.m["n_parts"]])

    def forward(self, x_s, x_a) -> dict:
        b, k = x_s.shape[0], self.m["n_parts"]
        logits = self.shape_enc(torch.cat([x_a, x_s], dim=0))
        logits_a, logits_s = logits[:b], logits[b:]
        _, mu_a, sigma_a = self.shape_stats(logits_a)
        _, mu_s, sigma_s = self.shape_stats(logits_s)
        masks_s = torch.softmax(logits_s, dim=-1)[..., :k]
        appearance = pool_appearance(self.app_enc(x_s), masks_s)
        return {"recon": self.decoder(mu_a, sigma_a, appearance), "logits_a": logits_a,
                "mu_a": mu_a, "sigma_a": sigma_a, "mu_s": mu_s, "sigma_s": sigma_s,
                "appearance": appearance}


# ------------------------------------------------------------------ serving

def infer(model: PartNet, images: torch.Tensor) -> dict:
    """The shape encoder's outputs for images [B, H, W, 3]: heatmaps, logits,
    landmarks, sigma and seg (0 = background, part k → k + 1)."""
    k = model.m["n_parts"]
    logits = model.shape_enc(images)
    parts, mu, sigma = model.shape_stats(logits)
    seg = torch.argmax(torch.softmax(logits, dim=-1), dim=-1)
    if model.m["background"]:
        seg = torch.where(seg == k, 0, seg + 1)
    return {"heatmaps": parts, "logits": logits, "landmarks": mu, "sigma": sigma,
            "seg": seg.to(torch.int32)}


def transfer(model: PartNet, shape_imgs: torch.Tensor, app_imgs: torch.Tensor) -> torch.Tensor:
    """Decode the shape of ``shape_imgs`` with the per-part appearance of ``app_imgs``."""
    _, mu, sigma = model.shape_stats(model.shape_enc(shape_imgs))
    parts_a, _, _ = model.shape_stats(model.shape_enc(app_imgs))
    return model.decoder(mu, sigma, pool_appearance(model.app_enc(app_imgs), parts_a))
