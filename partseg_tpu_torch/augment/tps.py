"""Thin-plate-spline warp sampler, twin of partseg_tpu/augment/tps.py.

Produces, per sample, (a) the dense backward flow for image warping and
(b) the point transform T(·) with its analytic Jacobian J_T, which the
equivariance loss uses to move μ and Σ.

The control points are fixed per sampler, so the TPS system matrix
L = [[K, P], [Pᵀ, 0]] is inverted once on the host in f64, and the pixel
basis Φ_grid = [U(‖u−c_i‖), 1, y, x] is a static numpy table. A warp is

    targets = similarity(c) + noise       [n+3, 2], zero-padded
    weights = L⁻¹ @ targets               [n+3, 2] spline weights
    flow    = Φ_grid @ weights            fused into the tps_warp kernel

U(r) = r² log r² (U(0) = 0); ∂U/∂u = 2 (log r² + 1)(u − c_i).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from partseg_tpu_torch.partops.coords import _coord_grid_np, as_device_tensor, coord_grid


def _tps_u(sq_dist: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """U(r) as a function of squared distance s = r²: U = s·log(s), U(0)=0."""
    safe = torch.clamp(sq_dist, min=eps)
    return torch.where(sq_dist > eps, safe * torch.log(safe), torch.zeros_like(safe))


@dataclasses.dataclass(frozen=True)
class TPSParams:
    """Per-sample spline weights [..., n_ctrl + 3, 2]: rows 0..n-1 are the
    radial weights, the last 3 rows the affine part [b; A] acting on
    (y, x). Column j gives the j-th output coordinate."""

    weights: torch.Tensor


class TPSSampler:
    """Samples TPS warps and evaluates them (flow, points, Jacobian).

    grid_size: control grid of grid_size × grid_size points over [-1, 1]²;
    scale_sd, rot_sd, trans_sd: the global similarity's log-scale,
    rotation (radians) and translation stddevs; ctrl_sd: per-control-point
    displacement stddev (the non-rigid part).
    """

    def __init__(self, grid_size: int = 5, scale_sd: float = 0.10, rot_sd: float = 0.10,
                 trans_sd: float = 0.10, ctrl_sd: float = 0.10):
        self.grid_size = grid_size
        self.scale_sd = scale_sd
        self.rot_sd = rot_sd
        self.trans_sd = trans_sd
        self.ctrl_sd = ctrl_sd

        n = grid_size * grid_size
        lin = np.linspace(-1.0, 1.0, grid_size, dtype=np.float64)
        yy, xx = np.meshgrid(lin, lin, indexing="ij")
        ctrl = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)   # [n, 2]
        d2 = np.sum((ctrl[:, None, :] - ctrl[None, :, :]) ** 2, axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(d2 > 0, d2 * np.log(d2), 0.0)
        p = np.concatenate([np.ones((n, 1)), ctrl], axis=-1)        # [n, 3]
        lmat = np.zeros((n + 3, n + 3))
        lmat[:n, :n] = k
        lmat[:n, n:] = p
        lmat[n:, :n] = p.T
        # Solved in f64 on the host once; everything downstream is f32.
        self.n_ctrl = n
        self._ctrl_np = ctrl.astype(np.float32)
        self._l_inv_np = np.linalg.inv(lmat).astype(np.float32)
        self._basis_cache: dict[tuple[int, int], np.ndarray] = {}
        self._device_cache: dict[tuple, torch.Tensor] = {}

    def _const(self, name: str, device, make=None) -> torch.Tensor:
        """A constant table on ``device``, copied there once."""
        key = (name, torch.device(device))
        if key not in self._device_cache:
            array = make() if make is not None else getattr(self, f"_{name}_np")
            self._device_cache[key] = as_device_tensor(array, key[1])
        return self._device_cache[key]

    # ---------------------------------------------------------------- sampling

    @property
    def n_normals(self) -> int:
        """Standard normals per warp: log-scale, rotation, translation (2)
        and the control-point displacements (2 per point)."""
        return 4 + 2 * self.n_ctrl

    def sample(self, gen: torch.Generator, batch: tuple[int, ...] | int) -> TPSParams:
        """Sample a batch of warps from ``gen`` on its device."""
        shape = (batch,) if isinstance(batch, int) else tuple(batch)
        return self.from_normals(
            torch.randn(shape + (self.n_normals,), generator=gen, device=gen.device))

    def from_normals(self, z: torch.Tensor) -> TPSParams:
        """The warps of standard normals z [..., n_normals]."""
        n = self.n_ctrl
        log_s = z[..., 0] * self.scale_sd
        theta = z[..., 1] * self.rot_sd
        trans = z[..., 2:4] * self.trans_sd
        delta = z[..., 4:].reshape(z.shape[:-1] + (n, 2)) * self.ctrl_sd
        s = torch.exp(log_s)
        cos, sin = torch.cos(theta), torch.sin(theta)
        # Rotation acting on (y, x): [[cos, -sin], [sin, cos]].
        rot = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
        sim = s[..., None, None] * rot
        tgt = (torch.einsum("...ij,nj->...ni", sim, self._const("ctrl", z.device))
               + trans[..., None, :] + delta)                               # [..., n, 2]
        return self._solve(tgt)

    def _solve(self, tgt: torch.Tensor) -> TPSParams:
        rhs = torch.cat([tgt, tgt.new_zeros(tgt.shape[:-2] + (3, 2))], dim=-2)
        return TPSParams(torch.einsum("ij,...jk->...ik", self._const("l_inv", tgt.device), rhs))

    def identity(self, batch: tuple[int, ...] | int, device=None) -> TPSParams:
        """The identity warp (for tests and the unwarped part of a batch)."""
        shape = (batch,) if isinstance(batch, int) else tuple(batch)
        ctrl = self._const("ctrl", device or "cpu")
        return self._solve(ctrl.expand(shape + ctrl.shape))

    # -------------------------------------------------------------- evaluation

    def _basis(self, points: torch.Tensor) -> torch.Tensor:
        """Φ(p) = [U(‖p−c_i‖)..., 1, y, x] for points [..., 2] → [..., n+3]."""
        ctrl = self._const("ctrl", points.device)
        d2 = torch.sum((points[..., None, :] - ctrl) ** 2, dim=-1)          # [..., n]
        ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype, device=points.device)
        return torch.cat([_tps_u(d2), ones, points], dim=-1)

    def transform_points(self, params: TPSParams, points: torch.Tensor) -> torch.Tensor:
        """Apply T: params [..., n+3, 2] ⊗ points [..., P, 2] → [..., P, 2]."""
        phi = self._basis(points.float())
        return torch.einsum("...pn,...nk->...pk", phi, params.weights)

    def jacobian(self, params: TPSParams, points: torch.Tensor) -> torch.Tensor:
        """Analytic local Jacobian J_T at points: [..., P, 2, 2], with
        J[a, b] = A[b, a] + Σ_i w_i[a] · 2(log s_i + 1)(u − c_i)[b]."""
        p = points.float()
        diff = p[..., None, :] - self._const("ctrl", p.device)              # [..., P, n, 2]
        d2 = torch.sum(diff * diff, dim=-1)                                 # [..., P, n]
        safe = torch.clamp(d2, min=1e-9)
        du = torch.where((d2 > 1e-9)[..., None], 2.0 * (torch.log(safe) + 1.0)[..., None] * diff,
                         torch.zeros_like(diff))                            # [..., P, n, 2]
        w = params.weights[..., : self.n_ctrl, :]                           # [..., n, 2]
        j_rad = torch.einsum("...pnb,...na->...pab", du, w)
        a_mat = params.weights[..., self.n_ctrl + 1:, :]                    # [..., 2, 2]
        return a_mat.transpose(-1, -2)[..., None, :, :] + j_rad

    def _flow_basis_np(self, h: int, w: int) -> np.ndarray:
        if (h, w) not in self._basis_cache:
            yy, xx = _coord_grid_np(h, w)
            grid = np.stack([yy.reshape(-1), xx.reshape(-1)], -1)           # [HW, 2]
            d2 = np.sum((grid[:, None, :] - self._ctrl_np[None, :, :]) ** 2, axis=-1)
            with np.errstate(divide="ignore", invalid="ignore"):
                u = np.where(d2 > 1e-9, d2 * np.log(d2), 0.0)
            ones = np.ones((grid.shape[0], 1), np.float32)
            self._basis_cache[(h, w)] = np.concatenate([u, ones, grid], axis=-1).astype(np.float32)
        return self._basis_cache[(h, w)]

    def flow_basis(self, h: int, w: int, device=None) -> torch.Tensor:
        """The static pixel-grid basis Φ_grid [H·W, n+3] f32 (numpy-cached,
        copied to each device once). ``Φ_grid @ weights`` is the dense flow;
        the tps_warp kernel takes this table directly."""
        return self._const(f"basis{h}x{w}", device or "cpu", lambda: self._flow_basis_np(h, w))

    def flow_field(self, params: TPSParams, h: int, w: int) -> torch.Tensor:
        """Dense backward flow: source coords T(u) for every output pixel,
        [..., H, W, 2], for ``partops.warp.warp_image``."""
        yy, xx = coord_grid(h, w, device=params.weights.device)
        grid = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)        # [HW, 2]
        flow = torch.einsum("pn,...nk->...pk", self._basis(grid), params.weights)
        return flow.reshape(params.weights.shape[:-2] + (h, w, 2))

    def warp(self, params: TPSParams, image: torch.Tensor,
             padding_mode: str = "border") -> torch.Tensor:
        """Warp images [B, H, W, C] with per-sample params.

        Border padding goes to the ``tps_warp`` kernel (flow and sample
        fused; its plain version on a CPU tensor); other modes build the
        explicit flow and go through ``warp_image``. On the card a basis
        whose rows are not a multiple of 4 floats goes to the kernel padded
        with zero columns, and the weights with it (the same flow), kept
        once per device. The JAX package picks
        between these by ``AugmentConfig.warp_impl`` and the backend; the
        port always takes its kernels on the card, so that field is kept
        for parity only."""
        from partseg_tpu_torch.partops.kernels.tps_warp import tps_warp
        from partseg_tpu_torch.partops.warp import warp_image

        _, h, w, _ = image.shape
        if padding_mode == "border":
            weights, basis = params.weights.contiguous(), self.flow_basis(h, w, image.device)
            pad = -basis.shape[1] % 4
            if image.is_cuda and pad:   # 16-byte basis rows for the kernel's wide path
                weights = torch.nn.functional.pad(weights, (0, 0, 0, pad))
                basis = self._const(f"basis{h}x{w}_padded", image.device, lambda: np.pad(
                    self._flow_basis_np(h, w), ((0, 0), (0, pad))))
            return tps_warp(image, weights, basis)
        return warp_image(image, self.flow_field(params, h, w), padding_mode=padding_mode)
