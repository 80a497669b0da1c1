"""Fused Gaussian render + decoder-input assembly.

Replaces the Pallas TPU kernel ``partseg_tpu/partops/pallas/render_assemble.py``
(``render_assemble``). The CUDA kernel (``csrc/render_assemble.cu``)
computes out[b, u, c] = Σ_k φ_k(u)·a[b, k, c] without writing the
[B, H, W, K] blob tensor, summing in f32 whatever the appearance dtype.

``render_assemble`` is an autograd Function, as the JAX ``custom_vjp`` is:

- its forward launches the kernel on a CUDA tensor (or raises) and runs
  the plain version (``render_gaussians(..., precision=lam)`` +
  ``assemble_decoder_input`` in f32) on a CPU tensor;
- its backward is the closed form of the JAX ``_bwd``: it recomputes φ,
  and puts the whole off-diagonal Λ cotangent on ``[..., 0, 1]`` because
  the forward reads only that entry (doubled). On a CUDA tensor the
  backward kernel of the same file computes it, for every K and C the
  wrapper takes: a block walks the channels in chunks of CHUNK_CHANNELS
  and the parts in groups (one of K <= NARROW_PARTS, else of GROUP_PARTS),
  and adds each chunk's share of the five sums Σ g_d·{dy, dx, dy², dy·dx,
  dx²}, which are linear in g_φ (one launch where a thread block cluster
  takes a whole image, else per-block partial sums and a fixed-order sum
  over them: no atomics, so the result is the same on every run); on a
  CPU tensor ``render_assemble_vjp``, the plain version, does.
  The registry counter ``kernel.render_assemble.backward_launches``
  (``tracing``) counts the wrapper's calls that launch it.
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.partops.assembly import assemble_decoder_input
from partseg_tpu_torch.partops.coords import coord_grid
from partseg_tpu_torch import tracing
from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.render import RENDER_KERNELS, render_gaussians

MAX_PARTS = 32           # kMaxParts in csrc/render_assemble.cu
MAX_BATCH = 65535        # gridDim.y
# The backward kernel: K <= NARROW_PARTS is one group of parts, larger K
# groups of GROUP_PARTS (blockIdx.z); the channels go in chunks of
# CHUNK_CHANNELS. An image of at most MAX_CLUSTER tiles is one thread block
# cluster per group (one launch; its CTAs take tiles, and chunks, side by
# side); a larger one is walked by min(tiles, TARGET_BLOCKS // B) blocks per
# group, each taking the chunks one after the other, whose partial sums a
# second launch adds up.
NARROW_PARTS = 12        # 4·3: the group of K <= 12
GROUP_PARTS = 16         # 4·kBwdGroupKQ
CHUNK_CHANNELS = 128     # 4·kBwdMaxQuads
MAX_CLUSTER = 8          # kBwdMaxCluster
TARGET_BLOCKS = 1024     # kTargetBlocks
BWD_TILE = 256           # most pixels per backward block


def backward_groups(k: int) -> int:
    """Part groups of the backward kernel, each reading g once."""
    return 1 if k <= NARROW_PARTS else -(-k // GROUP_PARTS)


def backward_chunks(c: int) -> int:
    """Channel chunks of the backward kernel, walked one after the other."""
    return -(-c // CHUNK_CHANNELS)


def backward_tile(k: int, c: int, hw: int) -> int:
    """Pixels per tile of the backward kernel: 64 for images of at most 128
    pixels, 128 up to 512 pixels (two CTAs to an image), else BWD_TILE;
    BWD_TILE whatever the image where C > CHUNK_CHANNELS, whose chunks
    take the cluster's CTAs side by side (measured faster on the H100 at
    16²×256 than two or four tiles an image). K does not enter it."""
    if c > CHUNK_CHANNELS:
        return BWD_TILE
    return 64 if hw <= 128 else 128 if hw <= 512 else BWD_TILE


def backward_partial_rows(k: int, c: int, hw: int, b: int, tile: int) -> int:
    """Rows of partial sums per image in the backward's scratch: none where
    one cluster takes the image, else one per block of a group."""
    tiles = -(-hw // tile)
    return 0 if tiles <= MAX_CLUSTER else min(tiles, max(1, TARGET_BLOCKS // b))


def render_assemble_plain(mu, lam, app, h: int, w: int, kernel: str = "gauss"):
    """The plain PyTorch version, [B, h, w, C] f32."""
    blobs = render_gaussians(mu, None, h, w, kernel=kernel, precision=lam)
    return assemble_decoder_input(blobs, app.float())


def _check(mu, lam, app, h, w, kernel) -> None:
    if kernel not in RENDER_KERNELS:
        raise ValueError(f"unknown render kernel: {kernel!r}")
    if mu.dtype != torch.float32 or lam.dtype != torch.float32:
        raise TypeError(f"render_assemble takes float32 mu and lam, got {mu.dtype}, {lam.dtype}")
    if app.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"render_assemble takes float32 or bfloat16 appearance, got {app.dtype}")
    if app.dim() != 3 or app.numel() == 0 or h <= 0 or w <= 0:
        raise ValueError(f"render_assemble takes non-empty [B, K, C] appearance, got {tuple(app.shape)}")
    b, k, c = app.shape
    if tuple(mu.shape) != (b, k, 2) or tuple(lam.shape) != (b, k, 2, 2):
        raise ValueError(
            f"render_assemble shapes disagree: mu {tuple(mu.shape)}, lam {tuple(lam.shape)}, "
            f"app {tuple(app.shape)}"
        )
    if not (mu.is_contiguous() and lam.is_contiguous() and app.is_contiguous()):
        raise ValueError("render_assemble takes contiguous mu, lam and appearance")
    if not (mu.device == lam.device == app.device):
        raise ValueError("render_assemble inputs lie on different devices")
    if k > MAX_PARTS:
        raise ValueError(f"render_assemble takes at most {MAX_PARTS} parts, got {k}")
    if b > MAX_BATCH:
        raise ValueError(f"render_assemble takes at most {MAX_BATCH} images, got {b}")


def _launch(mu, lam, app, h, w, kernel):
    b, k, c = app.shape
    out = torch.empty((b, h, w, c), device=app.device, dtype=torch.float32)
    _build.launch("partseg_render_assemble", app.device,
                  mu.data_ptr(), lam.data_ptr(), app.data_ptr(), int(app.dtype == torch.bfloat16),
                  out.data_ptr(), b, k, c, h, w, int(kernel == "gauss"))
    tracing.count("kernel.render_assemble.launches")
    return out


def _launch_backward(mu, lam, app, h, w, kernel, g):
    b, k, c = app.shape
    dev = app.device
    g = g.float().contiguous()
    tile = backward_tile(k, c, h * w)
    rows = backward_partial_rows(k, c, h * w, b, tile)
    part = torch.empty((b, rows, k, c + 5), device=dev, dtype=torch.float32) if rows else None
    d_mu = torch.empty((b, k, 2), device=dev, dtype=torch.float32)
    d_lam = torch.empty((b, k, 2, 2), device=dev, dtype=torch.float32)
    d_app = torch.empty((b, k, c), device=dev, dtype=app.dtype)
    _build.launch("partseg_render_assemble_bwd", dev,
                  mu.data_ptr(), lam.data_ptr(), app.data_ptr(), g.data_ptr(),
                  int(app.dtype == torch.bfloat16), part.data_ptr() if rows else None, d_app.data_ptr(),
                  d_mu.data_ptr(), d_lam.data_ptr(), b, k, c, h, w, int(kernel == "gauss"), tile)
    tracing.count("kernel.render_assemble.backward_launches")
    return d_mu, d_lam, d_app


def render_assemble_backward(mu, lam, app, h: int, w: int, kernel: str, g):
    """(d_mu, d_lam, d_app) from the output cotangent g [B, h, w, C]: the
    backward kernel on a CUDA tensor, ``render_assemble_vjp`` on a CPU one."""
    if app.device.type == "cpu":
        return render_assemble_vjp(mu, lam, app, h, w, kernel, g)
    return _launch_backward(mu, lam, app, h, w, kernel, g)


def render_assemble_vjp(mu, lam, app, h: int, w: int, kernel: str, g):
    """(d_mu, d_lam, d_app) from the output cotangent g [B, h, w, C]: the
    plain version of the backward kernel, in einsums."""
    b, k, c = app.shape
    gf = g.reshape(b, h * w, c).float()
    yy, xx = coord_grid(h, w, device=mu.device)
    u = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)           # [HW, 2]
    diff = u[None, :, None, :] - mu[:, None, :, :].float()              # [B, HW, K, 2]
    lamf = lam.float()
    d = torch.clamp(torch.einsum("bnki,bkij,bnkj->bnk", diff, lamf, diff), min=0.0)
    if kernel == "gauss":
        phi = torch.exp(-0.5 * d)
        dphi_dd = -0.5 * phi
    else:
        phi = 1.0 / (1.0 + d)
        dphi_dd = -(phi * phi)
    d_app = torch.einsum("bnk,bnc->bkc", phi, gf)
    g_d = torch.einsum("bnc,bkc->bnk", gf, app.float()) * dphi_dd
    # d = diffᵀ Λ diff:  ∂d/∂μ = −2 Λ diff;  ∂d/∂Λ = diff diffᵀ.
    d_mu = torch.einsum("bnk,bkij,bnkj->bki", g_d, -2.0 * lamf, diff)
    d_sym = torch.einsum("bnk,bnki,bnkj->bkij", g_d, diff, diff)
    zero = torch.zeros_like(d_sym[..., 0, 0])
    d_lam = torch.stack([
        torch.stack([d_sym[..., 0, 0], d_sym[..., 0, 1] + d_sym[..., 1, 0]], dim=-1),
        torch.stack([zero, d_sym[..., 1, 1]], dim=-1),
    ], dim=-2)
    return d_mu.to(mu.dtype), d_lam.to(lam.dtype), d_app.to(app.dtype)


class _RenderAssemble(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, lam, app, h, w, kernel):
        if app.device.type == "cpu":
            out = render_assemble_plain(mu, lam, app, h, w, kernel)
        else:
            out = _launch(mu, lam, app, h, w, kernel)
        ctx.save_for_backward(mu, lam, app)
        ctx.shape = (h, w, kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        mu, lam, app = ctx.saved_tensors
        return (*render_assemble_backward(mu, lam, app, *ctx.shape, g), None, None, None)


def render_assemble(mu: torch.Tensor, lam: torch.Tensor, app: torch.Tensor,
                    h: int, w: int, kernel: str = "gauss") -> torch.Tensor:
    """mu [B, K, 2] f32, lam [B, K, 2, 2] f32 (precision Σ⁻¹), app [B, K, C]
    f32 or bf16 → [B, h, w, C] f32. Differentiable in mu, lam and app."""
    _check(mu, lam, app, h, w, kernel)
    if app.device.type not in ("cpu", "cuda"):
        raise ValueError(f"render_assemble runs on CPU or CUDA, got {app.device}")
    return _RenderAssemble.apply(mu, lam, app, h, w, kernel)

