"""Fused per-part spatial softmax + soft-argmax moments.

Replaces the Pallas TPU kernel ``partseg_tpu/partops/pallas/softmax_moments.py``
(``softmax_moments``). The CUDA kernel (``csrc/softmax_moments.cu``) reads
the f32 logits from device memory once (a thread block cluster per image)
and writes the part distributions and the raw moments (E[y], E[x], E[y²],
E[yx], E[x²]) per (b, k); μ and Σ are formed here with the same raw-moment
formula as ``moments_from_raw``.

The forward is the registered op ``partseg::softmax_moments``, so eager
calls and ``torch.export`` take one path: an exported program holds the
op, not its plain version, and running it launches the kernel. Its CUDA
implementation launches the kernel (or raises); its CPU implementation is
the plain version (``spatial_softmax`` + ``soft_argmax_moments``); its
fake implementation gives the output shapes for a symbolic batch. The CUDA
and CPU implementations both reject logits the kernel does not take. The op
is defined with ``torch.library.Library`` rather than the
``torch.library.custom_op`` decorator, which wraps each implementation in
``torch._dynamo.disable`` and so imports ``torch._dynamo`` at a process's
first call (2.4 s on a CPU host); this definition adds about 50 ms to the
module's import on the H100's host instead. The logits go to the op as
they are, the strided foreground slice of [B, H, W, K+1] included: the
kernel reads the pixel stride ``ld`` from the strides, in eager and
exported runs alike, so no copy is made. Its gradient, attached with
``register_autograd``, is the closed form of the JAX ``custom_vjp``
(``_bwd``) in plain PyTorch, the same code on both devices: the TPU
package has no backward kernel either (its backward is jnp, which XLA
fuses).
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.partops.coords import moment_basis
from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.moments import moments_from_raw, soft_argmax_moments
from partseg_tpu_torch.partops.softmax import spatial_softmax

MAX_PARTS = 64           # kMaxParts in csrc/softmax_moments.cu


def softmax_moments_plain(logits: torch.Tensor):
    """The plain PyTorch version: (parts, mu, sigma), all f32."""
    parts = spatial_softmax(logits)
    mu, sigma = soft_argmax_moments(parts)
    return parts, mu, sigma


def _check(logits: torch.Tensor) -> int:
    """Validate what the kernel takes; return the pixel stride ``ld``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"softmax_moments takes float32 logits, got {logits.dtype}")
    if logits.dim() != 4 or logits.numel() == 0:
        raise ValueError(
            f"softmax_moments takes non-empty [B, H, W, K] logits, got {tuple(logits.shape)}"
        )
    b, h, w, k = logits.shape
    if k > MAX_PARTS:
        raise ValueError(f"softmax_moments takes at most {MAX_PARTS} parts, got {k}")
    ld = logits.stride(2)
    # Pixels may be strided (the foreground slice of [B, H, W, K+1] logits),
    # but the K parts of a pixel are adjacent and pixels are evenly spaced.
    if logits.stride(3) != 1 or ld < k or logits.stride(1) != w * ld or (
        b > 1 and logits.stride(0) != h * w * ld
    ):
        raise ValueError(
            "softmax_moments takes logits laid out as [B, H, W, ld] with the parts "
            f"first in each pixel; got shape {tuple(logits.shape)}, strides {logits.stride()}"
        )
    return ld


_LIB = torch.library.Library("partseg", "DEF")     # lives as long as the module
_LIB.define("softmax_moments(Tensor logits) -> (Tensor, Tensor, Tensor)")


def _softmax_moments_cuda(logits: torch.Tensor):
    """The kernel: (parts, mu, sigma) of logits laid out as ``_check`` says."""
    ld = _check(logits)
    b, h, w, k = logits.shape
    parts = torch.empty((b, h, w, k), device=logits.device, dtype=torch.float32)
    raw = torch.empty((b, k, 5), device=logits.device, dtype=torch.float32)
    _build.launch("partseg_softmax_moments_f32", logits.device,
                  logits.data_ptr(), parts.data_ptr(), raw.data_ptr(), b, h, w, k, ld)
    softmax_moments.launches += 1
    return (parts, *moments_from_raw(raw))


def _softmax_moments_cpu(logits: torch.Tensor):
    """The plain version, on the logits the kernel would take."""
    _check(logits)
    return softmax_moments_plain(logits)


_LIB.impl("softmax_moments", _softmax_moments_cuda, "CUDA")
_LIB.impl("softmax_moments", _softmax_moments_cpu, "CPU")


@torch.library.register_fake("partseg::softmax_moments", lib=_LIB)
def _softmax_moments_fake(logits):
    b, h, w, k = logits.shape
    f32 = dict(dtype=torch.float32)
    return (logits.new_empty((b, h, w, k), **f32), logits.new_empty((b, k, 2), **f32),
            logits.new_empty((b, k, 2, 2), **f32))


def softmax_moments_vjp(parts, mu, g_parts, g_mu, g_sigma):
    """Logit cotangent from the outputs' cotangents (the JAX ``_bwd``):
    chain (g_μ, g_Σ) to raw-moment cotangents, add ``basis @ g_raw`` to
    g_parts, then take the softmax VJP over H·W. Any cotangent may be None."""
    b, h, w, k = parts.shape
    pf = parts.reshape(b, h * w, k)
    g_mu = torch.zeros_like(mu) if g_mu is None else g_mu.float()
    g_sigma = mu.new_zeros(mu.shape + (2,)) if g_sigma is None else g_sigma.float()
    ey, ex = mu[..., 0], mu[..., 1]
    g_cyy = g_sigma[..., 0, 0]
    g_cyx = g_sigma[..., 0, 1] + g_sigma[..., 1, 0]
    g_cxx = g_sigma[..., 1, 1]
    # c = E2 − E1·E1ᵀ terms:
    g_ey = g_mu[..., 0] - 2.0 * g_cyy * ey - g_cyx * ex
    g_ex = g_mu[..., 1] - 2.0 * g_cxx * ex - g_cyx * ey
    g_raw = torch.stack([g_ey, g_ex, g_cyy, g_cyx, g_cxx], dim=1)      # [B, 5, K]
    g_p = torch.einsum("nm,bmk->bnk", moment_basis(h, w, device=parts.device), g_raw)
    if g_parts is not None:
        g_p = g_p + g_parts.reshape(b, h * w, k).float()
    # Softmax (over HW) VJP: dL/dx = p · (g − Σ_n p·g).
    inner = torch.sum(pf * g_p, dim=1, keepdim=True)
    return (pf * (g_p - inner)).reshape(b, h, w, k)


def _setup_context(ctx, inputs, output):
    parts, mu, _ = output
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(parts, mu)


def _backward(ctx, g_parts, g_mu, g_sigma):
    parts, mu = ctx.saved_tensors
    return softmax_moments_vjp(parts, mu, g_parts, g_mu, g_sigma)


torch.library.register_autograd("partseg::softmax_moments", _backward,
                                setup_context=_setup_context, lib=_LIB)


def softmax_moments(logits: torch.Tensor):
    """logits [B, H, W, K] f32 → (parts [B, H, W, K] f32, mu [B, K, 2] f32,
    sigma [B, K, 2, 2] f32); the same numbers as spatial_softmax +
    soft_argmax_moments up to the order of the f32 sums. Differentiable
    in the logits (the strided foreground slice too). Calls the op
    ``torch.ops.partseg.softmax_moments``, whose CPU and CUDA
    implementations validate the logits as ``_check`` says."""
    return torch.ops.partseg.softmax_moments(logits)


softmax_moments.launches = 0
