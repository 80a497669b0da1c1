"""Border-clamped bilinear sampling at arbitrary coordinates.

Replaces the Pallas TPU kernel ``bilinear_sample_fused`` of
``partseg_tpu/partops/pallas/bilinear_warp.py`` (``_run_kernel``,
``_kernel`` / ``_interp_body``). ``bilinear_sample_fused`` is an autograd
Function, as the JAX ``custom_vjp`` is:

- its forward launches ``csrc/bilinear_sample.cu`` on a CUDA tensor (or
  raises) and runs the plain version (the gather path of
  ``partops/warp.py``) on a CPU tensor;
- under grad the forward runs the grads variant, which also writes the
  tap differences ∂out/∂fy and ∂out/∂fx ([B, N, C] f32 each);
- the backward (``bilinear_sample_vjp``, the same code on both devices)
  contracts those with the cotangent for d_coords and scatter-adds the
  4 taps for d_image with ``index_add_``. On the card that sums with
  atomics in no fixed order, so d_image varies in its last bits from run
  to run.
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.warp import axis_taps, gather_sample, pixel_index

MAX_BATCH = 65535        # gridDim.y


def _gather_taps(image: torch.Tensor, coords: torch.Tensor):
    """f32 taps (v00, v01, v10, v11) [B, N, C] and weights wy, wx [B, N, 1]."""
    b, h, w, c = image.shape
    fy, fx = pixel_index(coords, h, w)
    y0, y1, wy = axis_taps(fy, h)
    x0, x1, wx = axis_taps(fx, w)
    flat = image.reshape(b, h * w, c).float()

    def take(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1, c))

    return take(y0, x0), take(y0, x1), take(y1, x0), take(y1, x1), wy[..., None], wx[..., None]


def bilinear_sample_plain(image: torch.Tensor, coords: torch.Tensor, with_grads: bool = False):
    """The plain PyTorch version. Primal: the gather path, [B, N, C] in the
    image dtype. with_grads: (out, d_fy, d_fx), [B, N, C] f32 each."""
    if not with_grads:
        return gather_sample(image, coords)
    v00, v01, v10, v11, wy, wx = _gather_taps(image, coords)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    dx0 = v01 - v00
    return top + (bot - top) * wy, bot - top, dx0 + ((v11 - v10) - dx0) * wy


def _check(image: torch.Tensor, coords: torch.Tensor) -> None:
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bilinear_sample takes a float32 or bfloat16 image, got {image.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"bilinear_sample takes float32 coords, got {coords.dtype}")
    if image.dim() != 4 or image.numel() == 0:
        raise ValueError(f"bilinear_sample takes a non-empty [B, H, W, C] image, "
                         f"got {tuple(image.shape)}")
    b = image.shape[0]
    if coords.dim() != 3 or coords.shape[0] != b or coords.shape[2] != 2 or coords.shape[1] == 0:
        raise ValueError(f"bilinear_sample takes [B, N, 2] coords for B = {b}, "
                         f"got {tuple(coords.shape)}")
    if not (image.is_contiguous() and coords.is_contiguous()):
        raise ValueError("bilinear_sample takes a contiguous image and contiguous coords")
    if image.device != coords.device:
        raise ValueError("bilinear_sample inputs lie on different devices")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilinear_sample runs on CPU or CUDA, got {image.device}")
    if b > MAX_BATCH:
        raise ValueError(f"bilinear_sample takes at most {MAX_BATCH} images, got {b}")


def _launch(image: torch.Tensor, coords: torch.Tensor, with_grads: bool):
    b, h, w, c = image.shape
    n = coords.shape[1]
    dev = image.device
    if with_grads:
        out, d_fy, d_fx = (torch.empty((b, n, c), device=dev, dtype=torch.float32)
                           for _ in range(3))
    else:
        out = torch.empty((b, n, c), device=dev, dtype=image.dtype)
    if coords.data_ptr() % 8:
        raise ValueError("bilinear_sample reads (y, x) pairs as 8-byte words: coords must "
                         "start 8-byte aligned")
    _build.launch("partseg_bilinear_sample", dev,
                  image.data_ptr(), int(image.dtype == torch.bfloat16), coords.data_ptr(),
                  out.data_ptr(), d_fy.data_ptr() if with_grads else None,
                  d_fx.data_ptr() if with_grads else None, b, h, w, c, n, int(with_grads))
    bilinear_sample_fused.launches += 1
    return (out, d_fy, d_fx) if with_grads else out


def sample_with_grads(image: torch.Tensor, coords: torch.Tensor):
    """The grads variant on either device: (out, d_fy, d_fx), f32."""
    _check(image, coords)
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, coords, with_grads=True)
    return _launch(image, coords, with_grads=True)


def bilinear_sample_vjp(image_shape, image_dtype, coords, d_fy, d_fx, g,
                        need_image: bool = True, need_coords: bool = True):
    """(d_image [B, H, W, C] in ``image_dtype``, d_coords [B, N, 2]) from the
    saved tap differences and the cotangent g [B, N, C]; None where not needed."""
    b, h, w, c = image_shape
    gf = g.float()
    d_coords = d_image = None
    if need_coords:
        gy = (gf * d_fy).sum(-1) * (0.5 * h)
        gx = (gf * d_fx).sum(-1) * (0.5 * w)
        d_coords = torch.stack([gy, gx], dim=-1).to(coords.dtype)
    if need_image:
        fy, fx = pixel_index(coords, h, w)
        y0, y1, wy = axis_taps(fy, h)
        x0, x1, wx = axis_taps(fx, w)
        wy, wx = wy[..., None], wx[..., None]
        flat = torch.zeros((b * h * w, c), device=gf.device, dtype=torch.float32)
        base = (torch.arange(b, device=gf.device) * (h * w))[:, None]
        for yi, xi, wgt in ((y0, x0, (1 - wy) * (1 - wx)), (y0, x1, (1 - wy) * wx),
                            (y1, x0, wy * (1 - wx)), (y1, x1, wy * wx)):
            flat.index_add_(0, (base + yi * w + xi).reshape(-1), (gf * wgt).reshape(-1, c))
        d_image = flat.reshape(b, h, w, c).to(image_dtype)
    return d_image, d_coords


class _BilinearSample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, coords, with_grads):
        if not with_grads:
            if image.device.type == "cpu":
                return bilinear_sample_plain(image, coords)
            return _launch(image, coords, with_grads=False)
        out, d_fy, d_fx = sample_with_grads(image, coords)
        ctx.save_for_backward(coords, d_fy, d_fx)
        ctx.image = (tuple(image.shape), image.dtype)
        return out.to(image.dtype)

    @staticmethod
    def backward(ctx, g):
        coords, d_fy, d_fx = ctx.saved_tensors
        d_image, d_coords = bilinear_sample_vjp(*ctx.image, coords, d_fy, d_fx, g,
                                                *ctx.needs_input_grad[:2])
        return d_image, d_coords, None


def bilinear_sample_fused(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """image [B, H, W, C] f32 or bf16, coords [B, N, 2] f32 (y, x in
    [-1, 1]) → [B, N, C] in the image dtype, border padding.
    Differentiable in the image and the coords."""
    _check(image, coords)
    with_grads = torch.is_grad_enabled() and (image.requires_grad or coords.requires_grad)
    return _BilinearSample.apply(image, coords, with_grads)


bilinear_sample_fused.launches = 0
