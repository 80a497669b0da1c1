"""A convolution's epilogue: its bias, with the ReLU or the residual sum that
follows it, forward and backward.

Replaces no Pallas kernel: the JAX package's convolutions add their bias
inside XLA's fusions. On the card ``F.conv2d(x, w, b)`` ran cuDNN's product
and then aten's broadcast add of the bias over the channels_last output
(an unvectorised pass at about 40 % of the card's bandwidth), and the ReLU
before the next convolution, the residual sum and, in training, the bias
gradient's bf16 reduction were passes of their own. ``models/blocks.py``'s
``Conv2d`` now runs its product without the bias and hands the output z
to this op, which in one vectorised channels_last pass writes one of

- ``bias``: ``round(z + round(b))``;
- ``relu``: ``relu(round(z + round(b)))``, where the output feeds only a ReLU;
- ``residual``: ``round(x + round(z + round(b)))``, the residual sum;
- ``skip``: ``round(round(zs + round(bs)) + round(z + round(b)))``, the
  residual sum with a 1×1 skip convolution's bias-free output zs.

round() is to z's dtype and b, bs are the f32 parameters: these are the
rounding steps of the chain it replaces, so on the card its output equals
that chain's bit for bit (``csrc/bias_act.cu``). Its backward writes the
ReLU's masked cotangent (``relu``; the other variants pass the cotangent on
unchanged and write nothing) and sums the bias gradient per channel in f32
in the same pass.

The op is ``partseg::bias_act``, defined like ``partseg::group_norm`` (a
``"FRAGMENT"`` library of the same namespace): its CUDA implementation
launches the kernel or raises; its CPU implementation is the plain version
(``bias_act_plain``); its fake implementation gives the shapes for
``torch.export``. Its gradient (``register_autograd``) launches the backward
kernel on the card and, on the CPU, is what autograd through the plain
version gives (the bias gradient summed in z's dtype). ``bias_act``, the
function the model calls, takes the op on the CPU and wherever PyTorch
traces (``torch.export``), and calls the same implementation and backward
directly for an eager tensor on the card, which spares the dispatcher's
round trips through Python on every convolution. The backward is one
launch: its last CTA sums the CTAs' partial rows of the bias gradient, in a
workspace kept per stream. Launches count in
``kernel.bias_act.launches`` and ``kernel.bias_act.backward_launches``
(``tracing``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from partseg_tpu_torch import tracing
from partseg_tpu_torch.partops.kernels import _build

MAX_THREADS = 512          # kMaxThreads in csrc/bias_act.cu
MAX_CHANNELS = MAX_THREADS  # a channel period of vectors fits in a CTA
TARGET_THREADS = 256       # a CTA's threads, where C allows
BATCH = 4                  # kBatch: vectors of each input in flight a thread
SMS = 132                  # the H100's streaming multiprocessors
CTAS_PER_SM = 2            # the grid's CTAs at most, per SM (a sweep of 2–32)

BIAS, RELU, RESIDUAL, SKIP = 0, 1, 2, 3    # the variants, as the kernel numbers them


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels walk an n-element tensor: ``vec`` elements a load,
    ``threads`` a CTA, ``ctas`` CTAs."""

    vec: int
    threads: int
    ctas: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, c: int, elem: int, aligned: bool) -> Plan:
    """The launch plan for ``n`` elements of ``elem`` bytes whose channel (the
    innermost axis of channels_last storage) has ``c`` values; ``aligned``:
    every pointer is 16-byte aligned. The thread count is a multiple of the
    vectors in a channel period, so each thread's lanes stay on fixed
    channels; the grid has enough CTAs for every thread to keep ``BATCH``
    vectors in flight, up to ``CTAS_PER_SM`` a SM, and strides over the rest.
    Cached, since a model calls it with a few shapes."""
    wide = 16 // elem
    vec = wide if aligned and n % wide == 0 else 1
    period = math.lcm(c, vec) // vec          # vectors before the channels repeat
    threads = math.lcm(period, 32)
    if threads > MAX_THREADS:
        threads = period * (MAX_THREADS // period)
    while 2 * threads <= TARGET_THREADS:
        threads *= 2
    ctas = max(1, min(_ceil_div(n // vec, threads * BATCH), CTAS_PER_SM * SMS))
    return Plan(vec, threads, ctas)


def _bias(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return b.to(dtype)[:, None, None]


def bias_act_plain(z: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
                   skip: torch.Tensor | None = None, skip_bias: torch.Tensor | None = None,
                   relu: bool = False) -> torch.Tensor:
    """The plain version: the chain the blocks ran before the op, on z's
    dtype (the bias cast to it, added, then the ReLU or the residual sum)."""
    y = z + _bias(bias, z.dtype)
    if relu:
        return F.relu(y)
    if skip is not None:
        residual = skip + _bias(skip_bias, z.dtype)
    return y if residual is None else residual + y


def _variant(residual, skip, relu: bool) -> int:
    if relu:
        return RELU
    if skip is not None:
        return SKIP
    return BIAS if residual is None else RESIDUAL


def _check(z, bias, residual, skip, skip_bias, relu: bool) -> None:
    """Validate what the kernel takes (every path calls it, once a
    convolution on the card: kept to a few attribute reads)."""
    dt = z.dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise TypeError(f"bias_act takes float32 or bfloat16 z, got {dt}")
    shape = z.shape
    if len(shape) != 4 or shape[1] > MAX_CHANNELS or z.numel() == 0:
        raise ValueError(f"bias_act takes non-empty [B, C, H, W] z with C <= {MAX_CHANNELS}, "
                         f"got {tuple(shape)}")
    device = z.device
    for name, p in (("bias", bias), ("skip_bias", skip_bias)):
        if p is not None and (p.dtype is not torch.float32 or p.shape != shape[1:2]
                              or p.device != device or not p.is_contiguous()):
            raise ValueError(f"bias_act takes a contiguous float32 [{shape[1]}] {name} on z's "
                             f"device; got {p.dtype} {tuple(p.shape)} on {p.device}")
    for name, t in (("residual", residual), ("skip", skip)):
        if t is not None and (t.shape != shape or t.dtype is not dt or t.device != device):
            raise ValueError(f"bias_act takes a {name} of z's shape, dtype and device; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (skip is None) != (skip_bias is None) or (residual is not None and skip is not None) or (
            relu and (residual is not None or skip is not None)):
        raise ValueError("bias_act takes one of: relu, a residual, or a skip output with its "
                         "bias, or none of them")


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_LIB = torch.library.Library("partseg", "FRAGMENT")     # lives as long as the module
_LIB.define("bias_act(Tensor z, Tensor bias, Tensor? residual, Tensor? skip, Tensor? skip_bias, "
            "bool relu) -> Tensor")


def _bias_act_cuda(z, bias, residual, skip, skip_bias, relu):
    """The kernel: the epilogue's output, channels_last in z's dtype."""
    _check(z, bias, residual, skip, skip_bias, relu)
    z = _channels_last(z)
    other = residual if skip is None else skip
    out = torch.empty_like(z, memory_format=torch.channels_last)
    z_ptr, out_ptr = z.data_ptr(), out.data_ptr()
    other_ptr = None if other is None else _channels_last(other).data_ptr()
    bf16 = z.dtype is torch.bfloat16
    n, c = z.numel(), z.shape[1]
    p = launch_plan(n, c, 2 if bf16 else 4, (z_ptr | out_ptr | (other_ptr or 0)) % 16 == 0)
    _build.launch("partseg_bias_act_fwd", z.device, z_ptr, bias.data_ptr(), other_ptr,
                  None if skip_bias is None else skip_bias.data_ptr(), out_ptr, int(bf16),
                  p.vec, _variant(residual, skip, relu), n, c, p.threads, p.ctas)
    tracing.count("kernel.bias_act.launches")
    return out


def _bias_act_cpu(z, bias, residual, skip, skip_bias, relu):
    """The plain version, on the inputs the kernel would take."""
    _check(z, bias, residual, skip, skip_bias, relu)
    return bias_act_plain(z, bias, residual, skip, skip_bias, relu)


_LIB.impl("bias_act", _bias_act_cuda, "CUDA")
_LIB.impl("bias_act", _bias_act_cpu, "CPU")


@torch.library.register_fake("partseg::bias_act", lib=_LIB)
def _bias_act_fake(z, bias, residual, skip, skip_bias, relu):
    # The CUDA output is channels_last, the CPU's z's layout.
    return torch.empty_like(z, memory_format=torch.channels_last if z.is_cuda
                            else torch.preserve_format)


# Per (device, stream): the backward's [CTAs, C] workspace and its counter,
# which each launch leaves at 0; launches on one stream never overlap.
_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, size: int):
    """(workspace pointer, counter pointer) for ``size`` floats on ``stream``."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < size:
        part = torch.empty(max(size, CTAS_PER_SM * SMS * MAX_CHANNELS), device=device,
                           dtype=torch.float32)
        done = torch.zeros(1, device=device, dtype=torch.int32) if ws is None else ws[1]
        ws = _WORKSPACES[key] = (part, done, part.data_ptr(), done.data_ptr())
    return ws[2:]


def bias_act_backward(g: torch.Tensor, r: torch.Tensor | None, want_bias: bool):
    """The backward kernel: (g_z, d_b f32 or None) from the output's
    cotangent g and, for the relu variant, the forward's output r (None for
    the others, whose g_z is g itself). One launch: the kernel sums d_b."""
    if r is None and not want_bias:
        return g, None
    g = _channels_last(g)
    n, c = g.numel(), g.shape[1]
    g_z = g if r is None else torch.empty_like(g, memory_format=torch.channels_last)
    p = launch_plan(n, c, g.element_size(),
                    _aligned(g) if r is None else _aligned(g, r, g_z))
    d_b, part = None, (None, None)
    stream = _build.stream_handle(g.device)
    if want_bias:
        d_b = torch.empty(c, device=g.device, dtype=torch.float32)
        part = _workspace(g.device, stream, p.ctas * c)
    _build.launch("partseg_bias_act_bwd", g.device, g.data_ptr(),
                  None if r is None else r.data_ptr(), None if r is None else g_z.data_ptr(),
                  part[0], None if d_b is None else d_b.data_ptr(), part[1],
                  int(g.dtype == torch.bfloat16), p.vec, int(r is not None), n, c, p.threads,
                  p.ctas, stream=stream)
    tracing.count("kernel.bias_act.backward_launches")
    return g_z, d_b


def bias_act_vjp(g: torch.Tensor, r: torch.Tensor | None, want_bias: bool):
    """(g_z, d_b or None) as autograd through the plain version gives them:
    the ReLU's ``threshold_backward`` on its output, the bias gradient summed
    over the batch and pixels in g's dtype, then cast to f32."""
    g_z = g if r is None else torch.ops.aten.threshold_backward(g, r, 0)
    return g_z, g_z.sum((0, 2, 3)).float() if want_bias else None


def _setup_context(ctx, inputs, output):
    _, _, residual, skip, _, relu = inputs
    ctx.set_materialize_grads(False)
    ctx.given = (residual is not None, skip is not None)
    if relu:
        ctx.save_for_backward(output)


def _backward(ctx, g):
    if g is None:
        return (None,) * 6
    saved = ctx.saved_tensors      # read once: remat's recomputation unpacks each once
    r = saved[0] if saved else None
    need = ctx.needs_input_grad
    want_bias = need[1] or need[4]
    g_z, d_b = (bias_act_backward if g.is_cuda else bias_act_vjp)(g, r, want_bias)
    has_residual, has_skip = ctx.given
    return (g_z, d_b, g if has_residual else None, g if has_skip else None,
            None if d_b is None or not has_skip else d_b.clone(), None)


torch.library.register_autograd("partseg::bias_act", _backward,
                                setup_context=_setup_context, lib=_LIB)


class _BiasActCuda(torch.autograd.Function):
    """The op's CUDA implementation and gradient, called without the
    dispatcher (``bias_act``'s path for an eager tensor on the card)."""

    @staticmethod
    def forward(ctx, z, bias, residual, skip, skip_bias, relu):
        out = _bias_act_cuda(z, bias, residual, skip, skip_bias, relu)
        _setup_context(ctx, (z, bias, residual, skip, skip_bias, relu), out)
        return out

    backward = staticmethod(_backward)


# Function.apply's Python wrapper (its default-argument binding and
# functorch's checks) cost about 100 µs of the H100 host's time a call, more
# than the epilogue saves; with no functorch transform active it only hands
# over to this C implementation, which ``bias_act`` calls itself.
_apply = super(torch.autograd.Function, _BiasActCuda).apply


def bias_act(z: torch.Tensor, bias: torch.Tensor, *, relu: bool = False,
             residual: torch.Tensor | None = None, skip: torch.Tensor | None = None,
             skip_bias: torch.Tensor | None = None) -> torch.Tensor:
    """A convolution's bias-free output z [B, C, H, W] (channels_last on the
    card; another layout is copied to it) in f32 or bf16, and its f32 bias
    [C] → z + bias in z's dtype, then ``relu``, or the sum with
    ``residual`` (z's shape and dtype), or with a skip convolution's
    bias-free output ``skip`` and its bias ``skip_bias``. Differentiable in
    every tensor. Calls ``torch.ops.partseg.bias_act``, or for an eager
    tensor on the card its implementation and gradient directly."""
    if (z.is_cuda and type(z) is torch.Tensor and not torch.compiler.is_compiling()
            and not torch._C._are_functorch_transforms_active()):
        if torch.is_grad_enabled():
            return _apply(z, bias, residual, skip, skip_bias, relu)
        return _bias_act_cuda(z, bias, residual, skip, skip_bias, relu)
    return torch.ops.partseg.bias_act(z, bias, residual, skip, skip_bias, relu)
