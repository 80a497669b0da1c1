"""GroupNorm with a ReLU twin output, forward and backward.

Replaces no Pallas kernel: the JAX package's GroupNorm is Flax's, which XLA
fuses with the ReLU after it. On the card the port called
``F.group_norm(x.float(), ...).to(x.dtype)`` and a ReLU, which for a bf16
channels_last activation made an f32 copy, permuted it to NCHW, read it
twice, cast the output back and read it again for the ReLU. The CUDA kernel
(``csrc/group_norm.cu``) reads x once in its channels_last layout and
writes ``y = γ·x̂ + β`` (rounded once to x's dtype) and/or ``r = relu(y)``;
its backward kernel takes the cotangents of either or both and writes dx.

The op is ``partseg::group_norm``, defined like ``partseg::softmax_moments``
(``torch.library.Library``; see that module for why not ``custom_op``): its
CUDA implementation launches the kernel or raises; its CPU implementation
is the plain version, ``F.group_norm`` in f32 rounded once to x's dtype and
``relu`` of that, bit for bit what ``models/blocks.py`` computed before the
op; its fake implementation gives the shapes for ``torch.export``. It
returns (y, r, mean, rstd): an output not asked for is an empty tensor, and
mean and rstd [B, G] f32 are what the backward needs beside x. Its gradient
(``register_autograd``) launches the backward kernel on the card and, on
the CPU, differentiates the plain version, so CPU gradients equal those of
the code it replaced. Launches count in ``kernel.group_norm.launches`` and
``kernel.group_norm.backward_launches`` (``tracing``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from partseg_tpu_torch import tracing
from partseg_tpu_torch.partops.kernels import _build

MAX_GROUPS = 64            # kMaxGroups in csrc/group_norm.cu
MAX_THREADS = 512          # kMaxThreads
MAX_CLUSTER = 16           # kMaxCluster: a non-portable cluster, within one GPC
MAX_CHANNELS = MAX_THREADS  # a thread per channel at least, where C is odd
TARGET_CTAS = 264          # two CTAs on each of the H100's 132 SMs
# Dynamic shared memory a CTA takes at most: two CTAs to an SM (228 KB).
SMEM_BUDGET = 110 * 1024
TARGET_THREADS = 256       # a CTA's threads, where C allows (a sweep of 128–512)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernels cut a [B, H, W, C] tensor: ``vec`` elements a load,
    ``threads`` a CTA, ``cs`` CTAs (a cluster) a sample, ``run`` pixels a
    CTA, ``n_stage`` vectors of each CTA's slice kept in shared memory."""

    vec: int
    threads: int
    cs: int
    run: int
    n_stage: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, c: int, hw: int, elem: int, aligned: bool, staged: int) -> Plan:
    """The launch plan for ``b`` samples of ``hw`` pixels × ``c`` channels of
    ``elem``-byte elements; ``aligned``: every pointer is 16-byte aligned;
    ``staged``: the tensors a CTA keeps in shared memory (x; and in the
    backward the summed cotangent). Everything in it follows from the
    shape, so the kernel sees 16-byte loads wherever the sample's bytes and
    the pointers allow; cached, since a model calls it with a few shapes."""
    wide = 16 // elem
    vec = wide if aligned and (hw * c) % wide == 0 else 1
    period = math.lcm(c, vec) // vec          # vectors before the channels repeat
    threads = math.lcm(period, 32)
    if threads > MAX_THREADS:
        threads = period * (MAX_THREADS // period)
    while 2 * threads <= TARGET_THREADS:
        threads *= 2
    quantum = vec // math.gcd(c, vec)         # pixels whose elements fill whole vectors

    def run_for(cs: int) -> int:
        return _ceil_div(_ceil_div(hw, cs), quantum) * quantum

    partials = 4 * (2 * threads * vec + 2 * c)
    budget = SMEM_BUDGET - partials

    def stage_fits(cs: int) -> bool:
        return staged * run_for(cs) * c * elem <= budget

    cs = 1
    while cs < MAX_CLUSTER:
        if b * cs >= TARGET_CTAS and stage_fits(cs):
            break
        nxt, run = 2 * cs, run_for(2 * cs)
        if (nxt - 1) * run >= hw or run * c // vec < threads:   # an empty or a thin CTA
            break
        cs = nxt
    run = run_for(cs)
    # The whole slice, or whole rounds of the CTA's threads (so that each
    # thread's staged and unstaged vectors sit on the same channels).
    n_stage = run * c // vec
    if not stage_fits(cs):
        n_stage = max(budget, 0) // (staged * vec * elem) // threads * threads
    return Plan(vec, threads, cs, run, n_stage)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float):
    """The plain version: (y, relu(y)) with y = F.group_norm in f32 rounded
    once to x's dtype (the Flax twin's f32 statistics)."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype)
    return y, F.relu(y)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
           write_y: bool, write_relu: bool) -> None:
    """Validate what the kernel takes (both implementations call it)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"group_norm takes non-empty [B, C, H, W] x, got {tuple(x.shape)}")
    c = x.shape[1]
    if not 0 < groups <= MAX_GROUPS or c % groups or c > MAX_CHANNELS:
        raise ValueError(f"group_norm takes C <= {MAX_CHANNELS} channels in 1 to "
                         f"{MAX_GROUPS} groups that divide them; got C = {c}, {groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or tuple(p.shape) != (c,) or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(f"group_norm takes a contiguous float32 [{c}] {name} on x's "
                             f"device; got {p.dtype} {tuple(p.shape)} on {p.device}")
    if not (write_y or write_relu):
        raise ValueError("group_norm writes y, relu(y) or both")


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _empty_like_cl(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.channels_last)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_LIB = torch.library.Library("partseg", "FRAGMENT")     # lives as long as the module
_LIB.define("group_norm(Tensor x, Tensor weight, Tensor bias, int groups, float eps, "
            "bool write_y, bool write_relu) -> (Tensor, Tensor, Tensor, Tensor)")


def _group_norm_cuda(x, weight, bias, groups, eps, write_y, write_relu):
    """The kernel: (y or empty, r or empty, mean, rstd)."""
    _check(x, weight, bias, groups, write_y, write_relu)
    x = _channels_last(x)
    b, c, h, w = x.shape
    y = _empty_like_cl(x) if write_y else x.new_empty((0,))
    r = _empty_like_cl(x) if write_relu else x.new_empty((0,))
    mean = torch.empty((b, groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    p = launch_plan(b, c, h * w, x.element_size(), _aligned(x, y, r), 1)
    _build.launch("partseg_group_norm_fwd", x.device, x.data_ptr(), weight.data_ptr(),
                  bias.data_ptr(), y.data_ptr() if write_y else None,
                  r.data_ptr() if write_relu else None, mean.data_ptr(), rstd.data_ptr(),
                  int(x.dtype == torch.bfloat16), p.vec, b, c, h * w, groups, float(eps),
                  p.threads, p.cs, p.run, p.n_stage)
    tracing.count("kernel.group_norm.launches")
    return y, r, mean, rstd


def _group_norm_cpu(x, weight, bias, groups, eps, write_y, write_relu):
    """The plain version, on the inputs the kernel would take."""
    _check(x, weight, bias, groups, write_y, write_relu)
    y, r = group_norm_plain(x, weight, bias, groups, eps)
    var, mean = torch.var_mean(x.float().reshape(x.shape[0], groups, -1), dim=-1, correction=0)
    empty = x.new_empty((0,))
    return (y if write_y else empty, r if write_relu else empty, mean, torch.rsqrt(var + eps))


_LIB.impl("group_norm", _group_norm_cuda, "CUDA")
_LIB.impl("group_norm", _group_norm_cpu, "CPU")


@torch.library.register_fake("partseg::group_norm", lib=_LIB)
def _group_norm_fake(x, weight, bias, groups, eps, write_y, write_relu):
    def out(written: bool):   # the CUDA outputs are channels_last, the CPU's x's layout
        if not written:
            return x.new_empty((0,))
        return torch.empty_like(x, memory_format=torch.channels_last if x.is_cuda
                                else torch.preserve_format)

    stats = x.new_empty((x.shape[0], groups), dtype=torch.float32)
    return out(write_y), out(write_relu), stats, torch.empty_like(stats)


def group_norm_vjp(x, weight, bias, groups, eps, g_y, g_r):
    """(dx, dγ, dβ) of the plain version under the cotangents of y and r
    (either may be None): autograd through ``group_norm_plain``, which sums
    the two branches at y in x's dtype."""
    with torch.enable_grad():
        xs, ws, bs = (t.detach().requires_grad_() for t in (x, weight, bias))
        y, r = group_norm_plain(xs, ws, bs, groups, eps)
        pairs = [(o, g) for o, g in ((y, g_y), (r, g_r)) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs], (xs, ws, bs), [g for _, g in pairs])


def group_norm_backward(x, weight, bias, mean, rstd, g_y, g_r):
    """The backward kernel: (dx channels_last in x's dtype, dγ, dβ f32) from
    the forward's x, mean and rstd and the cotangents of y and r (either may
    be None)."""
    x = _channels_last(x)
    b, c, h, w = x.shape
    groups = mean.shape[1]
    g_y = None if g_y is None else _channels_last(g_y.to(x.dtype))
    g_r = None if g_r is None else _channels_last(g_r.to(x.dtype))
    dx = _empty_like_cl(x)
    given = [g for g in (g_y, g_r) if g is not None]
    p = launch_plan(b, c, h * w, x.element_size(), _aligned(x, dx, *given), 2)
    part = torch.empty((b * p.cs, 2, c), device=x.device, dtype=torch.float32)
    _build.launch("partseg_group_norm_bwd", x.device, x.data_ptr(),
                  None if g_y is None else g_y.data_ptr(), None if g_r is None else g_r.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                  part.data_ptr(), int(x.dtype == torch.bfloat16), p.vec, b, c, h * w, groups,
                  p.threads, p.cs, p.run, p.n_stage)
    tracing.count("kernel.group_norm.backward_launches")
    d_bias, d_weight = part.sum(0)
    return dx, d_weight, d_bias


def _setup_context(ctx, inputs, output):
    x, weight, bias, groups, eps, _, _ = inputs
    _, _, mean, rstd = output
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, weight, bias, mean, rstd)
    ctx.groups, ctx.eps = groups, eps


def _backward(ctx, g_y, g_r, _g_mean, _g_rstd):
    x, weight, bias, mean, rstd = ctx.saved_tensors
    if g_y is None and g_r is None:
        return (None,) * 7
    if x.is_cuda:
        grads = group_norm_backward(x, weight, bias, mean, rstd, g_y, g_r)
    else:
        grads = group_norm_vjp(x, weight, bias, ctx.groups, ctx.eps, g_y, g_r)
    return (*grads, None, None, None, None)


torch.library.register_autograd("partseg::group_norm", _backward,
                                setup_context=_setup_context, lib=_LIB)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, *, y: bool = True, relu: bool = False):
    """x [B, C, H, W] (stored channels_last on the card; another layout is
    copied to it) in f32 or bf16 → (y, r) in x's dtype and channels_last,
    y = GroupNorm(x) with f32 statistics rounded once, r = relu(y); each is
    None unless asked for (``y``, ``relu``). Differentiable in x, weight and
    bias through either output. Calls ``torch.ops.partseg.group_norm``."""
    out_y, out_r, _, _ = torch.ops.partseg.group_norm(x, weight, bias, groups, eps, y, relu)
    return (out_y if y else None), (out_r if relu else None)
