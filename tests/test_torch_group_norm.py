"""The op ``partseg::group_norm`` on the CPU (partops/kernels/group_norm.py):
its CPU implementation and gradient against the code the model ran before
it (``F.group_norm`` in f32 rounded once, then ``relu``), bit for bit; its
fake implementation under a symbolic batch; what it rejects; its launch
plan at every GroupNorm shape of the presets' one-card PartNets; and the
op calls of the model paths, which the card counts as launches
(tests/test_torch_cuda.py). The kernels themselves run only on the card.
"""

import dataclasses
import functools
import importlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from partseg_tpu_torch import configs
from partseg_tpu_torch.augment import keyed_pair_draws
from partseg_tpu_torch.evals import make_infer_fn, transfer_batch
from partseg_tpu_torch.models import blocks
from partseg_tpu_torch.models.blocks import ConvBlock, GroupNorm, ResBlock
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.train import (
    LossConfig,
    TrainConfig,
    build_perceptual,
    create_state,
    make_train_period,
)

torch.set_num_threads(1)

# The module (the package's ``group_norm`` is its function).
gn = importlib.import_module("partseg_tpu_torch.partops.kernels.group_norm")

SMEM_LIMIT = 227 * 1024 - 4 * gn.MAX_GROUPS * 4   # kMaxSmem less the static arrays


def _old_group_norm(m: GroupNorm, x):
    """models/blocks.py's GroupNorm.forward before the op."""
    return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps).to(x.dtype)


def _old_convblock(m: ConvBlock, x):
    if m.norm is not None:
        x = _old_group_norm(m.norm, x)
    return m.conv(F.relu(x))


def _old_resblock(m: ResBlock, x):
    if m.norm is not None:
        x = _old_group_norm(m.norm, x)
    y = x
    for conv in m.convs:
        y = _old_convblock(conv, y)
    if m.skip is not None:
        x = m.skip(x)
    return x + y


def _randomise(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + (1.0 if p.dim() == 1 else 0.0))
    return module


def _input(shape, dtype, channels_last, seed=0):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 1.5 + 0.7
    x = x.to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,groups,hw", [(16, 8, 5), (24, 8, 4), (3, 3, 7), (96, 8, 2)])
def test_group_norm_op_on_cpu_equals_the_code_it_replaced(dtype, channels_last, c, groups, hw):
    """Every output mode, the outputs and the gradients of x, γ and β under
    the cotangents of y, of r and of both, bit for bit."""
    m = _randomise(GroupNorm(groups, c), c)
    x = _input((3, c, hw, hw + 1), dtype, channels_last)
    want_y = _old_group_norm(m, x)
    want_r = F.relu(want_y)
    for keep_y, relu in ((True, False), (False, True), (True, True)):
        y, r = m.with_relu(x, keep_y=keep_y, relu=relu)
        assert (y is None) != keep_y and (r is None) != relu
        assert y is None or (torch.equal(y, want_y) and y.stride() == want_y.stride())
        assert r is None or (torch.equal(r, want_r) and r.stride() == want_r.stride())
    assert torch.equal(m(x), want_y)
    gen = torch.Generator().manual_seed(1)
    g_y, g_r = (torch.randn(x.shape, generator=gen).to(dtype) for _ in range(2))
    for cot_y, cot_r in ((g_y, None), (None, g_r), (g_y, g_r)):
        grads = []
        for new in (True, False):
            xs = x.detach().requires_grad_()
            m.zero_grad()
            if new:
                y, r = m.with_relu(xs)
            else:
                y = _old_group_norm(m, xs)
                r = F.relu(y)
            pairs = [(o, g) for o, g in ((y, cot_y), (r, cot_r)) if g is not None]
            torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
            grads.append((xs.grad, m.weight.grad.clone(), m.bias.grad.clone()))
        for got, want in zip(*grads):
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("norm,cin,features", [("block", 16, 16), ("block", 8, 16),
                                               ("group", 16, 32), ("none", 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocks_on_cpu_equal_their_forward_before_the_op(norm, cin, features, dtype):
    """ResBlock in each norm mode and a ConvBlock with its GroupNorm, output
    and every parameter's and the input's gradient, bit for bit against the
    blocks' forward before the op (the GroupNorm's output, then a ReLU in
    the first ConvBlock)."""
    torch.manual_seed(0)
    for m, old in ((ResBlock(cin, features, norm=norm, dtype=dtype), _old_resblock),
                   (ConvBlock(cin, features, kernel=3, dtype=dtype), _old_convblock)):
        _randomise(m, cin + features)
        x = _input((2, cin, 8, 8), dtype, True, seed=3)
        g = torch.randn((2, features, 8, 8), generator=torch.Generator().manual_seed(4)).to(dtype)
        results = []
        for fn in (m, lambda v: old(m, v)):
            xs = x.detach().requires_grad_()
            m.zero_grad()
            out = fn(xs)
            out.backward(g)
            results.append([out, xs.grad] + [p.grad.clone() for p in m.parameters()])
        for got, want in zip(*results):
            assert torch.equal(got, want)


def test_group_norm_fake_gives_the_shapes_under_a_symbolic_batch():
    """torch.export of a ResBlock with a symbolic batch: the graph holds the
    op with y and r asked for, and its outputs' shapes carry the batch."""
    m = _randomise(ResBlock(16, 24, norm="block", dtype=torch.float32), 0).eval()
    batch = torch.export.Dim("batch", min=1, max=64)
    program = torch.export.export(m, (_input((2, 16, 8, 8), torch.float32, True),),
                                  dynamic_shapes=({0: batch},))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and str(n.target) == "partseg.group_norm.default"]
    assert len(nodes) == 1 and nodes[0].args[5:] == (True, True)
    y, r, mean, rstd = nodes[0].meta["val"]
    assert isinstance(y.shape[0], torch.SymInt)
    assert str(y.shape[0]) == str(r.shape[0]) == str(mean.shape[0]) == str(rstd.shape[0])
    assert tuple(y.shape[1:]) == tuple(r.shape[1:]) == (16, 8, 8)
    assert tuple(mean.shape[1:]) == tuple(rstd.shape[1:]) == (8,)
    x = _input((5, 16, 8, 8), torch.float32, True, seed=2)
    assert torch.equal(program.module()(x), m(x))
    # The ConvBlock asks for r alone: y comes back empty.
    out = torch.ops.partseg.group_norm(x, m.norm.weight, m.norm.bias, 8, 1e-6, False, True)
    assert out[0].numel() == 0 and out[1].shape == x.shape


def test_group_norm_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 16, 4, 4))
    w, b = torch.ones(16), torch.zeros(16)
    with pytest.raises(TypeError):
        gn.group_norm(x.half(), w, b, 8, 1e-6)
    for args in ((x, w, b, 5), (x, w, b, 0), (x[:, :3], w, b, 1), (x, w.double(), b, 8),
                 (x, torch.ones(32)[::2], b, 8),
                 (torch.zeros((2, 520, 1, 1)), torch.ones(520), torch.zeros(520), 8),
                 (torch.zeros((0, 16, 4, 4)), w, b, 8), (x[0], w, b, 8)):
        with pytest.raises(ValueError):
            gn.group_norm(*args, 1e-6)
    with pytest.raises(ValueError):
        gn.group_norm(x, w, b, 8, 1e-6, y=False, relu=False)


@functools.cache
def _preset_norm_shapes():
    """(C, groups, H·W) of every GroupNorm call in the one-card PartNets of
    the ten presets (the spatial preset unsharded), from the encoders and the
    decoder's blocks run on the meta device."""
    shapes = set()
    real = gn.group_norm

    def record(x, weight, bias, groups, eps, **kw):
        shapes.add((x.shape[1], groups, x.shape[2] * x.shape[3]))
        return real(x, weight, bias, groups, eps, **kw)

    for preset in configs.TRAIN_PRESETS.values():
        cfg = dataclasses.replace(preset.model, dtype=torch.float32)
        model = PartNet(cfg, device="meta")
        x = torch.empty((1, cfg.img_size, cfg.img_size, 3), device="meta")
        orig = blocks.group_norm
        blocks.group_norm = record
        try:
            model.encode_shape(x)
            model.encode_appearance(x)
            dec, h = model.decoder, None
            for i in range(dec.n_scales):    # the decoder's loop, its blocks' inputs
                res = dec.out_size // 2 ** (dec.n_scales - 1 - i)
                feat = torch.empty((1, dec.widths[i], res, res), device="meta")
                h = feat if h is None else torch.cat([blocks.upsample2x(h), feat], dim=1)
                h = dec.blocks[2 * i + 1](dec.blocks[2 * i](h))
        finally:
            blocks.group_norm = orig
    return sorted(shapes)


def test_preset_norm_shapes_span_the_issue_range():
    """C from 24 to 384 (C/G from 3 to 48), H·W from 4² to 256², and the
    card tests' list of shapes is this one."""
    from test_torch_cuda import PRESET_NORM_SHAPES

    shapes = _preset_norm_shapes()
    assert [(c, hw) for c, _, hw in shapes] == PRESET_NORM_SHAPES
    assert {g for _, g, _ in shapes} == {8}
    cs = {c for c, _, _ in shapes}
    hws = {hw for _, _, hw in shapes}
    assert min(cs) == 24 and max(cs) == 384
    assert min(hws) == 16 and max(hws) == 256 * 256
    assert {c // g for c, g, _ in shapes} >= {3, 48}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 64, 256])
def test_group_norm_launch_plan_fits_every_preset_shape(batch, elem, aligned):
    """The plan at every preset GroupNorm shape keeps what the kernel's
    launcher checks (csrc/group_norm.cu:valid): whole vectors a CTA and a
    sample, a thread count that puts each lane on fixed channels, every
    pixel in exactly one CTA, none empty, and the shared memory within the
    card's opt-in and the two-CTAs-an-SM budget."""
    for c, groups, hw in _preset_norm_shapes() + [(3, 3, 25), (8, 8, 1), (500, 4, 9)]:
        for staged in (1, 2, 3):
            p = gn.launch_plan(batch, c, hw, elem, aligned, staged)
            assert p.vec in (1, 16 // elem) and (p.vec == 16 // elem) == (
                aligned and (hw * c) % (16 // elem) == 0)
            assert 0 < p.threads <= gn.MAX_THREADS and (p.threads * p.vec) % c == 0
            assert 1 <= p.cs <= gn.MAX_CLUSTER and (p.run * c) % p.vec == 0
            assert (p.cs - 1) * p.run < hw <= p.cs * p.run
            assert 0 <= p.n_stage * p.vec <= p.run * c
            assert p.n_stage % p.threads == 0 or p.n_stage * p.vec == p.run * c
            raw = p.vec * elem
            smem = staged * math.ceil(p.n_stage * raw / 16) * 16 + 4 * (
                2 * p.threads * p.vec + 2 * c)
            assert smem <= min(gn.SMEM_BUDGET, SMEM_LIMIT), (c, hw, p)


def test_group_norm_launch_plan_at_the_benchmark_shapes():
    """At serving's B = 256 the largest encoder map is staged whole in a
    cluster of 16 for the forward; every thread has a vector to read."""
    p = gn.launch_plan(256, 128, 64 * 64, 2, True, 1)
    assert (p.vec, p.threads, p.cs, p.run) == (8, 256, 16, 256)
    assert p.n_stage * p.vec == p.run * 128
    small = gn.launch_plan(256, 128, 4 * 4, 2, True, 1)
    assert small.cs == 1 and small.run * 128 // small.vec == small.threads


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.partseg.group_norm.default:
            self.calls += 1
        return func(*args, **(kwargs or {}))


# deepfashion's structure (depth 4, four decoder scales, swap 1.0) at 32 px.
TINY = PartNetConfig(n_parts=4, img_size=32, features=16, depth=4, app_features=8,
                     decoder_scales=4, decoder_features=(16, 16, 8, 8), dtype=torch.float32)


def test_group_norm_calls_per_request_and_training_step(monkeypatch):
    """The op calls that the card counts as launches: 15 an infer request
    (the stem's ResBlock, 13 hourglass blocks, the head ConvBlock), 53 a
    transfer (two shape encodings, an appearance encoding, 8 decoder
    blocks), and 61 forward and 61 backward a training step with the swap
    term (the shape encoder on both halves, the appearance encoder, two
    decodes, the swap's shape encoding)."""
    model = init_weights(PartNet(TINY, device="cpu"), seed=0).eval()
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    for fn, want in ((lambda: make_infer_fn(model)(x), 15),
                     (lambda: transfer_batch(model, x, x), 53)):
        with _CountOps() as mode:
            fn()
        assert mode.calls == want
    backward_calls = []
    vjp = gn.group_norm_vjp
    monkeypatch.setattr(gn, "group_norm_vjp",
                        lambda *a: backward_calls.append(1) or vjp(*a))
    cfg = TrainConfig(model=TINY, loss=LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1,
                                                  vgg_resolution=16, swap_weight=1.0))
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=0)
    sampler = cfg.augment.make_sampler()
    period = make_train_period(cfg, model, sampler, build_perceptual(cfg, "cpu"))
    draws = [keyed_pair_draws(3, 0, np.arange(2), sampler, cfg.augment)
             for _ in range(cfg.augment.warp_every)]
    batches = tuple({"image": x} for _ in range(cfg.augment.warp_every))
    with _CountOps() as mode:
        period(create_state(cfg, model, step=5), batches, draws=draws)
    assert (mode.calls, len(backward_calls)) == (61 * cfg.augment.warp_every,
                                                 61 * cfg.augment.warp_every)
