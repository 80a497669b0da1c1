"""The op ``partseg::bias_act`` (partops/kernels/bias_act.py), a
convolution's bias epilogue.

On the CPU: its plain version against the expression the blocks ran before
it (``F.conv2d(x, w, b.to(dt))``, then ``F.relu`` or the residual sum) for
each variant, dtype and channel count; its gradients against autograd
through the plain version, bit for bit; its fake implementation under a
symbolic batch; what it rejects; its launch plan; the kernels' names in the
benchmark's trace categories; and the op calls of the model paths, which
the card counts as launches.

Marked ``cuda`` (this file imports no JAX, so it runs on the card with
``--noconftest``): the kernels against the expression they replace, bit for
bit, at the main path's shapes; the bias gradient within an f32 sum-order
tolerance; the launches per path by the registry.

Tolerance on the CPU against ``F.conv2d(x, w, b)``: the CPU's convolution
adds the bias inside its f32 accumulator before rounding once, where the
card's chain (and the op) rounds the product to the output dtype first, so
the two may differ by one rounding of the product and one of the output:
2⁻⁷ (bf16) or 2⁻²⁰ (f32: besides, the products' sums in another order) of
|z| + |b| + |output| per element.
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from h100_bench import trace
from partseg_tpu_torch import tracing
from partseg_tpu_torch.augment import keyed_pair_draws
from partseg_tpu_torch.configs import model_config, train_config
from partseg_tpu_torch.evals import make_infer_fn, transfer_batch
from partseg_tpu_torch.models.blocks import ResBlock
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.partops.kernels import _build, bias_act, bias_act_plain
from partseg_tpu_torch.train import (
    TrainConfig,
    build_perceptual,
    create_state,
    make_train_period,
)

torch.set_num_threads(1)

# The module (the package's ``bias_act`` is its function).
ba = importlib.import_module("partseg_tpu_torch.partops.kernels.bias_act")

VARIANTS = ("relu", "residual", "skip", "bias")
CHANNELS = (3, 11, 17, 64, 96, 384)
LAUNCHES, BACKWARD_LAUNCHES = "kernel.bias_act.launches", "kernel.bias_act.backward_launches"


def _case(c, dtype, device="cpu", b=2, cin=5, hw=(6, 7), seed=0):
    """x, w, b and the other branch's x_s, w_s, b_s (a 1×1 skip convolution)
    and a residual, channels_last in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed + c)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    cl = torch.channels_last
    x = randn(b, cin, *hw).to(dtype).contiguous(memory_format=cl)
    w = randn(c, cin, 3, 3, scale=0.3).to(dtype)
    bias = randn(c)
    xs = randn(b, cin, *hw).to(dtype).contiguous(memory_format=cl)
    ws = randn(c, cin, 1, 1, scale=0.3).to(dtype)
    bs = randn(c)
    res = randn(b, c, *hw).to(dtype).contiguous(memory_format=cl)
    return x, w, bias, xs, ws, bs, res


def _kwargs(variant, res, zs, bs):
    return {"relu": {"relu": True}, "residual": {"residual": res},
            "skip": {"skip": zs, "skip_bias": bs}, "bias": {}}[variant]


def _parent(variant, x, w, b, xs, ws, bs, res):
    """The blocks' expression before the op: the convolution with its bias,
    then the ReLU or the residual sum."""
    dt = x.dtype
    y = F.conv2d(x, w, b.to(dt), padding=1)
    if variant == "relu":
        return F.relu(y)
    if variant == "residual":
        return res + y
    if variant == "skip":
        return F.conv2d(xs, ws, bs.to(dt)) + y
    return y


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bias_act_on_cpu_against_the_blocks_expression(variant, dtype, c):
    x, w, b, xs, ws, bs, res = _case(c, dtype)
    z = F.conv2d(x, w, padding=1)
    zs = F.conv2d(xs, ws)
    kw = _kwargs(variant, res, zs, bs)
    got = bias_act(z, b, **kw)
    assert got.dtype == dtype and got.shape == z.shape
    assert torch.equal(got, bias_act_plain(z, b, **kw))
    want = _parent(variant, x, w, b, xs, ws, bs, res)
    room = (z.float().abs() + b.abs()[:, None, None] + want.float().abs())
    if variant == "skip":
        room = room + zs.float().abs() + bs.abs()[:, None, None]
    rel = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -20
    assert bool(((got.float() - want.float()).abs() <= rel * room).all())


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bias_act_gradients_on_cpu_equal_autograd_through_the_plain_version(variant, dtype, c):
    """d_z, d_b and the residual's, the skip's and its bias's gradients, bit
    for bit (the bias gradient summed in z's dtype, then cast to f32)."""
    _, _, b, _, _, bs, res = _case(c, dtype)
    gen = torch.Generator().manual_seed(c)
    z = (torch.randn((2, c, 6, 7), generator=gen)).to(dtype)
    zs = (torch.randn((2, c, 6, 7), generator=gen)).to(dtype)
    g = (torch.randn((2, c, 6, 7), generator=gen)).to(dtype)
    results = []
    for fn in (bias_act, bias_act_plain):
        leaves = [t.detach().requires_grad_() for t in (z, b, res, zs, bs)]
        zl, bl, rl, zsl, bsl = leaves
        out = fn(zl, bl, **_kwargs(variant, rl, zsl, bsl))
        out.backward(g)
        results.append([out] + [t.grad for t in leaves])
    for got, want in zip(*results):
        assert (got is None) == (want is None)
        assert got is None or (got.dtype == want.dtype and torch.equal(got, want))


def test_bias_act_fake_gives_the_shapes_under_a_symbolic_batch():
    """torch.export of a ResBlock without norms and with a skip: the graph
    holds a relu op for each of the inner convolutions and a skip op for the
    last, whose skip convolution takes no bias; its output carries the
    symbolic batch."""
    m = ResBlock(8, 16, norm="none", dtype=torch.float32).eval()
    batch = torch.export.Dim("batch", min=1, max=64)
    x = torch.randn((2, 8, 6, 6)).contiguous(memory_format=torch.channels_last)
    program = torch.export.export(m, (x,), dynamic_shapes=({0: batch},))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and str(n.target) == "partseg.bias_act.default"]
    assert [n.args[5] for n in nodes] == [True, True, False]
    assert nodes[2].args[2] is None and nodes[2].args[3] is not None
    out = nodes[2].meta["val"]
    assert isinstance(out.shape[0], torch.SymInt) and tuple(out.shape[1:]) == (16, 6, 6)
    x5 = torch.randn((5, 8, 6, 6)).contiguous(memory_format=torch.channels_last)
    assert torch.equal(program.module()(x5), m(x5))


def test_bias_act_rejects_what_the_kernel_does_not_take():
    z, b = torch.zeros((2, 16, 4, 4)), torch.zeros(16)
    with pytest.raises(TypeError):
        bias_act(z.half(), b)
    for kw in ({"relu": True, "residual": z}, {"residual": z, "skip": z, "skip_bias": b},
               {"skip": z}, {"residual": z[:, :8]}, {"residual": z.bfloat16()},
               {"skip": z, "skip_bias": b.double()}):
        with pytest.raises(ValueError):
            bias_act(z, b, **kw)
    for args in ((z, b.double()), (z, torch.zeros(8)), (z, torch.zeros(32)[::2]),
                 (torch.zeros((1, 520, 1, 1)), torch.zeros(520)), (z[0], b),
                 (torch.zeros((0, 16, 4, 4)), b)):
        with pytest.raises(ValueError):
            bias_act(*args)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem", [2, 4])
def test_bias_act_launch_plan_keeps_what_the_kernel_checks(elem, aligned):
    """csrc/bias_act.cu:valid: whole vectors, a thread count within the
    kernel's bound that keeps each lane on fixed channels, and at least one
    CTA; 16-byte vectors wherever the size and the pointers allow, and as
    many CTAs as give each thread BATCH vectors, up to CTAS_PER_SM a SM."""
    for c in CHANNELS + (1, 8, 16, 24, 32, 48, 128, 256, 512):
        for n_pix in (1, 7, 64, 256 * 64 * 64):
            n = n_pix * c
            p = ba.launch_plan(n, c, elem, aligned)
            assert (p.vec == 16 // elem) == (aligned and n % (16 // elem) == 0)
            assert p.vec in (1, 16 // elem) and n % p.vec == 0
            assert 0 < p.threads <= ba.MAX_THREADS and (p.threads * p.vec) % c == 0
            assert 1 <= p.ctas <= ba.CTAS_PER_SM * ba.SMS
            assert p.ctas == min(max(1, -(-n // p.vec // (p.threads * ba.BATCH))),
                                 ba.CTAS_PER_SM * ba.SMS)
    p = ba.launch_plan(256 * 64 * 64 * 64, 64, 2, True)
    assert (p.vec, p.threads, p.ctas) == (8, 256, ba.CTAS_PER_SM * ba.SMS)


def _kernel_names():
    """Each kernel of csrc/bias_act.cu as the profiler names an instance:
    the demangled template, its element type, vector width and variant."""
    src = (_build.CSRC_DIR / "bias_act.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(kMaxThreads\)\n(\w+)\(", src)
    assert kernels == ["bias_act_elementwise_fwd_kernel", "bias_act_elementwise_bwd_kernel"]
    names = []
    for kernel in kernels:
        for elem, vec in (("unsigned short", 8), ("unsigned short", 1), ("float", 4),
                          ("float", 1)):
            for act in ("0", "1", "2", "3", "true", "false"):
                names.append(f"void (anonymous namespace)::{kernel}<{elem}, {vec}, {act}>"
                             f"({elem} const*, float const*, {elem} const*, float const*, "
                             f"{elem}*, long long, int)")
    return names


def test_bias_act_kernels_fall_in_the_elementwise_category():
    """The benchmark's first-match categories put every instance in
    ``elementwise_copy``, which ``norm_elementwise_ms.*`` reads."""
    for name in _kernel_names():
        assert trace.category(name) == "elementwise_copy", name
        assert not any(word in name for word in ("conv", "reduce", "cat", "gather", "index"))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.partseg.bias_act.default:
            self.calls += 1
        return func(*args, **(kwargs or {}))


# deepfashion's structure (depth 4, four decoder scales, swap 1.0) at 32 px.
TINY = PartNetConfig(n_parts=4, img_size=32, features=16, depth=4, app_features=8,
                     decoder_scales=4, decoder_features=(16, 16, 8, 8), dtype=torch.float32)
INFER_CALLS = 45       # 46 convolutions; the stem ResBlock's skip in its residual pass
TRANSFER_CALLS = 160   # 2 · 45 + 45 + 25 (the decoder's 28 convolutions, 3 skips)
# A deepfashion training step: the shape encoder twice (45 each), the
# appearance encoder (45), two decodes (25 each), and the VGG's 10
# convolutions on the reconstruction and on its target; the target's take
# no gradient, so 10 fewer backward launches.
TRAIN_CALLS, TRAIN_BACKWARD = 205, 195


def _tiny_deepfashion() -> TrainConfig:
    """The deepfashion preset at 32 px and narrow widths, f32: every
    convolution of its training step, at another size."""
    cfg = train_config("deepfashion")
    model = dataclasses.replace(cfg.model, img_size=32, features=16, app_features=8,
                                decoder_features=(16, 16, 8, 8), dtype=torch.float32)
    return dataclasses.replace(cfg, model=model,
                               loss=dataclasses.replace(cfg.loss, vgg_resolution=16))


def test_bias_act_calls_per_request_and_training_step(monkeypatch):
    """The op calls that the card counts as launches: one per convolution,
    less the skip convolutions, whose output the residual pass takes: 45 an
    infer request (the stem's convolution, its ResBlock, 13 hourglass
    blocks, the head block and the head), 160 a transfer, and a deepfashion
    training step's forward calls and backward launches (a call whose bias
    takes a gradient or that applies a ReLU)."""
    model = init_weights(PartNet(TINY, device="cpu"), seed=0).eval()
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    for fn, want in ((lambda: make_infer_fn(model)(x), INFER_CALLS),
                     (lambda: transfer_batch(model, x, x), TRANSFER_CALLS)):
        with _CountOps() as mode:
            fn()
        assert mode.calls == want
    backward_calls = []
    vjp = ba.bias_act_vjp
    monkeypatch.setattr(ba, "bias_act_vjp", lambda g, r, want: backward_calls.append(
        r is not None or want) or vjp(g, r, want))
    cfg = _tiny_deepfashion()
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=0)
    sampler = cfg.augment.make_sampler()
    period = make_train_period(cfg, model, sampler, build_perceptual(cfg, "cpu"))
    draws = [keyed_pair_draws(3, 0, np.arange(2), sampler, cfg.augment)
             for _ in range(cfg.augment.warp_every)]
    batches = tuple({"image": x} for _ in range(cfg.augment.warp_every))
    with _CountOps() as mode:
        period(create_state(cfg, model, step=5), batches, draws=draws)
    steps = cfg.augment.warp_every
    assert (mode.calls, sum(backward_calls)) == (TRAIN_CALLS * steps, TRAIN_BACKWARD * steps)


# ----------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_on_card(cuda, variant, dtype, b, cin, c, hw, aligned=True, seed=0):
    """The op against the blocks' expression on the card, bit for bit; its
    backward: g_z the ReLU's threshold_backward bit for bit, the bias
    gradient within 1e-5 of Σ|g_z| per channel (f32 partial sums over a
    thread's vectors, a CTA's rows and the CTAs, in another order than the
    float64 reference's); repeats give the same bits; launches counted."""
    x, w, bias, xs, ws, bs, res = _case(c, dtype, device=cuda, b=b, cin=cin, hw=hw, seed=seed)
    z = F.conv2d(x, w, padding=1)
    zs = F.conv2d(xs, ws)
    if not aligned:     # storage one element in: no 16-byte vectors
        z = torch.empty(z.numel() + 1, device=cuda, dtype=dtype)[1:].view(
            z.permute(0, 2, 3, 1).shape).permute(0, 3, 1, 2).copy_(z)
    kw = _kwargs(variant, res, zs, bs)
    before = (tracing.counter(LAUNCHES), tracing.counter(BACKWARD_LAUNCHES))
    got = bias_act(z, bias, **kw)
    with torch.inference_mode():
        again = bias_act(z, bias, **kw)
    want = _parent(variant, x, w, bias, xs, ws, bs, res)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got, torch.ops.partseg.bias_act(z, bias, kw.get("residual"),
                                                       kw.get("skip"), kw.get("skip_bias"),
                                                       variant == "relu"))

    g = torch.randn(z.shape, generator=torch.Generator(device=cuda).manual_seed(seed),
                    device=cuda).to(dtype).contiguous(memory_format=torch.channels_last)
    leaves = [t.detach().requires_grad_() for t in (z, bias, res, zs, bs)]
    zl, bl, rl, zsl, bsl = leaves
    out = bias_act(zl, bl, **_kwargs(variant, rl, zsl, bsl))
    out.backward(g)
    g_z = torch.ops.aten.threshold_backward(g, out.detach(), 0) if variant == "relu" else g
    assert torch.equal(zl.grad, g_z)
    want_db = g_z.double().sum((0, 2, 3))
    room = 1e-5 * g_z.double().abs().sum((0, 2, 3))
    assert bl.grad.dtype == torch.float32
    assert bool(((bl.grad.double() - want_db).abs() <= room).all())
    if variant == "residual":
        assert torch.equal(rl.grad, g)
    if variant == "skip":
        assert torch.equal(zsl.grad, g) and torch.equal(bsl.grad, bl.grad)
    torch.cuda.synchronize()
    assert tracing.counter(LAUNCHES) - before[0] == 4
    assert tracing.counter(BACKWARD_LAUNCHES) - before[1] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(256, 128, 64, 64), (256, 64, 32, 128)])
def test_bias_act_kernel_at_the_main_path_shapes(cuda, variant, shape):
    """[256, 64, 64, 64] and [256, 32, 128, 128] bf16, as an encoder's and
    the decoder's inner convolutions give them."""
    b, cin, c, side = shape
    _check_on_card(cuda, variant, torch.bfloat16, b, cin, c, (side, side))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bias_act_kernel_at_every_variant_dtype_and_width(cuda, variant, dtype, c, aligned):
    _check_on_card(cuda, variant, dtype, 3, 5, c, (9, 7), aligned=aligned, seed=c)


@pytest.mark.cuda
def test_bias_act_launches_per_request_and_training_step(cuda):
    """The registry's counts from the model code at the celeba and deepfashion
    presets: 45 forward launches an infer request, 160 a transfer, and a
    deepfashion training step's forward and backward launches."""
    from partseg_tpu_torch.bench import build_trainer

    model = init_weights(PartNet(model_config("celeba")), seed=0).eval()
    x = torch.rand((2, 128, 128, 3), generator=torch.Generator(device=cuda).manual_seed(0),
                   device=cuda)
    tracing.reset()
    make_infer_fn(model)(x)
    assert tracing.counter(LAUNCHES) == INFER_CALLS
    transfer_batch(model, x, x)
    assert tracing.counter(LAUNCHES) == INFER_CALLS + TRANSFER_CALLS
    cfg = train_config("deepfashion")
    state, period, batches, _ = build_trainer(cfg, 2, seed=0)
    tracing.reset()
    period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    steps = cfg.augment.warp_every
    assert (tracing.counter(LAUNCHES), tracing.counter(BACKWARD_LAUNCHES)) == (
        TRAIN_CALLS * steps, TRAIN_BACKWARD * steps)
