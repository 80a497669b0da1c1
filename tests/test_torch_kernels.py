"""Port parity: the kernel wrappers softmax_moments and render_assemble.

On the CPU each wrapper runs its plain PyTorch version; that is held
against the JAX package's Pallas kernel (interpret mode, as the JAX
package's own tests run it) and against the JAX plain path
(``use_pallas=False``), at float32. The CUDA kernels themselves run only
on a card: tests/test_torch_cuda.py holds them against these plain
versions there (and chip_smoke.py at the serving shapes).

Both wrappers are autograd Functions whose backward is the JAX
``custom_vjp``'s closed form; their VJPs are held against ``jax.vjp`` of
the Pallas kernels here.

Tolerances: 1e-5 absolute for μ, Σ and the render output (f32 sums of
H·W or K terms in another order); parts rtol 1e-5 (one exp and one
division per element); cotangents 1e-5 of their largest entry (the same
sums, backwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partseg_tpu.partops as jp
from partseg_tpu.partops.pallas import render_assemble as jax_render_assemble
from partseg_tpu.partops.pallas import softmax_moments as jax_softmax_moments
from partseg_tpu_torch import tracing
from partseg_tpu_torch.partops import precision_from_cov
from partseg_tpu_torch.partops.kernels import (
    _build,
    bias_act,
    group_norm,
    render_assemble,
    softmax_moments,
    tps_warp,
)
from partseg_tpu_torch.partops.kernels.tps_warp import MAX_CLUSTER as TPS_MAX_CLUSTER
from partseg_tpu_torch.partops.kernels.tps_warp import SMEM_OPT_IN as TPS_SMEM_OPT_IN
from partseg_tpu_torch.partops.kernels.tps_warp import SMEM_PER_SM as TPS_SMEM_PER_SM
from partseg_tpu_torch.partops.kernels.tps_warp import launch_plan, pad_columns
from partseg_tpu_torch.partops.kernels.render_assemble import (
    CHUNK_CHANNELS,
    GROUP_PARTS,
    MAX_CLUSTER,
    NARROW_PARTS,
    backward_chunks,
    backward_groups,
    backward_partial_rows,
    backward_tile,
    render_assemble_vjp,
)
from _torch_parity import n, t

torch.set_num_threads(1)

BACKWARD = "kernel.render_assemble.backward_launches"


def launches(kernel: str) -> int:
    """The registry's count of ``kernel``'s forward launches (``tracing``)."""
    return tracing.counter(f"kernel.{kernel}.launches")


def _logits(seed, b=2, h=16, w=16, k=4, delta=False):
    x = 3.0 * np.random.default_rng(seed).standard_normal((b, h, w, k + 1)).astype(np.float32)
    if delta:
        x[:, 4, 9, :k] = 80.0        # one-hot part maps: a singular Σ
    return x


def _render_inputs(seed, b=2, k=5, c=7, singular=False):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-0.7, 0.7, (b, k, 2)).astype(np.float32)
    a = (0.1 * rng.standard_normal((b, k, 2, 2))).astype(np.float32)
    sigma = (np.einsum("...ij,...kj->...ik", a, a) + 0.01 * np.eye(2)).astype(np.float32)
    if singular:
        sigma[:, 0] = 0.0
    lam = np.asarray(jp.precision_from_cov(sigma))
    app = rng.standard_normal((b, k, c)).astype(np.float32)
    return mu, sigma, lam, app


# ------------------------------------------------------------ softmax_moments

@pytest.mark.parametrize("delta", [False, True])
def test_softmax_moments_matches_jax(delta):
    x = _logits(0, delta=delta)
    k = x.shape[-1] - 1
    fg = t(x)[..., :k]                       # strided slice, as PartNet passes it
    assert not fg.is_contiguous()
    parts, mu, sigma = softmax_moments(fg)
    for want in (jax_softmax_moments(jnp.asarray(x[..., :k])),
                 (lambda p: (p, *jp.soft_argmax_moments(p)))(jp.spatial_softmax(x[..., :k]))):
        np.testing.assert_allclose(n(parts), np.asarray(want[0]), rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(n(mu), np.asarray(want[1]), atol=1e-5)
        np.testing.assert_allclose(n(sigma), np.asarray(want[2]), atol=1e-5)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in (parts, mu, sigma))
    lam = precision_from_cov(sigma)
    assert torch.isfinite(lam).all()


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got.float()), want, atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("only_mu", [False, True])
def test_softmax_moments_vjp_matches_jax(delta, only_mu):
    """The wrapper's outputs carry one backward node, the registered op's
    (partseg::softmax_moments, whose gradient is the closed form); the
    logit cotangent through the strided foreground slice equals jax.vjp of
    the Pallas kernel's."""
    x = _logits(20, delta=delta)
    k = x.shape[-1] - 1
    rng = np.random.default_rng(21)
    g = [rng.standard_normal(s).astype(np.float32) for s in ((2, 16, 16, k), (2, k, 2), (2, k, 2, 2))]
    if only_mu:
        g[0], g[2] = np.zeros_like(g[0]), np.zeros_like(g[2])
    xt = t(x).requires_grad_()
    outs = softmax_moments(xt[..., :k])
    nodes = {o.grad_fn for o in outs}
    assert len(nodes) == 1 and "partseg_softmax_moments" in type(nodes.pop()).__name__
    if only_mu:
        (got,) = torch.autograd.grad(outs[1], xt, t(g[1]))
    else:
        (got,) = torch.autograd.grad(outs, xt, [t(v) for v in g])
    _, vjp = jax.vjp(lambda v: jax_softmax_moments(v[..., :k]), jnp.asarray(x))
    (want,) = vjp(tuple(jnp.asarray(v) for v in g))
    _close(got, want)
    assert not got[..., k].abs().any()                      # the background channel


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("app_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c", [(5, 7), (16, 256)])   # and deepfashion's K = 16 at 256 channels
def test_render_assemble_vjp_matches_jax(kernel, app_dtype, k, c):
    mu, _, lam, app = _render_inputs(22, k=k, c=c)
    if app_dtype == torch.bfloat16:                        # both sides see the rounded values
        app = np.asarray(torch.from_numpy(app).to(torch.bfloat16).float())
    h, w = 8, 12
    g = np.random.default_rng(23).standard_normal((2, h, w, app.shape[-1])).astype(np.float32)
    args = [t(mu).requires_grad_(), t(lam).requires_grad_(), t(app).to(app_dtype).requires_grad_()]
    out = render_assemble(*args, h, w, kernel)
    assert type(out.grad_fn).__name__ == "_RenderAssembleBackward"
    before = tracing.counter(BACKWARD)
    got = torch.autograd.grad(out, args, t(g))
    assert tracing.counter(BACKWARD) == before      # the CPU branch: no kernel
    japp = jnp.asarray(app, jnp.bfloat16 if app_dtype == torch.bfloat16 else jnp.float32)
    _, vjp = jax.vjp(lambda m, l, a: jax_render_assemble(m, l, a, h, w, kernel), mu, lam, japp)
    d_mu, d_lam, d_app = vjp(jnp.asarray(g))
    _close(got[0], d_mu)
    _close(got[1], d_lam)
    # d_app comes back in the appearance dtype on both sides: at bf16 the
    # two f32 sums may round to neighbouring bf16 values (2⁻⁸ relative).
    d_app = np.asarray(d_app, np.float32)
    np.testing.assert_allclose(n(got[2].float()), d_app, rtol=2 ** -8,
                               atol=1e-5 * np.abs(d_app).max())
    assert got[2].dtype == app_dtype
    assert not got[1][..., 1, 0].any()                     # off-diagonal cotangent on [0, 1]


def test_softmax_moments_rejects_what_the_kernel_does_not_take():
    x = t(_logits(1))
    with pytest.raises(TypeError):
        softmax_moments(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        softmax_moments(x[0])                         # rank 3
    with pytest.raises(ValueError):
        softmax_moments(x[:, ::2])                    # rows skipped: pixels unevenly spaced
    with pytest.raises(ValueError):
        softmax_moments(x.permute(0, 3, 1, 2))        # parts not adjacent
    with pytest.raises(ValueError):
        softmax_moments(x[:0])                        # empty
    with pytest.raises(ValueError):
        softmax_moments(torch.zeros((1, 2, 2, 65)))   # K > 64


# ------------------------------------------------------------ render_assemble

@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("singular", [False, True])
def test_render_assemble_matches_jax(kernel, singular):
    mu, sigma, lam, app = _render_inputs(2, singular=singular)
    h, w = 16, 32
    got = render_assemble(t(mu), t(lam), t(app), h, w, kernel)
    pallas = jax_render_assemble(mu, lam, app, h, w, kernel)
    plain = jp.assemble_decoder_input(
        jp.render_gaussians(mu, sigma, h, w, kernel=kernel, precision=lam), app)
    for want in (pallas, plain):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()


def test_render_assemble_takes_bf16_appearance_summed_in_f32():
    mu, _, lam, app = _render_inputs(3)
    app_bf16 = torch.from_numpy(app).to(torch.bfloat16)
    got = render_assemble(t(mu), t(lam), app_bf16, 8, 8)
    want = jax_render_assemble(mu, lam, jnp.asarray(app, jnp.bfloat16), 8, 8, "gauss")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_render_assemble_rejects_what_the_kernel_does_not_take():
    mu, _, lam, app = (t(v) for v in _render_inputs(4))
    with pytest.raises(ValueError):
        render_assemble(mu, lam, app, 8, 8, "box")
    with pytest.raises(TypeError):
        render_assemble(mu.double(), lam, app, 8, 8)
    with pytest.raises(TypeError):
        render_assemble(mu, lam, app.half(), 8, 8)
    with pytest.raises(ValueError):
        render_assemble(mu[:, :3], lam, app, 8, 8)              # K disagrees
    with pytest.raises(ValueError):
        render_assemble(mu, lam, app.transpose(1, 2).contiguous().transpose(1, 2), 8, 8)
    big = torch.zeros((1, 33, 4))
    with pytest.raises(ValueError):                             # K > 32
        render_assemble(torch.zeros((1, 33, 2)), torch.zeros((1, 33, 2, 2)), big, 8, 8)
    # Any C runs: the backward kernel walks the channels in chunks.
    wide = render_assemble(torch.zeros((1, 16, 2)), torch.zeros((1, 16, 2, 2)),
                           torch.zeros((1, 16, 2048)), 8, 8)
    assert wide.shape == (1, 8, 8, 2048)


@pytest.mark.parametrize("k,c,hw,b,tile,rows,groups,chunks", [
    (10, 96, 64, 128, 64, 0, 1, 1), (10, 48, 256, 128, 128, 0, 1, 1),   # the speed128 decoder:
    (10, 24, 1024, 128, 256, 0, 1, 1),                                  # one cluster per image
    (4, 7, 20, 2, 64, 0, 1, 1), (10, 24, 2048, 1, 256, 0, 1, 1),        # a ragged tile; 8 tiles
    (10, 24, 2304, 1, 256, 9, 1, 1),                                    # 9 tiles: partial sums
    (10, 64, 4096, 256, 256, 4, 1, 1), (10, 32, 16384, 256, 256, 4, 1, 1),  # celeba 64², 128²
    (10, 256, 256, 64, 256, 0, 1, 2),                     # the flagship's 16²×256: two chunks
    (16, 256, 256, 64, 256, 0, 1, 2), (16, 128, 1024, 64, 256, 0, 1, 1),  # deepfashion, K = 16:
    (16, 64, 4096, 64, 256, 16, 1, 1), (16, 32, 16384, 64, 256, 16, 1, 1),  # 16² to 128²
    (10, 1000, 64, 3, 256, 0, 1, 8), (10, 129, 1024, 2, 256, 0, 1, 2),  # eight chunks; a ragged one
    (13, 8, 1600, 2, 256, 0, 1, 1), (17, 256, 2304, 2, 256, 9, 2, 2),   # K > 12; two groups
    (32, 48, 1024, 128, 256, 0, 2, 1),                                  # K = 32
])
def test_render_assemble_backward_tile_fits_shared_memory(k, c, hw, b, tile, rows, groups,
                                                          chunks):
    """The backward kernel's pixels per tile, rows of partial sums, part
    groups and channel chunks. Its shared memory is fixed (a tile of φ and
    one chunk of a per group), so every K <= 32 and every C fit: K <= 12 is
    one group, larger K groups of 16; chunks of 128 channels. Tiles of 256
    pixels (64 up to 128 pixels, 128 up to 512, where C <= 128), one
    cluster per image and group up to 8 tiles (no scratch), else
    min(tiles, 1024 // B) blocks of partials."""
    assert backward_tile(k, c, hw) == tile
    assert backward_partial_rows(k, c, hw, b, tile) == rows
    assert (backward_groups(k), backward_chunks(c)) == (groups, chunks)
    assert -(-hw // tile) <= MAX_CLUSTER or rows
    assert groups * (NARROW_PARTS if k <= NARROW_PARTS else GROUP_PARTS) >= k
    assert chunks * CHUNK_CHANNELS >= c > (chunks - 1) * CHUNK_CHANNELS
    render_assemble(*(torch.zeros(s) for s in ((1, k, 2), (1, k, 2, 2), (1, k, c))), 4, 5)


@pytest.mark.parametrize("k,c,kernel", [(16, 256, "gauss"), (10, 1000, "gauss"),
                                        (17, 129, "heavy_tail")])
def test_render_assemble_vjp_sums_over_chunks_and_groups(k, c, kernel):
    """The algebra the backward kernel relies on: g_d = g_φ·dφ/dd with
    dφ/dd independent of g, so d_μ and d_Λ are linear in g_φ = Σ_c g·a.
    The VJP of each part group at each channel chunk (its μ, Λ and a's
    slice, g's slice), with d_μ and d_Λ added over the chunks in order and
    d_app put together from the slices, equals the whole VJP within
    1e-6 of each cotangent's largest entry."""
    mu, _, lam, app = (t(v) for v in _render_inputs(24 + k, k=k, c=c))
    h, w = 6, 7
    g = t(np.random.default_rng(25).standard_normal((2, h, w, c)).astype(np.float32))
    want = render_assemble_vjp(mu, lam, app, h, w, kernel, g)
    got = [torch.zeros_like(v) for v in want]
    size = NARROW_PARTS if k <= NARROW_PARTS else GROUP_PARTS
    for grp in range(backward_groups(k)):
        parts = slice(grp * size, min(k, (grp + 1) * size))
        for chunk in range(backward_chunks(c)):
            chans = slice(chunk * CHUNK_CHANNELS, min(c, (chunk + 1) * CHUNK_CHANNELS))
            d_mu, d_lam, d_app = render_assemble_vjp(
                mu[:, parts].contiguous(), lam[:, parts].contiguous(),
                app[:, parts, chans].contiguous(), h, w, kernel, g[..., chans].contiguous())
            got[0][:, parts] += d_mu
            got[1][:, parts] += d_lam
            got[2][:, parts, chans] = d_app
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=0, atol=1e-6 * n(b).__abs__().max())


@pytest.mark.parametrize("b,h,w,m,kh,tile,plan", [
    (32, 128, 128, 28, 0, 4096, (128, 8, 1, 128, 4, 24512, 28)),    # speed128's warp head
    (32, 128, 128, 28, 56, 4096, (512, 4, 8, 32, 8, 46112, 28)),    # band, bf16 tiles
    (32, 128, 128, 28, 56, 2048, (256, 4, 8, 64, 8, 37920, 28)),    # band, f32 tiles
    (13, 40, 48, 28, 0, 0, (128, 8, 1, 15, 2, 24512, 28)),          # a ragged run and group
    (5, 17, 13, 19, 0, 0, (128, 8, 1, 2, 1, 19904, 19)),            # M = 19: rows of 20
    (10, 40, 48, 28, 24, 480, (240, 4, 2, 8, 3, 37408, 28)),        # two CTAs to a tile
    (2, 256, 256, 28, 56, 65536, (8192, 2, 8, 8, 1, 160800, 28)),   # a long run: 2 images
    (65535, 8, 8, 12, 0, 0, (128, 8, 1, 1, 8192, 15296, 12)),       # the largest batch
    (1, 8, 8, 396, 0, 0, (128, 4, 1, 1, 1, 232384, 396)),           # M = 396: four images
    (32, 128, 128, 403, 0, 4096, (128, 16, 1, 128, 2, 111488, 24)),  # grid 20: the wide path
    (32, 128, 128, 228, 56, 4096, (512, 8, 8, 32, 4, 108992, 16)),  # grid 15, band: wide
    (32, 128, 128, 212, 56, 4096, (512, 2, 8, 32, 16, 232224, 212)),  # band, M = 212: whole
    (2, 256, 256, 403, 56, 65536, (8192, 2, 8, 8, 1, 199072, 16)),  # long run: 2 images
])
def test_tps_warp_launch_plan_fits_the_card(b, h, w, m, kh, tile, plan):
    """The kernel's launch: runs of 128 points and groups of up to 8 images
    (band mode: a tile over a cluster of up to 8 CTAs in chunks of 256
    points, 4 images), the images halved while the shared memory exceeds the
    opt-in limit; where the basis rows do not fit whole even so, the wide
    path: up to 16 images in runs of 128 points and chunks of 24 columns
    (band mode: 8 images, the same points and cluster, chunks of 16), in
    half an SM where that leaves room (two CTAs to an SM, as at grid 20 and
    grid 15 banded), else in the opt-in limit; the grid covers every point
    and image within the card's limits."""
    got = launch_plan(b, h, w, m, kh, tile)
    assert tuple(got) == plan
    assert got.chunk == m or got.smem <= TPS_SMEM_PER_SM // 2 - 1024 or tile == 65536
    assert got.smem <= TPS_SMEM_OPT_IN and got.cluster <= TPS_MAX_CLUSTER
    assert got.grid_y <= 65535 and got.grid_y * got.group >= b
    assert got.grid_x % got.cluster == 0
    assert got.chunk == m or (got.chunk < m and got.chunk % 8 == 0)
    if kh:
        assert got.points * got.cluster >= tile and got.grid_x // got.cluster * tile == h * w
    else:
        assert got.grid_x * got.points >= h * w


def test_tps_warp_pad_columns_keeps_the_flow_terms():
    """The wide path's 16-byte rows: zero columns appended to w and the
    basis up to a multiple of 4, the basis a new 16-byte aligned tensor (a
    copy even where no column is added, for a view that starts off 16
    bytes)."""
    rng = np.random.default_rng(31)
    w, b = t(rng.standard_normal((2, 403, 2))), t(rng.standard_normal((65, 403)))
    pw, pb = pad_columns(w, b)
    assert pw.shape == (2, 404, 2) and pb.shape == (65, 404) and pb.is_contiguous()
    assert torch.equal(pw[:, :403], w) and torch.equal(pb[:, :403], b)
    assert not pw[:, 403:].any() and not pb[:, 403:].any() and pb.data_ptr() % 16 == 0
    view = pb.reshape(-1)[404:].reshape(64, 404)[:, :400].contiguous()
    pw, pb = pad_columns(pw[:, :400], view)
    assert pb.shape == (64, 400) and torch.equal(pb, view) and pb.data_ptr() != view.data_ptr()


def test_tps_warp_rejects_a_basis_beyond_shared_memory(monkeypatch):
    """Any M runs: a basis too wide for shared memory is staged in chunks
    (M = 400 and 6144, beyond PR 5's limit of 396, take the plain version
    here). What is refused is a band tile whose pixel indices alone do not
    fit: $PARTSEG_WARP_TILE = 2²⁰ points at 1024² is 2¹⁷ points per CTA."""
    img = torch.zeros((1, 8, 8, 3))
    for m in (396, 400, 6144):
        assert tps_warp(img, torch.zeros((1, m, 2)), torch.zeros((64, m))).shape == img.shape
    monkeypatch.setenv("PARTSEG_WARP_BAND", "56")
    monkeypatch.setenv("PARTSEG_WARP_TILE", str(2 ** 20))
    big = torch.zeros((1, 1024, 1024, 1))
    with pytest.raises(ValueError, match="shared memory"):
        tps_warp(big, torch.zeros((1, 28, 2)), torch.zeros((2 ** 20, 28)))


def test_kernel_modules_import_and_run_on_cpu_without_building():
    """Importing the wrappers and running them on CPU tensors needs no
    nvcc, no triton and no GPU: nothing is built or loaded."""
    mu, _, lam, app = (t(v) for v in _render_inputs(5))
    kernels = ("softmax_moments", "render_assemble", "group_norm", "bias_act")
    before = [launches(k) for k in kernels]
    softmax_moments(t(_logits(5)))
    render_assemble(mu, lam, app, 8, 8)
    group_norm(torch.ones((2, 16, 3, 3)), torch.ones(16), torch.zeros(16), 8, 1e-6, relu=True)
    bias_act(torch.ones((2, 16, 3, 3)), torch.zeros(16), relu=True)
    assert [launches(k) for k in kernels] == before
    assert _build.library.cache_info().currsize == 0
    assert sorted(p.name for p in _build.CSRC_DIR.glob("*.cu")) == [
        "bias_act.cu", "bilinear_sample.cu", "errors.cu", "group_norm.cu", "render_assemble.cu",
        "softmax_moments.cu", "tps_warp.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
