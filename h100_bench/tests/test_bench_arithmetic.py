"""The yardstick's arithmetic: FLOPs counted on the reference, the kernels'
bounds, the seeded weights and inputs, and what the trace counts as device time."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from h100_bench import flops, peaks, program, trace, weights
from h100_bench import run as bench

# GFLOP per image, counted on a CPU copy of the port at batch 1 and 2 in f32.
TABLE = {("celeba", "infer"): 1.543, ("celeba", "transfer"): 6.061,
         ("deepfashion", "train"): 54.06}


def config(name):
    return json.loads((bench.BENCH_DIR / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,entry", sorted(TABLE))
def test_flops_match_the_table(name, entry):
    got = flops.per_image(config(name), entry) / 1e9
    assert got == pytest.approx(TABLE[name, entry], rel=1e-3)


def test_flops_are_linear_in_the_batch():
    """The count at batch 2 is twice the count at batch 1, so a count at batch
    1 scales to the cell's batch."""
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference import model as ref

    cfg = config("celeba")
    net = ref.PartNet(cfg["model"])
    counts = []
    for b in (1, 2):
        x = torch.rand((b, 128, 128, 3))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref.transfer(net, x, x)
        counts.append(fc.get_total_flops())
    assert counts[1] == 2 * counts[0]


def test_bounds_match_the_kernel_table():
    assert peaks.bound_ms(*peaks.softmax_moments_bound(256, 64, 64, 10)) == (
        0.02505590447761194, "bytes")
    celeba = config("celeba")["model"]
    serve = sum(peaks.bound_ms(*peaks.render_assemble_bound(256, 10, f, r))[0]
                for r, f in peaks.decoder_scales(celeba))
    assert serve == pytest.approx(0.301294423880597, rel=1e-12)
    deep = config("deepfashion")["model"]
    fwd = [peaks.bound_ms(*peaks.render_assemble_bound(64, 16, f, r))[0]
           for r, f in peaks.decoder_scales(deep)]
    bwd = [peaks.bound_ms(*peaks.render_backward_bound(64, 16, f, r))[0]
           for r, f in peaks.decoder_scales(deep)]
    assert fwd[0] == pytest.approx(0.005171964179104478, rel=1e-12)
    assert sum(fwd) == pytest.approx(0.0754446515, rel=1e-8)
    assert sum(bwd) == pytest.approx(0.07576744119402985, rel=1e-12)


def test_weights_and_images_come_from_the_seed():
    cfg = config("celeba")
    a, b = (program.model_weights(cfg, 2**31 + 5, "cpu") for _ in range(2))
    c = program.model_weights(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["shape_enc.head.weight"], c["shape_enc.head.weight"])
    w = a["shape_enc.stem.conv.weight"]
    assert w.abs().max() <= 2.0 * (w[0].numel() ** -0.5) / 0.87962566103423978 + 1e-6
    assert float(a["decoder.to_rgb.bias"].abs().max()) == 0.0
    assert float(a["shape_enc.head_block.norm.weight"].min()) == 1.0
    imgs = program.image_pool(2, 3, 8, 2**40 + 1, "cpu")
    assert torch.equal(imgs, program.image_pool(2, 3, 8, 2**40 + 1, "cpu"))
    assert not torch.equal(imgs[0], imgs[1])
    assert weights.stream(2**40, 1) != weights.stream(2**40, 2)
    ramp = program.image_pool(1, 5, 8, 2**40 + 1, "cpu", (0.5, 1.0))[0] - 0.5
    widths = ramp.amax(dim=(1, 2, 3)) - ramp.amin(dim=(1, 2, 3))
    assert torch.all(widths[1:] > widths[:-1]) and float(widths[0]) < 0.5


def test_device_time_leaves_out_annotations():
    """A record_function span or NCCL's range lies on the card's timeline over
    the kernels it covers; counting it too would count their time twice."""
    cpu, cuda = torch.autograd.DeviceType.CPU, trace.CUDA
    kernel = SimpleNamespace(key="gemm_kernel", device_type=cuda, is_user_annotation=False,
                             self_device_time_total=40.0)
    span = SimpleNamespace(key="nccl:all_reduce", device_type=cuda, is_user_annotation=True,
                           self_device_time_total=40.0)
    host = SimpleNamespace(key="aten::mm", device_type=cpu, is_user_annotation=False,
                           self_device_time_total=0.0)
    prof = SimpleNamespace(key_averages=lambda: [kernel, span, host])
    assert trace.kernel_us(prof) == {"gemm_kernel": 40.0}
    assert trace.device_us(prof) == 40.0
