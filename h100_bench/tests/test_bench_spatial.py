"""The four-rank spatial cell on the CPU: its driver (four gloo processes, the
harness's own as rank 0) at the tiny size, the check correct for the program
and not correct for the float8 control and for each fault, and each of the
cell's span and counter readers silent where the program lacks its span or
counter."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from h100_bench import run as bench
from h100_bench.tests import tiny
from h100_bench.tests.test_bench_check import AGREE, SEED

CELL = "celeba256_spatial_2x2"
READERS = ("halo_ms.spatial", "reduce_ms.spatial", "grad_reduce_ms.spatial",
           "collectives_per_step.spatial")


def _run(variant="program", plant=None, trace=False):
    spec = tiny.spec(CELL)
    if plant:
        spec.traffic["plant"] = plant
    return bench.run(CELL, SEED, 0.3, trace, variant, device="cpu", spec=spec)


def test_spatial_reference_agrees_with_the_program():
    r = _run(trace=True)
    readings = {**{name: c["value"] for name, c in r["checks"].items()}, **r["detail"]}
    for name, value in readings.items():
        assert value <= AGREE[name], (name, value)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    # On the CPU the device readers stay silent; the counters are read.
    assert {"mfu.spatial", "host_dispatch_ms.spatial",
            "collectives_per_step.spatial"} <= set(r["metrics"])


@pytest.mark.parametrize("variant,plant", [("control", None), ("frozen_state", None),
                                           ("half_batch", None), ("program", "no_halo")])
def test_a_spatial_fault_comes_out_not_correct(variant, plant):
    r = _run(variant, plant)
    assert not r["correct"], r["checks"]


def test_an_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="no variant"):
        _run("altered_answer")


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_without_the_programs_span(name, monkeypatch):
    """A program without the span registry, and one whose registry lacks the
    spatial step's spans and the gradient all-reduce's counter (the parent's)."""
    reader = bench.load_file(bench.BENCH_DIR / "metrics" / f"{name}.py")
    ctx = SimpleNamespace(traced=SimpleNamespace())
    monkeypatch.setitem(sys.modules, "partseg_tpu_torch.tracing", None)
    assert reader.read(ctx) is None
    monkeypatch.undo()
    from partseg_tpu_torch import tracing

    tracing.reset()
    ctx.traced.counters = {"spatial.halo": 151, "spatial.reduce": 151}
    try:
        assert reader.read(ctx) is None
    finally:
        tracing.reset()
