"""The span and counter registry (partseg_tpu_torch/tracing.py): off, a span
reads the profiler's flag and nothing else; under torch.profiler spans nest
and count, with no device time on the CPU and their CPU half in the trace;
the pending event pairs stay bounded and resolve when read; the counters;
the spatial step's spans and its collectives' counters on two gloo ranks.
Marked ``cuda``: on the card a span's device ms agrees with the device-side
range the profiler gives it, and a span inside a CUDA graph's capture does
not break the capture."""

from __future__ import annotations

from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from partseg_tpu_torch import tracing


@pytest.fixture(autouse=True)
def clean_registry():
    tracing.reset()
    yield
    tracing.reset()


class FakeEvent:
    """A timing event whose clock is a counter of records: elapsed_time is
    the number of records between two events."""

    clock = 0

    def record(self):
        FakeEvent.clock += 1
        self.at = FakeEvent.clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_span_off_reads_the_flag_and_nothing_else():
    """No profiler: no record_function is entered and no event is taken,
    even where CUDA looks initialised; nothing is counted."""
    with mock.patch.object(torch.profiler, "record_function") as record, \
            mock.patch.object(tracing, "_event") as event, \
            mock.patch.object(torch.cuda, "is_initialized", return_value=True):
        with tracing.span("a"):
            with tracing.span("b"):
                pass
    assert not record.called and not event.called
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_spans_nest_and_count_under_a_cpu_profiler():
    x = torch.ones(4, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            for _ in range(2):
                with tracing.span("inner"):
                    x = x @ x
    spans = tracing.snapshot()["spans"]
    assert spans == {"outer": {"calls": 1, "device_ms": None},
                     "inner": {"calls": 2, "device_ms": None}}
    marks = [e for e in prof.events() if e.name in ("outer", "inner")]
    assert sorted(e.name for e in marks) == ["inner", "inner", "outer"]
    assert all(e.device_type == torch.autograd.DeviceType.CPU and e.is_user_annotation
               for e in marks)
    outer = next(e for e in marks if e.name == "outer")
    assert all(outer.time_range.start <= e.time_range.start
               and e.time_range.end <= outer.time_range.end for e in marks)


def test_pending_pairs_are_bounded_and_resolved_when_read(monkeypatch):
    """With events (faked here), past MAX_PENDING unread pairs the oldest are
    resolved as spans end; the rest when read. A pair taken while the stream
    captures a graph is not taken."""
    monkeypatch.setattr(tracing, "MAX_PENDING", 3)
    monkeypatch.setattr(tracing, "_pool", [])
    monkeypatch.setattr(tracing, "_profiler_on", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    capturing = mock.Mock(return_value=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", capturing)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: FakeEvent())
    for _ in range(5):
        with tracing.span("s"):
            FakeEvent().record()          # one tick inside each span
        assert len(tracing._pending) <= 3
    assert len(tracing._pending) == 3 and tracing._device_ms == {"s": 4.0}
    capturing.return_value = True
    with tracing.span("captured"):
        pass
    snap = tracing.snapshot()["spans"]
    assert snap == {"s": {"calls": 5, "device_ms": 10.0},
                    "captured": {"calls": 1, "device_ms": None}}
    assert not tracing._pending and len(tracing._pool) >= 2   # events go back to the pool


def test_counters_count_and_reset():
    tracing.count("kernel.a.launches")
    tracing.count("kernel.a.launches", 2)
    tracing.count("spatial.halo")
    assert tracing.counter("kernel.a.launches") == 3 and tracing.counter("nothing") == 0
    assert tracing.counters("kernel.") == {"kernel.a.launches": 3}
    assert tracing.snapshot()["counters"] == {"kernel.a.launches": 3, "spatial.halo": 1}
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_train_step_spans_under_a_cpu_profiler():
    """One tiny training step under the profiler runs each span of the step
    once (the augmentation twice: the draws and the pair), and the model's
    parts in them; device ms is None on the CPU."""
    from partseg_tpu_torch.bench import build_trainer
    from partseg_tpu_torch.models.partnet import PartNetConfig
    from partseg_tpu_torch.train.config import LossConfig, TrainConfig

    cfg = TrainConfig(model=PartNetConfig(n_parts=2, img_size=16, features=8, depth=1,
                                          app_features=8, decoder_scales=2,
                                          decoder_features=(8, 8), dtype=torch.float32),
                      loss=LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1,
                                      vgg_resolution=None, swap_weight=0.5),
                      global_batch=2)
    state, period, batches, _ = build_trainer(cfg, 2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        period(state, batches, 0)
    spans = tracing.snapshot()["spans"]
    calls = {k: v["calls"] for k, v in spans.items()}
    assert calls == {"train.step": 1, "train.augment": 2, "train.model": 1,
                     "train.perceptual": 1, "train.equivariance": 1, "train.swap": 1,
                     "train.backward": 1, "train.optimizer": 1,
                     "partnet.shape_encoder": 2, "partnet.appearance_encoder": 1,
                     "partnet.decoder": 2}
    assert all(v["device_ms"] is None for v in spans.values())


def test_spatial_step_spans_and_collective_counters(tmp_path):
    """One spatial step (``train.loop.build_step_fn`` on 1 data × 2 space gloo
    ranks, tests/_torch_dist_child.py) under a CPU profiler records each
    ``train.*`` span and ``dist.grad_reduce`` once, and the counters of the
    collectives match their spans' calls."""
    import json

    import numpy as np

    from _torch_dist_child import launch
    from h100_bench import program
    from h100_bench import run as bench
    from h100_bench.tests import tiny

    cfg = json.loads((bench.BENCH_DIR / "configs" / "celeba256_spatial.json").read_text())
    cfg["model"].update(tiny.TINY_MODEL)
    cfg["loss"].update(tiny.TINY_LOSS)
    seed, b = 5, 2
    images = program.image_pool(1, b, cfg["model"]["img_size"], seed, "cpu")[0]
    np.savez(tmp_path / "inputs.npz", config=np.asarray(json.dumps(cfg)), seed=np.asarray(seed),
             space=np.asarray(2), images=images.numpy(), aug_id=np.arange(b),
             profile=np.asarray(True))
    for rank in launch("bench", 2, tmp_path / "inputs.npz", tmp_path / "out", timeout=120):
        registry = json.loads(str(rank["program/registry"]))
        calls, counters = registry["calls"], registry["counters"]
        assert {k: v for k, v in calls.items() if k.startswith("train.")} == {
            "train.step": 1, "train.augment": 1, "train.model": 1, "train.perceptual": 1,
            "train.equivariance": 1, "train.swap": 1, "train.backward": 1,
            "train.optimizer": 1}
        assert calls["dist.grad_reduce"] == counters["dist.grad_reduce"] == 1
        for name in ("spatial.halo", "spatial.reduce"):
            assert counters[name] == calls[name] > 0, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' device time is read there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_device_ms_agrees_with_the_profilers_ranges(card, monkeypatch):
    """One training step at a tiny size: each span's device ms from the
    registry is within 2 % of the device-side range the profiler gives the
    same record_function span (summed over its calls).

    The two read the same interval only where the card is ahead of the host
    at the span's edges: the registry's events then fire as the stream
    reaches them, as the span's first and last kernels do. At a tiny size
    the card waits on the host, and the registry also counts that wait at
    each edge (some 45 µs a call, 3 % of a shape encoding, in an unpadded
    run). The profiler gives a span the range of the kernels launched while
    it is the innermost span. So each span is padded on the card, around
    the registry's code: a sleep before it (the card busy while the host
    enters it), a short sleep as its own first kernel, and a sleep as its
    own last kernel (the card busy while the host records the end)."""
    from partseg_tpu_torch.bench import build_trainer
    from partseg_tpu_torch.models.partnet import PartNetConfig
    from partseg_tpu_torch.train.config import LossConfig, TrainConfig

    cfg = TrainConfig(model=PartNetConfig(n_parts=4, img_size=64, features=32, depth=2,
                                          app_features=16, decoder_scales=3,
                                          decoder_features=(32, 16, 8)),
                      loss=LossConfig(swap_weight=0.5), global_batch=8)
    state, period, batches, _ = build_trainer(cfg, 8, device="cuda")
    state, _ = period(state, batches, 0)
    torch.cuda.synchronize()
    enter, leave = tracing.span.__enter__, tracing.span.__exit__
    lead = int(1e6)                                   # about half a millisecond of the card

    def padded_enter(self):
        torch.cuda._sleep(lead)
        out = enter(self)
        torch.cuda._sleep(1)
        return out

    def padded_exit(self, *exc):
        torch.cuda._sleep(lead)
        return leave(self, *exc)

    monkeypatch.setattr(tracing.span, "__enter__", padded_enter)
    monkeypatch.setattr(tracing.span, "__exit__", padded_exit)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = period(state, batches, 0)
        torch.cuda.synchronize()
    spans = tracing.snapshot()["spans"]
    ranges: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.is_user_annotation:
            ranges[e.name] = ranges.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    compared = {name: (s["device_ms"], ranges.get(name)) for name, s in spans.items()}
    assert set(spans) == {"train.step", "train.augment", "train.model", "train.perceptual",
                          "train.equivariance", "train.swap", "train.backward",
                          "train.optimizer", "partnet.shape_encoder",
                          "partnet.appearance_encoder", "partnet.decoder"}, compared
    for name, (registry, profiler) in compared.items():
        assert profiler is not None and abs(registry - profiler) <= 0.02 * profiler, compared


@pytest.mark.cuda
def test_span_inside_a_cuda_graph_capture(card):
    """A span entered while the stream captures records no event, and the
    captured graph replays."""
    x = torch.ones(1024, device=card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2                        # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with mock.patch.object(tracing, "_profiler_on", lambda: True):
        with torch.cuda.graph(graph):
            with tracing.span("captured"):
                y = x * 2
    x.fill_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 6.0))
    assert tracing.snapshot()["spans"] == {"captured": {"calls": 1, "device_ms": None}}
