"""Spans and counters of the port, in one registry.

``with span("train.model"):`` marks a part of the program; ``count(name)``
adds to an integer counter. ``snapshot()`` reads both and ``reset()``
clears both.

Turning the spans on. A span is on exactly while ``torch.profiler``
records (``torch.autograd._profiler_enabled()``); there is no other
switch. Run the program under ``torch.profiler.profile``, or set the train
loop's ``profile_steps`` (the spans are on in its window), or run
``python -m partseg_tpu_torch.tools.trace_step``, which prints the span
table after its window. Off, a span reads that flag and does nothing else,
so a ``torch.export`` program, traced with no profiler running, holds
nothing of it (``torch.compile`` would break its graph at a span; the port
compiles nothing).

On, a span

- enters ``torch.profiler.record_function(name)``: the trace shows it on the
  kernels' clock, and its CPU half names the host's work wherever the device
  idles under it;
- records a pair of timing CUDA events on the current stream, taken from a
  pool, where the process has initialised CUDA and the stream is not
  capturing a CUDA graph (on the CPU a span has no device time; a process
  runs on one card, as every entry point of the port does);
- counts the call.

A span's device time is the stream's time from its start event to its end
event: the work issued inside it, and any idle of the device waiting on the
host in between. Nested spans are allowed and each is counted whole; the
registry sums by name. Event pairs are resolved when read; past
``MAX_PENDING`` unread pairs, each new pair resolves the oldest that have
completed (``Event.query``, no wait).

The program's spans: ``train.step`` (make_train_step's step) and within it
``train.augment``, ``train.model``, ``train.perceptual``,
``train.equivariance``, ``train.swap``, ``train.backward`` and
``train.optimizer``; ``serve.infer`` (make_infer_fn's callable) and
``serve.transfer`` (transfer_batch); ``partnet.shape_encoder``,
``partnet.appearance_encoder`` and ``partnet.decoder`` (every call from
PartNet); ``loop.fetch`` (the train loop's fetch and copy of a group of
batches); ``spatial.halo`` and ``spatial.reduce`` (each collective of the
spatial path). Its counters: ``kernel.<name>.launches`` for each hand
kernel's forward launches, ``kernel.render_assemble.backward_launches``,
and ``spatial.halo`` and ``spatial.reduce`` for the collectives.
"""

from __future__ import annotations

import collections
import threading

import torch

MAX_PENDING = 4096

_profiler_on = torch.autograd._profiler_enabled
_lock = threading.Lock()     # spans and counts also come from autograd's device threads
_calls: dict[str, int] = {}
_device_ms: dict[str, float] = {}
_counters: dict[str, int] = {}
_pending: collections.deque = collections.deque()   # (name, start, end)
_pool: list = []                                      # free timing events


def _event() -> torch.cuda.Event:
    with _lock:
        return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


def _resolve(name: str, start, end) -> None:
    ms = start.elapsed_time(end)
    with _lock:
        _device_ms[name] = _device_ms.get(name, 0.0) + ms
        _pool.extend((start, end))


class span:
    """``with span(name):`` — see the module's docstring."""

    __slots__ = ("name", "_record", "_start")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if not _profiler_on():
            return self
        name = self.name
        with _lock:
            _calls[name] = _calls.get(name, 0) + 1
        self._record = torch.profiler.record_function(name)
        self._record.__enter__()
        self._start = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._start = _event()
            self._start.record()
        return self

    def __exit__(self, *exc):
        if self._record is None:
            return False
        if self._start is not None and not torch.cuda.is_current_stream_capturing():
            end = _event()
            end.record()
            _pending.append((self.name, self._start, end))
            while len(_pending) > MAX_PENDING and _pending[0][2].query():
                _resolve(*_pending.popleft())
        record, self._record = self._record, None
        record.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name``; 0 where nothing has counted it."""
    return _counters.get(name, 0)


def counters(prefix: str = "") -> dict[str, int]:
    """Every counter whose name starts with ``prefix``."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def snapshot() -> dict:
    """{"spans": {name: {"calls", "device_ms"}}, "counters": {name: n}}.
    ``device_ms`` sums the span's calls that recorded events, None where
    none did (a CPU run). Waits for the end events of pending spans."""
    while _pending:
        name, start, end = _pending.popleft()
        end.synchronize()
        _resolve(name, start, end)
    with _lock:
        return {"spans": {name: {"calls": n, "device_ms": _device_ms.get(name)}
                          for name, n in _calls.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear every span and counter (pending event pairs are dropped)."""
    with _lock:
        _calls.clear()
        _device_ms.clear()
        _counters.clear()
        _pending.clear()
