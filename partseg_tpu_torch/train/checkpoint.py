"""Checkpoint and resume on ``torch.save``, with the semantics of the JAX
package's Orbax ``CheckpointManager`` (partseg_tpu/train/checkpoint.py).

- ``save(step, state)`` writes when ``step`` is a multiple of
  ``save_every`` and newer than the latest checkpoint; ``force=True``
  writes regardless, unless that step is already the latest.
- The newest ``keep`` checkpoints stay; older ones are deleted.
- ``restore_latest`` loads the newest into a state of the same model.
- Saves are asynchronous: the state is copied to the host at once (the
  step updates it in place), and the file is written by a thread;
  ``wait`` joins it.

A checkpoint is ``<run dir>/checkpoints/<step>.pt``: the model's
``state_dict``, the Adam moments ``mu`` and ``nu``, the optimizer's update
``count`` and the ``step``. It is written under a temporary name and
renamed, so a process killed mid-save leaves no half checkpoint behind.
"""

from __future__ import annotations

import os
import pathlib
import threading

import torch

from partseg_tpu_torch.train.state import TrainState


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, save_every: int = 1000):
        self.path = pathlib.Path(directory).absolute() / "checkpoints"
        self.keep = keep
        self.save_every = save_every
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def all_steps(self) -> list[int]:
        if not self.path.is_dir():
            return []
        return sorted(int(p.stem) for p in self.path.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Save ``state`` as the checkpoint of ``step``; returns whether it did."""
        self.wait()
        latest = self.latest_step()
        if force:
            if latest == step:
                return False            # already saved by the interval policy
        elif (latest is not None and latest >= step) or step % self.save_every:
            return False
        payload = {"step": int(step), "count": int(state.opt_state.count),
                   "model": _host(state.model.state_dict()),
                   "mu": _host(state.opt_state.mu), "nu": _host(state.opt_state.nu)}
        self._writer = threading.Thread(target=self._write, args=(step, payload), daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, payload: dict) -> None:
        try:
            self.path.mkdir(parents=True, exist_ok=True)
            final = self.path / f"{step}.pt"
            tmp = self.path / f".{step}.pt.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.keep] if self.keep else []:
                (self.path / f"{old}.pt").unlink(missing_ok=True)
        except BaseException as e:     # re-raised by wait() in the training thread
            self._error = e

    def restore_latest(self, state: TrainState) -> tuple[TrainState, int] | None:
        """Load the newest checkpoint into ``state`` (its model, moments,
        count and step, in place). Returns (state, step), or None if there
        is no checkpoint."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(state, step), step

    def restore(self, state: TrainState, step: int) -> TrainState:
        """Load the checkpoint of ``step`` into ``state``, in place."""
        self.wait()
        ckpt = torch.load(self.path / f"{step}.pt", map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        with torch.no_grad():
            for name in ("mu", "nu"):
                moments = getattr(state.opt_state, name)
                if set(moments) != set(ckpt[name]):
                    raise ValueError(f"checkpoint {step}: its {name} does not match the model")
                for k, v in moments.items():
                    v.copy_(ckpt[name][k])
        state.opt_state.count = ckpt["count"]
        state.step = ckpt["step"]
        return state

    def wait(self) -> None:
        """Block until the last save is on disk; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()
