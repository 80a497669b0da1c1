"""partseg_tpu_torch — the PyTorch/CUDA port of partseg_tpu.

The JAX package ``partseg_tpu`` stays the reference; this package keeps
its module names so each module's counterpart is easy to find, and
imports nothing of it (nor of JAX). Every Pallas kernel on a ported path
is a CUDA C++ kernel written for Hopper (``csrc/``), built with ``nvcc``
at first use; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.

Layering (mirrors partseg_tpu):
  partops/  — part ops (plain torch) + kernels/ (CUDA wrappers, autograd Functions)
  models/   — hourglass encoders + image decoder (nn.Module)
  augment/  — TPS sampler, colour jitter, paired augmentation
  losses/   — VGG perceptual and TPS equivariance losses
  train/    — configs, optax-semantics optimizer, the train step and period,
              the loop, checkpoints, metrics and the CLI
  dist/     — the process group, the (data, space) mesh, gradient averaging
  parallel/ — spatial sharding: the image rows of a data shard over ranks
  evals/    — serving entry points: make_infer_fn, infer_image, transfer
  tools/    — the JAX package's tools/ scripts: validation, the quality
              study, tracing, component, serving and feed benches
  configs   — model and train presets; convert — Flax params → state_dict
  bench     — train-step throughput on the card
  tracing   — spans and counters, in one registry

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``device.default_device``). Importing the package
alone does not import torch, so an orchestrator such as
``tools.quality_study`` can run from it without touching the card.
"""

__version__ = "0.1.0"

__all__ = ["default_device"]


def __getattr__(name: str):
    if name == "default_device":
        from partseg_tpu_torch.device import default_device

        return default_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
