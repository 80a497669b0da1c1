"""Training: configs, the optimizer and state, the train step, and the loop
(``loop.train``, ``cli``) with its checkpoints and metrics."""

from partseg_tpu_torch.train.config import (
    LossConfig,
    OptimConfig,
    TrainConfig,
    apply_overrides,
)
from partseg_tpu_torch.train.state import OptState, TrainState, create_state, make_optimizer
from partseg_tpu_torch.train.step import (
    build_perceptual,
    compose_period,
    compose_scan,
    make_loss_fn,
    make_train_period,
    make_train_step,
)

__all__ = [
    "LossConfig",
    "OptimConfig",
    "OptState",
    "TrainConfig",
    "TrainState",
    "apply_overrides",
    "build_perceptual",
    "compose_period",
    "compose_scan",
    "create_state",
    "make_loss_fn",
    "make_optimizer",
    "make_train_period",
    "make_train_step",
]
