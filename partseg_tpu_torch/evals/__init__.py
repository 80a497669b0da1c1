"""Serving entry points: batched inference, single-image inference and
appearance transfer (the JAX package's evals/export, infer, transfer)."""

from partseg_tpu_torch.evals.infer import infer_image, make_infer_fn
from partseg_tpu_torch.evals.transfer import transfer, transfer_batch

__all__ = ["make_infer_fn", "infer_image", "transfer", "transfer_batch"]
