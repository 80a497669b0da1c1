"""Evaluation and serving: landmark regression and segmentation IoU (the
JAX package's evals/), batched and single-image inference, appearance
transfer and the exported inference forward.

Batched forwards on the model's device collect soft-argmax μ; a linear
regressor (Thewlis'17 protocol) maps 2K coordinates → annotated
landmarks; the error is in % of the inter-ocular distance. The GCPR'20
path computes part and foreground IoU from the per-pixel part softmax
argmax.
"""

from partseg_tpu_torch.evals.export import export_infer, load_exported, make_infer_fn
from partseg_tpu_torch.evals.infer import infer_image, load_model_and_params
from partseg_tpu_torch.evals.landmarks import (
    collect_mu,
    evaluate_landmarks,
    fit_landmark_regressor,
    landmark_error,
)
from partseg_tpu_torch.evals.segmentation import evaluate_segmentation, segmentation_iou
from partseg_tpu_torch.evals.transfer import transfer, transfer_batch

__all__ = [
    "collect_mu",
    "fit_landmark_regressor",
    "landmark_error",
    "evaluate_landmarks",
    "segmentation_iou",
    "evaluate_segmentation",
    "make_infer_fn",
    "infer_image",
    "load_model_and_params",
    "transfer",
    "transfer_batch",
    "export_infer",
    "load_exported",
]
