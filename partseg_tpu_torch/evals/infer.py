"""Single-image inference, the port's twin of partseg_tpu/evals/infer.py:
load a config and a port checkpoint, forward the shape encoder only, and
give part activation maps, soft-argmax landmarks and the argmax part
segmentation, with an overlay for viewing. ``make_infer_fn`` (batched)
lives in ``evals/export.py``, as in the JAX package, and is re-exported
here.

CLI (the CUDA card unless --cpu):
    python -m partseg_tpu_torch.evals.infer --config configs/celeba.py \\
        --ckpt_dir logs/celeba --image face.png --out viz.png [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from partseg_tpu_torch.evals.export import as_images, make_infer_fn, model_device
from partseg_tpu_torch.models.partnet import PartNet, init_weights


def load_model_and_params(cfg, ckpt_dir: str | None,
                          device: str | torch.device | None = None) -> PartNet:
    """PartNet of ``cfg.model`` on ``device`` (the CUDA card unless given),
    seeded as the train loop seeds it, with the newest port checkpoint of
    ``ckpt_dir`` restored when there is one (``train/checkpoint.py``; the
    JAX package's Orbax checkpoints are not readable). The parameters live
    in the returned module, in eval mode."""
    from partseg_tpu_torch.device import default_device
    from partseg_tpu_torch.train.checkpoint import CheckpointManager
    from partseg_tpu_torch.train.state import create_state

    dev = default_device(device)
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=cfg.seed).to(dev)
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir)
        restored = mgr.restore_latest(create_state(cfg, model))
        if restored is not None:
            print(f"[infer] restored step {restored[1]}", flush=True)
        mgr.close()
    return model.eval()


def infer_image(model: PartNet, image) -> dict[str, np.ndarray]:
    """image [H, W, 3] float in [0,1] → numpy outputs for that image:
    heatmaps [h, w, K], seg [h, w], landmarks [K, 2], sigma [K, 2, 2],
    logits [h, w, K(+1)]."""
    out = make_infer_fn(model)(as_images(image, model_device(model))[None])
    return {k: v[0].cpu().numpy() for k, v in out.items()}


def render_overlay(image: np.ndarray, out: dict[str, np.ndarray]) -> np.ndarray:
    """Blend the part segmentation and the landmarks into an RGB view."""
    h, w, _ = image.shape
    seg = out["seg"]
    k = int(seg.max()) + 1
    rng = np.random.default_rng(0)
    palette = np.concatenate(
        [np.zeros((1, 3)), rng.uniform(0.3, 1.0, size=(max(k - 1, 1), 3))]
    )
    seg_rgb = palette[seg]                                     # [h, w, 3]
    sh, sw = seg.shape
    seg_up = np.kron(seg_rgb, np.ones((h // sh, w // sw, 1)))[:h, :w]
    overlay = 0.6 * image + 0.4 * seg_up
    for y, x in out["landmarks"]:
        iy = int((y + 1) * 0.5 * h)
        ix = int((x + 1) * 0.5 * w)
        overlay[max(iy - 2, 0) : iy + 3, max(ix - 2, 0) : ix + 3] = [1.0, 0.0, 0.0]
    return np.clip(overlay, 0, 1)


def read_image(path: str, size: int) -> np.ndarray:
    """An image file → RGB f32 [size, size, 3] in [0, 1] (cv2, area resize)."""
    import cv2

    from partseg_tpu_torch.data.base import load_image

    return cv2.resize(load_image(path), (size, size), interpolation=cv2.INTER_AREA)


def write_image(path: str, rgb: np.ndarray) -> None:
    """RGB in [0, 1] → an image file (cv2)."""
    import cv2

    cv2.imwrite(path, (np.clip(rgb, 0, 1)[..., ::-1] * 255).astype(np.uint8))


def main(argv=None):
    ap = argparse.ArgumentParser(description="partseg_tpu_torch single-image inference")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--image", required=True, help="input image path")
    ap.add_argument("--out", default="infer_out.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    from partseg_tpu_torch.train.config import load_config

    cfg = load_config(args.config)
    model = load_model_and_params(cfg, args.ckpt_dir, device="cpu" if args.cpu else None)
    img = read_image(args.image, cfg.model.img_size)
    out = infer_image(model, img)
    write_image(args.out, render_overlay(img, out))
    print(f"[infer] landmarks:\n{out['landmarks']}")
    print(f"[infer] wrote {args.out}")


if __name__ == "__main__":
    main()
