"""Host input-pipeline feed rate, the port's twin of tools/feed_bench.py.

The train bench feeds device-resident tensors; real training must DECODE
its images on the host. This measures what the host pipeline sustains
against what the card consumes:

  1. generates N synthetic JPEGs on disk (CelebA-like 178×218, q90),
  2. runs the port's loader end to end per backend (``data/loader.py``
     ``make_loader`` and its ``prefetch`` thread): ``native`` is the C++
     decode pool (``partseg_native``, uint8 images; its library is built
     with ``partseg_native/build.sh`` at first use), ``grain`` the loader's
     thread pool over the dataset's ``__getitem__`` (cv2 decode, crop,
     resize; the port keeps the JAX backend's name),
  3. prints one JSON line per backend with the JAX tool's keys: batches/s,
     img/s, and the ratio to the demand ``--demand`` img/s per card ×
     ``--chips``.

``--demand`` has no default: pass the card's training rate (for example
``python -m partseg_tpu_torch.bench``'s value). A backend that cannot run
on this host prints its own line with ``"error"`` and the tool exits 1.
Host only: no card is touched.

    python -m partseg_tpu_torch.tools.feed_bench --demand IMG_S [--chips 1]
        [--backends native,grain] [--n_images 10000] [--src_wh 178x218]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import tempfile
import time

import numpy as np

BACKENDS = ("native", "grain")


def generate_images(out_dir: pathlib.Path, n: int, seed: int = 0,
                    wh: tuple = (178, 218)) -> list:
    """Synthetic JPEGs at a given source resolution: smooth
    low-frequency content (decode cost is resolution-, not content-,
    dominated; smooth content keeps file sizes in the real-photo
    range). Default 178x218 = CelebA aligned; use --src_wh to model
    DeepFashion (750x1101) or H36M (1000x1000) frames."""
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [out_dir / f"{i:06d}.jpg" for i in range(n)]
    if all(p.exists() for p in paths):
        return paths
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:wh[1], 0:wh[0]].astype(np.float32)
    for i, p in enumerate(paths):
        f = rng.uniform(0.01, 0.05, 6)
        ph = rng.uniform(0, 6.28, 6)
        img = np.stack(
            [
                127 + 120 * np.sin(f[2 * c] * xx + ph[2 * c])
                * np.cos(f[2 * c + 1] * yy + ph[2 * c + 1])
                for c in range(3)
            ],
            axis=-1,
        ).astype(np.uint8)
        cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return paths


def bench_backend(dataset, backend: str, batch: int, n_batches: int, warmup: int,
                  num_workers: int) -> dict:
    from partseg_tpu_torch.data.loader import make_loader, prefetch

    it = prefetch(
        make_loader(
            dataset, batch, seed=0, num_workers=num_workers, backend=backend,
            process_index=0, process_count=1,
        )
    )
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(it)
    dt = time.perf_counter() - t0
    if b["image"].shape[1:] != (dataset.size, dataset.size, 3):
        raise RuntimeError(f"{backend}: batch of shape {b['image'].shape}")
    return {
        "backend": backend,
        "dtype": str(b["image"].dtype),
        "batches_per_s": round(n_batches / dt, 2),
        "img_per_s": round(n_batches * batch / dt, 1),
    }


def _failure(e: Exception) -> str:
    """Why a backend could not run: the exception and, for a failed
    build, the end of the compiler's output."""
    msg = f"{type(e).__name__}: {e}"
    if isinstance(e, subprocess.CalledProcessError):
        out = (e.stderr or b"") + (e.stdout or b"")
        msg += " | " + (out.decode(errors="replace") if isinstance(out, bytes) else out)[-600:]
    return msg


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "partseg_feed_bench"))
    ap.add_argument("--n_images", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batches", type=int, default=150)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--workers", type=int, default=8,
                    help="thread-pool workers; the native pool uses 2x this")
    ap.add_argument("--demand", type=float, required=True,
                    help="the card's training img/s the pipeline must match")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--backends", default="native,grain")
    ap.add_argument("--src_wh", default="178x218",
                    help="source JPEG resolution WxH (e.g. 750x1101 for "
                         "DeepFashion-class frames)")
    ap.add_argument("--scaled_decode", default=None, choices=(None, "0", "1"),
                    help="force the native pool's N/8 DCT-scaled decode "
                         "on/off for an A/B (default: env/On)")
    args = ap.parse_args(argv)
    backends = args.backends.split(",")
    unknown = sorted(set(backends) - set(BACKENDS))
    if unknown:
        ap.error(f"unknown backends {unknown}; known: {list(BACKENDS)}")

    from partseg_tpu_torch.data.base import ImageListDataset

    if args.scaled_decode is not None:
        os.environ["PARTSEG_SCALED_DECODE"] = args.scaled_decode
    w, h = (int(v) for v in args.src_wh.split("x"))
    sub = pathlib.Path(args.dir) / f"{w}x{h}"
    paths = generate_images(sub, args.n_images, wh=(w, h))
    ds = ImageListDataset(paths=paths, size=args.size)
    demand = args.demand * args.chips
    rows = []
    for backend in backends:
        common = dict(src_wh=args.src_wh,
                      scaled_decode=os.environ.get("PARTSEG_SCALED_DECODE", "1"),
                      metric="host_feed_rate", unit="img/s/host", demand_img_per_s=demand,
                      n_images=args.n_images, batch=args.batch, workers=args.workers)
        try:
            r = bench_backend(ds, backend, args.batch, args.batches, args.warmup, args.workers)
        except (OSError, subprocess.CalledProcessError) as e:
            r = {"backend": backend, **common, "error": _failure(e)}
        else:
            cores = os.cpu_count() or 1
            r.update(
                **common,
                vs_demand=round(r["img_per_s"] / demand, 3),
                host_cores=cores,
                img_per_s_per_core=round(r["img_per_s"] / cores, 1),
                cores_needed_at_this_rate=round(demand / (r["img_per_s"] / cores), 1),
            )
        print(json.dumps(r), flush=True)
        rows.append(r)
    failed = [r["backend"] for r in rows if "error" in r]
    if failed:
        raise SystemExit(f"feed_bench: backends {failed} could not run on this host")
    return rows


if __name__ == "__main__":
    main()
