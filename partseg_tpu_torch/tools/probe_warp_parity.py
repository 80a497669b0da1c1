"""The warp kernels against the plain gather warp on a smooth image, the
port's twin of tools/probe_warp_parity.py.

    python -m partseg_tpu_torch.tools.probe_warp_parity [--cpu]

A smooth 4 × 128² × 3 f32 image (y, x, y·x over [0, 1]²) is warped by
four draws of the grid-5 TPS sampler three ways: the plain gather warp
(``TPSSampler.flow_field``, then ``warp_image(impl="gather")``), the
``tps_warp`` kernel (flow and sample fused) and the ``bilinear_sample``
kernel on the explicit flow (``warp_image(impl="fused")``). Prints the
JAX tool's lines — the tps_warp kernel's max and mean error, its worst
pixel, its interior (2 px in from the border) max and mean, its row and
column max profiles, and the explicit-flow kernel's max and mean — and
then one JSON line with the same numbers. It runs on the card unless
--cpu (where both kernels' wrappers run their plain versions).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(device=None) -> dict:
    from partseg_tpu_torch.augment.tps import TPSSampler
    from partseg_tpu_torch.device import default_device
    from partseg_tpu_torch.partops.kernels import tps_warp
    from partseg_tpu_torch.partops.warp import warp_image

    dev = default_device(device)
    sampler = TPSSampler(grid_size=5)
    params = sampler.sample(torch.Generator(device=dev).manual_seed(1), 4)
    basis = sampler.flow_basis(128, 128, dev)

    lin = torch.linspace(0, 1, 128, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    smooth = torch.stack([yy, xx, yy * xx], -1)[None].expand(4, 128, 128, 3).contiguous()
    flow = sampler.flow_field(params, 128, 128)
    ws = warp_image(smooth, flow, impl="gather").cpu().numpy()
    fs = tps_warp(smooth, params.weights.contiguous(), basis).cpu().numpy()
    err = np.abs(ws - fs)
    print("smooth: max", err.max(), "mean", err.mean(), flush=True)
    bad = np.argwhere(err == err.max())[0]
    print("worst at (b,y,x,c):", bad, flush=True)
    inner = err[:, 2:-2, 2:-2, :]
    print("interior max:", inner.max(), "interior mean:", inner.mean(), flush=True)
    col_prof = err.max(axis=(0, 1, 3))
    row_prof = err.max(axis=(0, 2, 3))
    print("row max profile (first/last 5):", row_prof[:5], row_prof[-5:], flush=True)
    print("col max profile (first/last 5):", col_prof[:5], col_prof[-5:], flush=True)

    # The explicit-flow kernel against the gather (isolates the in-kernel TPS).
    wf = warp_image(smooth, flow, impl="fused").cpu().numpy()
    e2 = np.abs(ws - wf)
    print("explicit-flow fused vs gather: max", e2.max(), "mean", e2.mean(), flush=True)
    result = {
        "metric": "warp_parity", "device": str(dev),
        "tps_warp": {"max": float(err.max()), "mean": float(err.mean()),
                     "worst_bycx": bad.tolist(), "interior_max": float(inner.max()),
                     "interior_mean": float(inner.mean()),
                     "row_max_first_last5": row_prof[:5].tolist() + row_prof[-5:].tolist(),
                     "col_max_first_last5": col_prof[:5].tolist() + col_prof[-5:].tolist()},
        "bilinear_sample": {"max": float(e2.max()), "mean": float(e2.mean()),
                            "interior_max": float(e2[:, 2:-2, 2:-2, :].max())},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    main(device="cpu" if ap.parse_args().cpu else None)
