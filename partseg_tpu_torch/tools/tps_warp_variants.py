"""Time copies of ``csrc/tps_warp.cu`` against each other on one CUDA card.

    python -m partseg_tpu_torch.tools.tps_warp_variants A.cu B.cu ... [--stamp B.cu]
        [--grid 5]

Each source is a full copy of ``tps_warp.cu`` (say an earlier checkout's and
an edited one), built on its own with ``nvcc`` into ``build/variants/``. On
the speed128 warp head (32 images of 128²×3, the seeded draws of
``chip_smoke.py``; at ``--grid`` other than 5, the same images with that
TPS grid's weights and basis: grid 20 and 15 take the wide path) every
copy's output must equal the first's bit for bit, unbanded and at band
kh = 56 and 40, f32 and bf16. Then each copy's device time per call
(torch.profiler) at kh = 0 and 56 is printed, in the order A, B, ..., ...,
B, A. ``--stamp`` builds a copy with ``%globaltimer`` stamps at the phase
boundaries of this checkout's kernels and prints, per phase, the minimum,
median and maximum over the CTAs of one call, in ns: for the narrow path
start, basis staged, flow done, band start known, end (phases staged,
flow, band, pass2); for the wide path start, first chunk landed, flow
done (unbanded: with every sample, taken from registers), band start
known, end (phases first_chunk, flow, band, pass2).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from partseg_tpu_torch.augment import TPSSampler
from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.kernels.tps_warp import band_config, pad_columns

OUT = _build.BUILD_DIR.parent / "variants"

STAMPS = '''
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
extern "C" void tps_stamps(unsigned long long* h, int n) { cudaMemcpyFromSymbol(h, g_stamps, n * 8); }
'''
# (anchor in tps_warp.cu, text put before it)
STAMP_POINTS = [
    ("namespace {\n", STAMPS),
    ("  // Pass 1: the flow", "  unsigned long long t0 = gtimer(), t1 = t0;\n"),
    ("    if (lane < cnt) {\n", "    t1 = gtimer();\n"),
    ("  // Band mode: the tile's minimum", "  __syncthreads();\n  unsigned long long t2 = gtimer();\n"),
    ("  // Pass 2:", "  unsigned long long t3 = gtimer();\n"),
    ("  if constexpr (kBanded) cg::this_cluster().sync();   // no CTA leaves",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
     "    const int id = (blockIdx.y * gridDim.x + blockIdx.x) * 5;\n"
     "    if (id + 5 <= (1 << 16)) {\n"
     "      g_stamps[id] = t0; g_stamps[id + 1] = t1; g_stamps[id + 2] = t2;\n"
     "      g_stamps[id + 3] = t3; g_stamps[id + 4] = gtimer();\n    }\n  }\n"),
]
WIDE_STAMP_POINTS = [
    ("  // Pass 1, in runs of kRun points", "  unsigned long long t0 = gtimer(), t1 = t0;\n"),
    ("      const float4* buf = ring4 + (ch % V::kStages) * (kStage / 4) + row0;\n",
     "      if (ch == 0 && c0 == 0) t1 = gtimer();\n"),
    ("  // Band mode: the tile's minimum row per image, over the CTA (a warp",
     "  unsigned long long t2 = gtimer(), t3 = t2;\n"),
    ("  // Pass 2: a thread per point", "  t3 = gtimer();\n"),
    ("\n}\n\ntemplate <typename T, int kC, bool kBanded>\ncudaError_t launch_mode",
     "\n" + STAMP_POINTS[-1][1].rstrip("\n")),
]
PHASES = {False: ("staged", "flow", "band", "pass2"),
          True: ("first_chunk", "flow", "band", "pass2")}


def stamped(text: str) -> str:
    for anchor, add in STAMP_POINTS + WIDE_STAMP_POINTS:
        if anchor not in text:
            raise SystemExit(f"--stamp: anchor {anchor!r} not in the source")
        text = text.replace(anchor, add + anchor, 1)
    return text


def grid_inputs(gen, grid: int):
    """The speed128 warp head (images, weights, basis) at TPS grid ``grid``,
    the basis rows padded to 16 bytes as TPSSampler.warp passes them."""
    img, weights, basis, _ = cs.warp_inputs(gen)
    if grid == 5:
        return img, weights, basis
    sampler = TPSSampler(grid_size=grid)
    weights = sampler.sample(gen, img.shape[0]).weights.contiguous()
    return (img, *pad_columns(weights, sampler.flow_basis(img.shape[1], img.shape[2], "cuda")))


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-I", str(_build.CSRC_DIR), "-shared",
             str(cu), "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in ("partseg_tps_warp", "partseg_tps_warp_plan"):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes, getattr(lib, entry).restype = _build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", type=Path)
    parser.add_argument("--stamp", type=Path, action="append", default=[])
    parser.add_argument("--grid", type=int, default=5, help="TPS grid (M = grid² + 3)")
    args = parser.parse_args()
    sources = {f"v{i}_{p.stem}": p.read_text() for i, p in enumerate(args.sources)}
    sources.update({f"stamped_{p.stem}": stamped(p.read_text()) for p in args.stamp})
    libs = build(sources)
    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 30)
    img, weights, basis = grid_inputs(gen, args.grid)
    for kh in (0, 56, 40):
        cs._with_band(kh)
        for dtype in (torch.float32, torch.bfloat16):
            band, tile = band_config(dtype, 128, 128)
            outs = [cs._tps_launch(libs[n], img.to(dtype), weights, basis, band, tile)
                    for n in names]
            torch.cuda.synchronize()
            for n, o in zip(names, outs):
                if not torch.equal(o, outs[0]):
                    raise SystemExit(f"{n} differs from {names[0]} at kh={kh} {dtype}")
    print(json.dumps({"bits": "equal", "variants": names, "grid": args.grid,
                      "m": weights.shape[1]}), flush=True)
    im = img.to(torch.bfloat16)
    nw, s = im.shape[0], im.shape[1]
    for kh in (0, 56):
        cs._with_band(kh)
        band, tile = band_config(im.dtype, s, s)
        out = torch.empty_like(im)
        calls = {n: (lambda lib=lib: _build.launch(
            "partseg_tps_warp", im.device, im.data_ptr(), 1, weights.data_ptr(), basis.data_ptr(),
            out.data_ptr(), nw, s, s, 3, weights.shape[1], tile, band, lib=lib))
            for n, lib in libs.items()}
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(cs.device_ms(calls[n]))
        print(json.dumps({"kh": kh, "device_ms": ms, "nvidia_smi": cs.nvidia_smi_line()}),
              flush=True)
        for n in (n for n in names if n.startswith("stamped_")):
            calls[n]()
            torch.cuda.synchronize()
            plan = (ctypes.c_int * 7)()
            libs[n].partseg_tps_warp_plan(nw, s, s, weights.shape[1], tile, band, plan)
            ctas = plan[3] * plan[4]
            buf = (ctypes.c_ulonglong * (5 * ctas))()
            libs[n].tps_stamps(buf, 5 * ctas)
            st = [buf[5 * i:5 * i + 5] for i in range(ctas)]
            t0 = min(x[0] for x in st)

            def spread(v):
                v = sorted(v)
                return [v[0], v[len(v) // 2], v[-1]]
            row = {"start": spread([x[0] - t0 for x in st]), "end": spread([x[4] - t0 for x in st])}
            phases = PHASES[plan[6] < weights.shape[1]]
            row.update({ph: spread([x[i + 1] - x[i] for x in st]) for i, ph in enumerate(phases)})
            print(json.dumps({"stamps": n, "kh": kh, "ctas": ctas, "ns_min_median_max": row}),
                  flush=True)
    cs._with_band(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
