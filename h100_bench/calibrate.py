"""The readings that the correctness limits are set from: a cell's check on
many seeds and variants in one process (one build, one start-up).

    python3 -m h100_bench.calibrate --workload <cell> --seeds 1,2,3 \
        [--variants program,control] [--seconds 2] [--out FILE]

prints one JSON line per (variant, seed) with every number compared, and
appends it to ``--out``. Not one of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from h100_bench import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import torch

    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = bench.run(args.workload, seed, args.seconds, False, variant)
            line = json.dumps({"workload": args.workload, "variant": variant, "seed": seed,
                               "correct": r["correct"], "metrics": r["metrics"],
                               "checks": {k: c["value"] for k, c in r["checks"].items()},
                               "detail": r["detail"]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del r
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
