"""Run one command in two checkouts in turns: baseline, this, this,
baseline (``--rounds`` repeats the four), so that a drift of the host or
the card over the call falls on both alike.

    python -m partseg_tpu_torch.tools.turns --baseline build/parent \\
        [--rounds 1] [--out DIR] -- python -m partseg_tpu_torch.bench --batch 128

``{run}`` in the command becomes the run's number (1 to 4·rounds), for
a fresh output directory per run. Each run starts in the checkout's root
with ``PYTHONPATH`` set to it, so
``python -m partseg_tpu_torch.…`` runs that checkout's code; an absolute
script path runs one script against either checkout's package. Prints
one JSON line per run (tree, wall seconds of the process, exit code, and
the last JSON object of its standard output), then one line with the
median wall seconds and the median of each number in those objects, per
tree. With ``--out`` each run's output is kept as ``<tree><n>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ORDER = ("baseline", "this", "this", "baseline")


def last_json(text: str) -> dict:
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return {}


def run(command: list[str], root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=root, env=env, capture_output=True, text=True)
    return {"wall_s": time.perf_counter() - t0, "rc": proc.returncode,
            "last": last_json(proc.stdout), "stdout": proc.stdout, "stderr": proc.stderr}


def summary(runs: list[dict]) -> dict:
    out = {}
    for tree in ("baseline", "this"):
        mine = [r for r in runs if r["tree"] == tree]
        row = {"wall_s": statistics.median(r["wall_s"] for r in mine)}
        for key in mine[0]["last"]:
            vals = [r["last"].get(key) for r in mine]
            if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
                row[key] = statistics.median(vals)
        out[tree] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the four turns")
    ap.add_argument("--out", type=Path, default=None, help="keep each run's output here")
    ap.add_argument("command", nargs=argparse.REMAINDER, help="-- then the command")
    a = ap.parse_args(argv)
    command = a.command[1:] if a.command[:1] == ["--"] else a.command
    if not command:
        ap.error("no command after --")
    roots = {"baseline": a.baseline.resolve(), "this": Path(__file__).resolve().parents[2]}
    if a.out:
        a.out.mkdir(parents=True, exist_ok=True)
    runs, seen = [], {"baseline": 0, "this": 0}
    for i, tree in enumerate(ORDER * a.rounds, 1):
        seen[tree] += 1
        r = run([c.replace("{run}", str(i)) for c in command], roots[tree])
        if a.out:
            (a.out / f"{tree}{seen[tree]}.txt").write_text(r["stdout"] + "\n--- stderr\n"
                                                           + r["stderr"])
        r = {"tree": tree, "wall_s": r["wall_s"], "rc": r["rc"], "last": r["last"]}
        runs.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"turns": summary(runs), "command": command}), flush=True)
    return max(r["rc"] for r in runs)


if __name__ == "__main__":
    sys.exit(main())
