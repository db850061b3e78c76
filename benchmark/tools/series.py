"""Run cells of the benchmark one after another, each run a process of its
own, and keep every result line.

    python3 benchmark/tools/series.py --out DIR --seconds S [--trace 0|1]
        CELL:SEED[,SEED...] [CELL:SEED...]

Each run's standard output and error go to ``DIR/<cell>.<seed>.<trace>.out``
and ``.err``; the result lines are appended to ``DIR/results.jsonl`` with
the cell, seed and the command's exit code and seconds; a summary line a
run goes to standard output.  Run it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("runs", nargs="+")
    a = p.parse_args()
    os.makedirs(a.out, exist_ok=True)
    bad = 0
    for spec in a.runs:
        cell, seeds = spec.split(":")
        for seed in seeds.split(","):
            base = os.path.join(a.out, f"{cell}.{seed}.{a.trace}")
            cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", seed,
                   "--seconds", str(a.seconds), "--trace", str(a.trace)]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=a.timeout)
                rc, out, err = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, out, err = 124, e.stdout or "", e.stderr or ""
                out = out.decode() if isinstance(out, bytes) else out
                err = err.decode() if isinstance(err, bytes) else err
            dt = time.time() - t0
            with open(base + ".out", "w") as f:
                f.write(out)
            with open(base + ".err", "w") as f:
                f.write(err)
            line = out.strip().splitlines()[-1] if out.strip() else ""
            try:
                res = json.loads(line)
            except ValueError:
                res = None
            readings = next((json.loads(x)["readings"] for x in err.splitlines()
                             if x.startswith('{"readings"')), None)
            rec = {"cell": cell, "seed": int(seed), "trace": a.trace, "rc": rc,
                   "command_s": dt, "result": res, "readings": readings}
            with open(os.path.join(a.out, "results.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
            if res is None:
                bad += 1
                tail = err.strip().splitlines()[-15:]
                print(f"{cell} {seed} rc={rc} {dt:.0f}s NO RESULT\n  " + "\n  ".join(tail))
            else:
                m = {k: round(v["value"], 4) for k, v in res["metrics"].items()}
                c = {k: float(f"{v:.4g}") for k, v in (readings or {}).items()
                     if isinstance(v, (int, float))}
                print(f"{cell} {seed} rc={rc} {dt:.0f}s correct={res['correct']} "
                      f"att={res['attempted']} fail={res['failed']} "
                      f"peak={res['device']['memory_peak_bytes'] / 2**30:.2f}GiB {m} {c}",
                      flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
