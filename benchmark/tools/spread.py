"""Spreads and readings of a series of runs (``series.py``'s results.jsonl).

    python3 benchmark/tools/spread.py DIR/results.jsonl [...] [--sets N]

For each cell and end-to-end metric: the median and the spread (the
distance between the first and third quartiles by ``statistics.quantiles(
values, n=4)``, as a share of the median) of each set of ``N`` consecutive
untraced runs, and five times the wider spread, the bound it suggests; for
each number that decides ``correct``, the largest reading of any run (the
lower reading a limit sits above); and every run's ``setup_s``.
"""

from __future__ import annotations

import argparse
import json
import statistics
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+")
    p.add_argument("--sets", type=int, default=6)
    a = p.parse_args()
    runs = defaultdict(list)
    for path in a.files:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                runs[r["cell"]].append(r)
    for cell, rs in runs.items():
        ok = [r for r in rs if r["result"]]
        print(f"== {cell}: {len(rs)} runs, {len(ok)} with a result, "
              f"{sum(r['result']['correct'] for r in ok)} correct")
        plain = [r for r in ok if not r["trace"]]
        sets = [plain[i:i + a.sets] for i in range(0, len(plain), a.sets)]
        metrics = sorted({m for r in plain for m in r["result"]["metrics"]})
        for m in metrics:
            rows = []
            for s in sets:
                vals = [r["result"]["metrics"][m]["value"] for r in s]
                if len(vals) >= 2:
                    rows.append((statistics.median(vals), spread(vals) if len(vals) >= 3 else None))
            widest = max((sp for _, sp in rows if sp is not None), default=None)
            print(f"  {m}: " + "; ".join(
                f"median {med:.6g} spread {sp if sp is None else round(sp, 5)}" for med, sp in rows)
                + ("" if widest is None else f"  -> 5x widest {5 * widest:.4f}"))
        checks = defaultdict(list)
        for r in ok:
            for n, c in r["result"]["checks"].items():
                checks[n].append(float(c["value"]))
        for n, vals in checks.items():
            print(f"  check {n}: max {max(vals):.6g} over {len(vals)} runs; "
                  f"sorted {[float(f'{v:.3g}') for v in sorted(vals)]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
