"""Spreads of a cell's runs, for setting and checking the end-to-end bounds.

    python3 acxbench/spread.py <set A's outputs> -- <set B's outputs>

Each output is a file whose last line is one run's result line. Prints,
per metric, each set's median and spread (the distance between the first
and third quartiles of ``statistics.quantiles(values, n=4)``, as a share
of the median), each set's spread with its run farthest from the median
left out, and five times the wider spread (a bound is never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def read(paths: List[str]) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for p in paths:
        with open(p) as f:
            line = f.read().strip().splitlines()[-1]
        for name, m in json.loads(line)["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv) -> int:
    cut = argv.index("--")
    sets = [read(argv[:cut]), read(argv[cut + 1:])]
    for name in sorted(sets[0]):
        a, b = sets[0][name], sets[1].get(name, [])
        if len(a) < 3 or len(b) < 3:
            continue
        sa, sb = spread(a), spread(b)
        ta, tb = spread(trimmed(a)), spread(trimmed(b))
        print(f"{name}: median {statistics.median(a):.6g} / "
              f"{statistics.median(b):.6g}, spread {sa:.4f} / {sb:.4f}, "
              f"trimmed {ta:.4f} / {tb:.4f}, 5x wider "
              f"{max(0.01, 5 * max(sa, sb)):.4f}, median shift "
              f"{statistics.median(b) / statistics.median(a) - 1:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
