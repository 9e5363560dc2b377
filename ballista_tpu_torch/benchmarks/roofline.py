"""Roofline table of the port's operators (port of scripts/roofline.py).

Runs each query through the TPC-H runner (`python -m
ballista_tpu_torch.benchmarks.runner`, one process per query) with
BALLISTA_PIECE_TIMING=1, the per-piece profiler of `exec.plan`: every
join, aggregate and window output of the plan is a piece, timed alone on
its inputs over 5 repeats, with the bytes it must move at its live rows
and the share of the HBM rate (`BALLISTA_HBM_GBPS`, default the H100
SXM's 3350) that those bytes over its time reach. The stderr lines are
reduced to one row per piece, the last (warm) line of each, with its
bound (floor bytes at the HBM rate), and printed sorted by time, so the
operator furthest from its bound comes first; the rows go to `--out` as
JSON. A query whose runner fails, or that prints no piece line, makes
the script exit 1 after the others ran.

Usage:
  python -m ballista_tpu_torch.benchmarks.roofline --sf 1 \\
      --queries 1,3,6,9 --out build/roofline.json [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from ..exec.plan import hbm_bytes_per_s

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LINE = re.compile(r"# piece (\S+)\s+(\S+)\s+([0-9.]+) ms\s+\((\d+) rows, "
                  r"\s*([0-9.]+) MiB,\s*([0-9.]+) GiB/s,\s*([0-9.]+)% "
                  r"roofline\)(?: cap ([0-9.]+) MiB)?")


def parse(stderr: str, q: int) -> list:
    """One row per piece of query `q`: the last line each piece printed."""
    seen = {}
    for m in LINE.finditer(stderr):
        key, label, ms, n, mib, gibps, pct, cap = m.groups()
        seen[key] = {"query": q, "piece": key, "op": label, "ms": float(ms),
                     "rows": int(n), "mib": float(mib),
                     "cap_mib": None if cap is None else float(cap),
                     "gibps": float(gibps), "roofline_pct": float(pct),
                     "bound_ms": float(mib) * 2 ** 20 / hbm_bytes_per_s()
                     * 1e3}
    return list(seen.values())


def run_query(q: int, sf: float, iterations: int, device: str):
    """(rows, the runner's stdout line for q or None, its exit code)."""
    env = dict(os.environ, BALLISTA_PIECE_TIMING="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.benchmarks.runner",
         "--sf", str(sf), "--queries", str(q),
         "--iterations", str(iterations), "--device", device],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=7200)
    done = [l for l in p.stdout.splitlines() if l.startswith(f"q{q:2d}")]
    rc = p.returncode
    if done and "ERROR" in done[-1]:
        rc = rc or 1
    if rc:
        sys.stderr.write(p.stderr[-4000:])
    return parse(p.stderr, q), (done[-1] if done else None), rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1)
    ap.add_argument("--queries", default="1,3,6,9")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--out", default="build/roofline.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rows, failed = [], []
    for q in [int(x) for x in args.queries.split(",")]:
        got, done, rc = run_query(q, args.sf, args.iterations, args.device)
        print(done or f"q{q}: rc={rc}", flush=True)
        if rc or not got:
            failed.append(q)
        rows.extend(got)

    rows.sort(key=lambda r: -r["ms"])
    print(f"{'query':>5} {'piece':>10} {'op':20} {'ms':>9} {'bound ms':>9} "
          f"{'MiB':>9} {'cap MiB':>9} {'GiB/s':>8} {'%roof':>6}")
    for r in rows:
        cap = "-" if r["cap_mib"] is None else f"{r['cap_mib']:9.1f}"
        print(f"q{r['query']:>4} {r['piece']:>10} {r['op']:20} "
              f"{r['ms']:9.2f} {r['bound_ms']:9.3f} {r['mib']:9.1f} "
              f"{cap:>9} {r['gibps']:8.1f} {r['roofline_pct']:6.1f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"# wrote {args.out} ({len(rows)} pieces)")
    if failed:
        print(f"# no pieces or a failed run for queries {failed}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
