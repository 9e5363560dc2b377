#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size,
outside the benchmark's runs.

    python3 gpubench/control.py --workload <name> --seeds 1,2,3 [--device cuda]

For each seed it generates the cell's tables, computes every query of the
mix with the plain reference and with its control (the same reference
one precision step lower: decimal sums accumulated in float64, float
aggregates in float32), puts the control's answers in the program's
place and judges them as a run judges the program's. It prints one JSON
line per seed: the compared numbers, per query and in all. The program's
own readings come from the runs of `run.py` (their `checks`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, device: str) -> dict:
    from gpubench import spec
    from gpubench.answer import as_program_cols, compare
    data = spec.module("data", cell.config["family"])
    reference = spec.module("reference", cell.config["family"])
    tables = data.generate(cell.config, seed)
    sound = reference.Reference(tables, device)
    lower = reference.Reference(tables, device, control=True)
    per, wrong, err = {}, 0, 0.0
    for q in dict.fromkeys(cell.traffic["order"]):
        v = compare(as_program_cols(lower.answer(q)), sound.answer(q), device)
        per[q] = {"wrong_cells": v.wrong_cells, "float_err": v.float_err}
        wrong += v.wrong_cells
        err = max(err, v.float_err)
    return {"seed": seed, "wrong_cells": wrong, "float_err": err,
            "queries": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpubench import spec
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = readings(cell, seed, args.device)
        out["seconds"] = round(time.time() - t0, 3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
