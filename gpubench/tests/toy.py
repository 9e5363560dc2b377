"""A copy of the benchmark in a temporary directory with toy cells added
as files, the way a later change adds a configuration, a mix or a
metric; and a run of one cell there, in a process of its own."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TOY_METRIC = '''"""toy_queries: how many queries the window answered."""


def read(rec):
    return float(len(rec.latencies_s))
'''

# a per-layer metric that wraps another entry of the program than the
# kernel's: the plan evaluation, called at least once per collect
TOY_ENTRY_METRIC = '''"""toy_plan_evals: calls of exec.plan.eval_plan in the traced window."""

ENTRY = ("ballista_tpu_torch.exec.plan", "eval_plan")


def call_bytes(*args, **kwargs):
    return 0


def read(rec):
    e = rec.entries.get("toy_plan_evals")
    return None if e is None else float(e.calls)
'''


def make(tmp) -> str:
    """tmp/gpubench + tmp/BENCHMARK.json, with the cells toy.tpch (TPC-H
    SF 0.01, a mix of six queries), toy.h2o (h2o at 1e4 rows, every
    question), the end-to-end metric toy_queries and the per-layer metric
    toy_plan_evals, which wraps an entry of the program. Returns the
    directory."""
    base = os.path.join(str(tmp), "bench")
    shutil.copytree(os.path.join(ROOT, "gpubench"),
                    os.path.join(base, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    g = os.path.join(base, "gpubench")

    def put(rel, obj):
        with open(os.path.join(g, rel), "w") as f:
            if isinstance(obj, str):
                f.write(obj)
            else:
                json.dump(obj, f)
    put("configs/toy_tpch.json", {
        "name": "toy_tpch", "family": "tpch", "source": "toy",
        "scale_factor": 0.01, "reduced": ["scale_factor"],
        "limits": {"wrong_cells": 0}})
    put("configs/toy_h2o.json", {
        "name": "toy_h2o", "family": "h2o", "source": "toy", "rows": 1e4,
        "k": 100, "reduced": ["rows"],
        "limits": {"wrong_cells": 0, "float_err": 1e-9}})
    put("traffic/toy_tpch_mix.json", {
        "name": "toy_tpch_mix", "family": "tpch",
        "order": ["q1", "q3", "q13", "q16", "q18", "q21"]})
    put("traffic/toy_h2o_mix.json", {
        "name": "toy_h2o_mix", "family": "h2o",
        "order": [f"q{i}" for i in range(1, 11)]})
    put("metrics/toy_queries.py", TOY_METRIC)
    put("metrics/toy_plan_evals.py", TOY_ENTRY_METRIC)
    bench["configs"] += [
        {"name": "toy_tpch", "source": "toy", "reduced": ["scale_factor"],
         "file": "gpubench/configs/toy_tpch.json", "why": "toy"},
        {"name": "toy_h2o", "source": "toy", "reduced": ["rows"],
         "file": "gpubench/configs/toy_h2o.json", "why": "toy"}]
    bench["workloads"] += [
        {"name": "toy.tpch", "config": "toy_tpch", "traffic": "toy_tpch_mix",
         "chips": 1, "why": "toy"},
        {"name": "toy.h2o", "config": "toy_h2o", "traffic": "toy_h2o_mix",
         "chips": 1, "why": "toy"}]
    bench["end_to_end"].append({"name": "toy_queries", "unit": "queries",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["toy.tpch", "toy.h2o"]})
    bench["per_layer"].append({"name": "toy_plan_evals", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "operators and ops",
                               "moves": "queries_per_s",
                               "workloads": ["toy.tpch"]})
    with open(os.path.join(base, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return base


def run(base, workload, seed=7, seconds=1.0, trace=0, device="cpu",
        prelude="", timeout=600):
    """run.main in a process of its own, with the copy's gpubench first on
    the path and the program after it. `prelude` runs first (a planted
    fault). Returns (exit code, last stdout line as JSON or None, stderr)."""
    code = (f"import sys; sys.path.insert(0, {base!r}); "
            f"sys.path.append({ROOT!r})\n{prelude}\n"
            "from gpubench import run\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device={device!r}))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=base, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, last, p.stderr
