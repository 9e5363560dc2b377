"""Smoke test of ballista_tpu_torch on one NVIDIA GPU: builds the port's
CUDA kernel, holds it against its plain PyTorch version, then runs all 22
TPC-H queries at SF1 end to end through SessionContext(device="cuda") and
checks each answer exactly, and a full outer join on each path, UNION
[ALL] and a chunked theta join against numpy; then the analytic slice at
SF1 against numpy: statistical aggregates, percentiles, a partial -> final
aggregate, window functions over lineitem and orders, INTERSECT/EXCEPT ALL,
and a converged plan re-run without planning; the client slice; the
22 queries at SF10 in-core, on the serial runtime, routed under a 10 GiB
cap and through a real out-of-memory fallback; the distributed slice:
the 22 queries at SF1 over 8 partitions of the card through the scheduler
and the partitioned runtime; and the TPC-H tools: the datagen CLI's .tbl
files, their numpy reader, the benchmark runner against answers/sf1, the
load, scaling and scheduler-event benches, Avro and a UDF plugin.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --distributed-only  # phases 1, 2 and 13 alone
    python3 chip_smoke.py --wire-only         # phases 1, 2 and 14 alone
    python3 chip_smoke.py --raw-only          # phases 1, 2, 11's h2o join
                                              # and 15 alone
    python3 chip_smoke.py --tools-only        # phases 1, 2 and 16 alone
    python3 chip_smoke.py --wide-only         # phases 1, 2 and 19 alone
    python3 chip_smoke.py --sf100-only [--queries 1,6]  # phases 1, 2 and
                                              # the SF100 sweep

Phases:
1. torch version, card name and power limit (exits 1 without CUDA);
2. nvcc build of csrc/masked_slot_sums.cu, with the registers and spills
   ptxas reports for every kernel instance;
3. both entries of the kernel (masked_slot_sums over a contribution
   matrix, masked_slot_sums_rows over described columns) vs their plain
   versions (torch.equal): at every T where the code path changes, at
   sizes below one vector and odd sizes, on views off the 16-byte grid,
   with all rows in one slot, 1 % and 0 % of rows live, sums that wrap,
   and calls split over launches; then CUDA-event times at Q1's shape on
   uniform and on skewed slots and of a sparse T = 1 call, each with the
   bytes it must read, its bound at 3.35 TB/s and the share reached;
4. Q1 at SF1: datagen (seed 19940101), SQL, collect; exact checks against a
   numpy computation on the same host columns and against
   answers/sf1/answers/q1.out; the kernel's launch count on that run;
   timings;
5. both entries vs their plain versions again, on the tensors Q1 passed
   the kernel, with times, bytes, bound and the time of index_add_ alone
   (these are the numbers the JSON line reports);
6. the join slice: all eight tables at SF1 (seed 19940101), Q3 and Q5
   through the joins, the sorted-layout aggregate (Q3) and the kernel
   (Q5's n_name aggregate); exact checks against answers/sf1/answers/q3.out
   and q5.out, and Q5 against a numpy computation on the host columns;
   the kernel's launches and call shape on Q5, the kernel against its plain
   version on Q5's own inputs with both times; first-run and warm times;
7. the rest of the six-table queries on phase 6's context and uploaded
   tables: Q4, Q6, Q7, Q10, Q12, Q13, Q15, Q18, Q21 and Q22, each timed as
   `ctx.sql(text).collect()` (so Q15's view and the scalar subqueries of
   Q15 and Q22 count), first run and warm median of 10; per query the
   kernel's launches and call shapes, each expanding join's output rows
   against its capacity, any overflow retry, and the exact match with
   answers/sf1/answers/q{q}.out. Q6 and Q12 must launch the kernel, and it
   is held against its plain version on their own inputs (T = 1 and 8),
   with both times;
8. the nine queries that read part or partsupp, on the same context: Q2,
   Q8, Q9, Q11, Q14, Q16, Q17, Q19 and Q20, timed and checked as in
   phase 7; Q14, Q17 and Q19 must launch the kernel (T = 1), which is
   held against its plain version on each one's own inputs; the host
   time of Q9's and Q20's planning and of their LIKE lookup tables over
   p_name's 200,000-entry dictionary;
9. one query each on the SF1 tables, checked against numpy on the same
   host columns: a full outer join with unmatched rows on both sides on
   the unique and on the expanding path, UNION ALL and UNION over
   differing dictionaries, and a theta join (supplier x customer) past
   CrossJoinExec.MAX_CELLS that runs as a chunked NestedLoopJoinExec.
10. the analytic slice on the same context, each answer against a numpy
   computation on the same host columns, first run and warm median of 3:
   stddev_samp, var_pop and corr grouped on the masked layout
   (l_returnflag, l_linestatus) and the sorted layout (l_suppkey; f64 at
   rtol 1e-9, because the card adds f64 sums in no fixed order and the
   one-pass variance cancels); median and percentile_cont(0.9) by
   l_shipmode and ungrouped (rtol 1e-12); Q1's aggregate as `partial` over
   each half of lineitem, CoalesceExec and `final`, equal to phase 4's
   answer exactly, where the final node must launch masked_slot_sums_rows
   at T = 12 and that call is held against its plain version; row_number
   and a running sum, rank and dense_rank, lag / lead / first_value, and
   min / max through the sparse table (ROWS 2 PRECEDING), the prefix
   extremum (default frame) and the partition extremum, all exact;
   INTERSECT ALL and EXCEPT ALL of o_custkey against c_nationkey, exact;
   Q21 planned once with `converge` and re-run with `run_plan`, beside
   `collect()`, and its evaluate calls with and without shared subtrees.
11. the client slice, no pyarrow and no pandas, every answer against numpy
   on the same host arrays: the h2o db-benchmark groupby task at N = 10^7,
   K = 100 (G1_1e7_1e2_0_0: nine columns registered from numpy arrays with
   `register_numpy`, ingest seconds per column; the 10 questions through
   `ctx.sql(text).collect()`, warm median of 3, the aggregate's layout,
   kernel launches and overflow retries per question; counts and integer
   sums exact, f64 sums, averages, stddev and corr at rtol 1e-9, the
   median at rtol 1e-12, q8 exact as a multiset; q10's ~10^7 groups must
   come through the overflow retries); the join task at N = 10^7 (J1_1e7:
   x.id6 and large.id6 must come out RAW at the default threshold; row
   counts, matched rows, sum(v1) and sum(v2) of the 5 questions); the
   taxi query over 10^7 synthetic trips; TPC-H Q1 and Q3 at SF1 written
   as DataFrame calls, equal to answers/sf1 (Q1 must launch the kernel at
   T = 12); for Q3, Q5, Q7, Q8, Q9, Q18 and Q21 the nodes `plan_sparse_flow`
   marked and the warm `run_plan` of the converged plan; EXPLAIN, SHOW
   TABLES and CREATE TABLE AS on the SF1 context, with a SELECT over the
   new table against numpy and its kernel call held against the plain
   version.
12. the out-of-core slice at TPC-H SF10 (`generate_tpch(10, 19940101)`,
   the same host columns registered in every context): (a) the 22 queries
   in-core on the whole card, first run and warm median of 3, each with
   its peak allocated and reserved bytes and the memory model's estimate
   (columns evicted before each query), Q1, Q5 and Q6 equal to numpy; (b)
   the 22 on SessionContext(serial_partitions=8), a first and a timed
   second run, each equal to (a) (f64 at rtol 1e-9), with stages,
   partitions, bytes each way and peak; past 45 s (about the seven queries
   of SERIAL_SF10_FIRST, which keeps the whole script inside its limit
   beside phase 18) the queries left run at SF1 against answers/sf1; (c)
   plain collect() under a 10 GiB cap
   (`set_per_process_memory_fraction`, BALLISTA_HBM_BYTES): each query's
   route (in-core, routed serial@N, OOM fallback serial@N), every answer
   equal to (a), at least one routed; (d) the query of (a) with the largest
   peak, routing off (BALLISTA_ROUTE_FACTOR=0), under the cap (halved
   below its peak if it fits): a real torch.cuda.OutOfMemoryError answered
   by the serial runtime, the OOM memo written, then a second collect()
   routed by the memo alone. The kernel is held against its plain version
   on SF10 Q1's in-core call and on one serial shard's call.
13. the distributed slice on phase 6's SF1 tables (with
   `--distributed-only`, made in the call): (a) the 22 queries through
   SessionContext(device="cuda", distributed=True, mesh=make_mesh(8,
   devices=[cuda:0] * 8)), each exact against answers/sf1 and equal to the
   in-core answer of phases 4-8 (f64 at rtol 1e-9), with its first run and
   warm median of 3, jobs, stages, tasks and overflow escalations, each
   stage's (run_s, output_rows), peak allocated and reserved bytes (the
   partitioned tables evicted first) and the bytes of the partitioned
   tables; the kernel held against its plain version on one partition's
   partial aggregate of Q1; (b) Q1 on the default mesh (one partition per
   visible card), equal to (a); (c) a 10^7-row fact table, 85 % of it on
   one key, registered with register_numpy and shuffle-joined to a
   100-row dimension on tiny quotas: the retry must salt the join, the
   options of every attempt are printed, the answer equals numpy; (d) Q3
   through StandaloneCluster(policy="pull"), a LIMIT 10 that trips the
   circuit breaker, two jobs queued before the scheduler runs, their stage
   states. Its seconds and the script's are printed.
14. the wire slice on phase 6's SF1 data environment ({"kind": "tpch",
   "sf": 1}, which every process generates itself; with `--wire-only` the
   script's SF1 tables are made in the call): three scheduler RPC services
   (`serve_scheduler`) on threads of the script and six executor processes
   (`python -m ballista_tpu_torch.scheduler.executor_process --device cuda
   --partitions 4`), all on cuda:0, each waited for by its EXECUTOR_READY
   line. First the kernel is held against its plain version on one
   partition's partial aggregate of Q1 at P = 4, the call an executor's
   stage makes (run in this process). (a) the 22 queries through
   `SchedulerRpcClient.submit_sql` -> `wait_batch` on two pull executors,
   each exact against answers/sf1 and equal to the in-core answer (f64 at
   rtol 1e-9), with seconds from submit to result, stages, tasks per
   executor, the spec version (escalations), blob bytes spilled, inputs
   restored from the spill store and kernel launches summed over the
   tasks' metrics; both executors must run tasks and Q1 must launch the
   kernel in them; (b) Q1, Q3, Q5 and Q21 through two push executors,
   equal; (c) Q3 and Q5 through two executors whose work dirs are their
   own and disjoint from the scheduler's: stage inputs must cross through
   `fetch_partition` (at least one) and the scheduler's store stays empty;
   (d) Q21 on (a)'s executors, the one whose task reports first killed
   (SIGKILL): the job ends on the survivor, equal; (e) every live executor
   stopped by SIGTERM exits 0 and leaves its scheduler's registry. Every
   process is killed in a `finally`. Its seconds are printed.
15. RAW strings (the dictionary is the column in row order, code == row
   index) at full width: (a) the 22 queries at SF1 over phase 6's rows
   registered with BALLISTA_RAW_DICT_MAX=0 (every string column RAW,
   l_comment's dictionary 5,998,239 entries), each exact against
   answers/sf1 and equal to the sorted-dictionary answer, first run and
   warm median of 3, with the host seconds of the dictionary tables each
   made (str conversion, dense-rank recode, LIKE lookup tables, value
   hashes); Q1 must launch the kernel at T = 12, and that call is held
   against its plain version; (b) on phase 11's J1_1e7 x (id6 RAW at the
   default threshold), against numpy on the same host arrays: GROUP BY
   id6 (~6.32 M groups, through overflow retries), ORDER BY id6 LIMIT
   100, min and max of id6, and an equality, an IN and a LIKE on id6;
   (c) Q1 and Q13 over the RAW tables through SessionContext(distributed=
   True) at P = 8 and through the wire (a scheduler and two executor
   processes of P = 4 started with BALLISTA_RAW_DICT_MAX=0), each equal
   to (a)'s answer.
16. the TPC-H tools at SF1 (with `--tools-only`, the generated tables
   made in the call): (a) `python -m ballista_tpu_torch.datagen --sf 1
   --format tbl` writes the eight tables to build/tpch_sf1_tbl, with the
   seconds and bytes per table; (b) `read_tbl` reads each back, every
   column equal to the generated one (values, validity, the strings
   behind the codes), with the parse seconds per table; (c)
   `runner.run(tbl_dir=..., expected=answers/sf1, iterations=3)` over the
   22 queries: every query must report a match and no error (Q9's exact
   midpoint is reported, not failed), its ms and first-run seconds beside
   phases 4-8's warm medians; Q1's kernel call at T = 12 is held against
   its plain version; (d) the runner's command line, `--queries 1,6,21
   --distributed --expected answers/sf1`, every match true; (e) a
   scheduler and one pull executor process (P = 4, cuda:0) over the
   {"kind": "tbl"} data environment answer Q1 and Q6 exactly; (f)
   `loadtest` of 4 clients x 4 requests over Q1, Q3 and Q6 (16 queries),
   `scaling` of Q1 at P = 1, 2, 4 and 8 on cuda:0, each P's answer equal
   to P = 1's, and the scheduler event bench in process and over the
   wire; (g) customer (150,000 rows) written with `write_avro` (deflate)
   and registered with `register_avro` in place of the .tbl one, Q13 and
   Q22 exact; (h) a plugin directory with one UDF loaded and its UDF
   summed over lineitem, against numpy. Every part prints its seconds;
   the .tbl directory is deleted in a `finally`.
17. the last modules at SF1: lazy ingest over .tbl files, the native
   encoder, two gloo processes on cuda:0, Flight SQL.
18. TPC-H SF100 on one card: (a) nproc, free host memory and free disk
   under TMPDIR; (b) `python -m ballista_tpu_torch.datagen --sf 100
   --tables lineitem --chunks 100 --workers $(nproc)` writes lineitem
   (599,984,204 rows) as parquet part files under TMPDIR, deleted at the
   end; (c) the dataset registered, Q1 and Q6 through `collect()` with
   routing on: route, first run (the columns read from the part files),
   warm median of 3, peak allocated and reserved, host peak RSS; Q1's
   sum_charge must be a wide decimal; on Q1's columns, no part file read
   again, Q1 over l_linestatus = 'F' by sum_charge desc (wide by its bound,
   narrowed: its three rows equal (f)'s reference) and Q1 by sum_charge
   (must raise the wide-decimal error naming it: N|O passes int64);
   (d) the kernel's Q1 call (n = 6.0e8,
   T = 12, twelve described rows, two of them half-word) against its plain
   version over row chunks, with the bytes it must read, its bound at
   3.35 TB/s and index_add_ on the same call; (e) Q1 on
   serial_partitions=8, equal to (c) exactly; (f) Q1 and Q6 equal to the
   streaming numpy reference of `benchmarks/sf100.py` exactly, N|O's
   sum_charge positive. With `--sf100-only` (not in the default run): SF10
   and SF100 of every table generated under TMPDIR and the queries through
   `benchmarks/sf100.py` (SF10 each in-core against serial, SF100 each in
   its own process against the invariants); it exits 1 if any query fails.
19. wide SUMs read as values at SF1, on the shared SF1 context: (a) Q1 with
   sum(coalesce(...)) as sum_charge ordered by it, descending, in-core,
   on serial_partitions=8 and over P = 8 partitions of the card, each
   equal to answers/sf1's rows in that order; (b) a HAVING on
   sum(abs(l_quantity)); (c) a CTE's roll-up of Q1's sum_disc_price
   ordered by the roll-up (wide by its bound: narrowed); (d) partsupp x
   lineitem on ps_partkey alone grouped by l_returnflag, ordered by
   sum(l_extendedprice) (wide by its rows: narrowed); (b)-(d) against
   numpy on the host columns; route, warm ms, launches and the narrowed
   sums of each; the kernel against its plain version on every call
   shape, with index_add_ on the same calls.
Phases 7 and 8 also hold the kernel against its plain version on the
calls Q4, Q15 and Q22 (phase 7) and Q11 and Q16 (phase 8) made.
The line before the last is a JSON object describing the kernel (its
launches summed over every query's first run and phase 14's executor
tasks, per entry point under `entry_points`); the last line is
{"ok": true, "device": {...}}. Any failure raises (exit code 1).
"""

import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ballista_tpu_torch.batch import (Batch, Column, round_capacity,
                                      to_numpy)
from ballista_tpu_torch.benchmarks import (ANALYTIC_QUERIES, TPCH_QUERIES,
                                           h2o, nyctaxi)
from ballista_tpu_torch.benchmarks.queries import q1_frame, q3_frame
from ballista_tpu_torch.benchmarks.timing import (cuda_ms, host_ms,
                                                  library_ms)
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import rebind_scans
from ballista_tpu_torch.avro import write_avro
from ballista_tpu_torch.benchmarks import runner as runner_mod
from ballista_tpu_torch.benchmarks import scaling as scaling_mod
from ballista_tpu_torch.benchmarks import scheduler_events
from ballista_tpu_torch.datagen import (TPCH_TABLES, generate_tpch,
                                        register_tpch)
from ballista_tpu_torch.datagen.tbl import diff_expected, read_tbl
from ballista_tpu_torch.exec import memory
from ballista_tpu_torch.exec import plan as plan_mod
from ballista_tpu_torch import exprs as exprs_mod
from ballista_tpu_torch.exprs import Col, like_lut, parse_date
from ballista_tpu_torch.ops import masked_sums
from ballista_tpu_torch.schema import TypeKind
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.scheduler import serial as serial_mod
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from ballista_tpu_torch.scheduler.rpc import (SchedulerRpcClient,
                                              serve_scheduler)
from ballista_tpu_torch.scheduler.runtime import execute_distributed
from ballista_tpu_torch.scheduler.serial import estimate_serial_hbm
from ballista_tpu_torch.scheduler.standalone import StandaloneCluster

SF = 1.0
SEED = 19940101
LINEITEM_ROWS = 5_998_239          # lineitem at SF1 from this generator
# the kernel call Q1's aggregate makes: 5 distinct decimal sums, their 5
# validity counts and count(*) over 12 direct slots ((3 flags + NULL) x
# (2 statuses + NULL): the columns are nullable)
Q1_T, Q1_A = 12, 11
Q1_N = round_capacity(LINEITEM_ROWS)
EXPECTED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "answers", "sf1")
ANSWER_DIR = os.path.join(EXPECTED_DIR, "answers")
# warm medians (ms) of phases 4-8, by query, beside which phase 16 prints
# the runner's times
WARM_MS = {}
# Q5's kernel call: sum and count of the revenue expression and count(*)
# over 26 direct slots (25 nations + NULL), n = lineitem's capacity, which
# an inner unique join keeps from its probe side
Q5_T, Q5_A = 26, 3
BIG = 2 ** 62
# f64 moments and corr against numpy's two-pass values: the card adds the
# f64 sums with atomics in no fixed order, and s2/n - (s1/n)^2 cancels
MOMENT_RTOL = 1e-9
# a percentile interpolates two stored values
PERCENTILE_RTOL = 1e-12


def log(msg):
    print(msg, flush=True)


HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
# 32-bit integer operations per second outside the tensor cores: half the
# data sheet's 67 TFLOP/s of float32, which counts a multiply-add as two
INT32_OPS_PER_S = 33.5e12


def reset_counts():
    masked_sums.masked_slot_sums.launches = 0
    masked_sums.masked_slot_sums_rows.launches = 0


def read_counts():
    """(launches through masked_slot_sums_rows, through masked_slot_sums)."""
    return np.array([masked_sums.masked_slot_sums_rows.launches,
                     masked_sums.masked_slot_sums.launches])


def _equal(got, want, what):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"kernel != plain at {what}")
    return (got - want).abs().max().item() if got.numel() else 0


def compare(slot, contribs, T):
    """masked_slot_sums vs its plain version on the same card tensors;
    raises unless torch.equal. Returns the max absolute difference (0)."""
    return _equal(masked_sums.masked_slot_sums(slot, contribs, T),
                  masked_sums.masked_slot_sums_reference(slot, contribs, T),
                  f"(A, n)={tuple(contribs.shape)} T={T}")


def compare_rows(slot, rows, T):
    """masked_slot_sums_rows vs its plain version, as `compare`."""
    return _equal(masked_sums.masked_slot_sums_rows(slot, rows, T),
                  masked_sums.masked_slot_sums_rows_reference(slot, rows, T),
                  f"rows A={len(rows)} n={slot.shape[0]} T={T}")


def time_kernel(kernel, plain):
    """(kernel ms call after call, kernel ms of device work alone, plain
    ms), warm, from CUDA events. Logs nothing; `host_note` gives the
    wrapper's host time."""
    return cuda_ms(kernel), cuda_ms(kernel, queued=True), cuda_ms(plain)


def host_note(slot, contribs, rows, T):
    """The host time one call of each entry takes to return."""
    rows_ms = host_ms(lambda: masked_sums.masked_slot_sums_rows(slot, rows, T))
    matrix_ms = host_ms(lambda: masked_sums.masked_slot_sums(slot, contribs,
                                                             T))
    return (f"host time per call: masked_slot_sums_rows {rows_ms:.4f} ms, "
            f"masked_slot_sums {matrix_ms:.4f} ms")


def time_both(slot, contribs, T):
    return time_kernel(
        lambda: masked_sums.masked_slot_sums(slot, contribs, T),
        lambda: masked_sums.masked_slot_sums_reference(slot, contribs, T))


def time_rows(slot, rows, T):
    """The plain version writes the contribution matrix and reduces it."""
    return time_kernel(
        lambda: masked_sums.masked_slot_sums_rows(slot, rows, T),
        lambda: masked_sums.masked_slot_sums_rows_reference(slot, rows, T))


def bound(slot, columns, T, A):
    """The least time the card could take for one call on these inputs:
    {"bytes", "ops", "bound_ms", "bound_by"}. Bytes: every slot once, the
    32-byte sectors of each column in `columns` that hold a live row (a
    dead row's values are never needed), the T x A sums once. Operations:
    one 64-bit add (two 32-bit operations) per live row and aggregate."""
    n = slot.shape[0]
    live = (slot >= 0) & (slot < T)
    n_live = int(live.sum())
    sectors = {}
    for size in {c.element_size() for c in columns}:
        if n_live == n:
            sectors[size] = n * size
        else:
            # rows of 32-byte sector k of a column: [k * 32 / size, ...)
            per = 32 // size
            hit = torch.cat([live, live.new_zeros(-n % per)]).view(
                -1, per).any(1)
            sectors[size] = min(int(hit.sum()) * 32, n * size)
    nbytes = 4 * n + sum(sectors[c.element_size()] for c in columns) \
        + 8 * T * A
    ops = 2 * n_live * A
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "live": n_live,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def row_columns(rows):
    """The distinct tensors a masked_slot_sums_rows call reads."""
    seen = {}
    for row in rows:
        for t in row[:2]:       # (data, validity[, half-word mode])
            if t is not None:
                seen[t.data_ptr()] = t
    return list(seen.values())


def rand_slots(n, T, gen, slot_lo=0):
    return torch.randint(slot_lo, T + 2, (n,), generator=gen,
                         dtype=torch.int32).cuda()


def rand_rows(n, gen, lo=-2 ** 40, hi=2 ** 40, offset=0):
    """Five described rows over fresh columns: count(*), a count, an int64
    sum with and without validity, an int32 sum. `offset` drops that many
    leading elements from every column, so the views start off the
    16-byte grid."""
    def col(dtype, lo, hi, to=None):
        t = torch.randint(lo, hi, (n + offset,), generator=gen,
                          dtype=dtype).cuda()
        return (t if to is None else t.to(to))[offset:]

    v1 = col(torch.int8, 0, 2, torch.bool)
    v2 = col(torch.int8, 0, 2, torch.bool)
    d64, d64b = col(torch.int64, lo, hi), col(torch.int64, lo, hi)
    d32 = col(torch.int32, -2 ** 31, 2 ** 31 - 1)
    return [(None, None), (None, v1), (d64, v1), (d64b, None), (d32, v2)]


def kernel_case(n, T, A, lo, hi, slot_lo, gen):
    slot = rand_slots(n, T, gen, slot_lo)
    contribs = torch.randint(lo, hi, (A, n), generator=gen,
                             dtype=torch.int64).cuda()
    err = compare(slot, contribs, T)
    rows = rand_rows(n, gen, lo, hi)
    return slot, contribs, max(err, compare_rows(slot, rows, T))


def timed_shape(label, slot, contribs, rows, T):
    """Both entries on one call shape: equal to their plain versions, then
    times, the bytes each must read, the bound and the share reached."""
    err = max(compare(slot, contribs, T), compare_rows(slot, rows, T))
    A, n = contribs.shape
    for name, (ms, dev_ms, plain), b in (
            ("masked_slot_sums", time_both(slot, contribs, T),
             bound(slot, list(contribs), T, A)),
            ("masked_slot_sums_rows", time_rows(slot, rows, T),
             bound(slot, row_columns(rows), T, len(rows)))):
        log(f"phase 3: {label}, n={n} T={T} A={A}, {b['live']} live rows, "
            f"{name}: equal; kernel {ms:.4f} ms ({dev_ms:.4f} ms of device "
            f"work), plain {plain:.4f} ms; must read {b['bytes']} B, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound "
            f"{b['bound_ms'] / ms:.3f}")
    log(f"phase 3: {label}: index_add_ alone "
        f"{library_ms(slot, contribs, T):.4f} ms; "
        f"{host_note(slot, contribs, rows, T)}")
    return err


def phase_kernel():
    gen = torch.Generator().manual_seed(SEED)
    max_err = 0
    cases = [  # (n, T, A, value lo, value hi, lowest slot)
        (0, 6, 3, -2 ** 40, 2 ** 40, 0),
        (1, 6, 3, -2 ** 40, 2 ** 40, 0),
        (1_000_003, 12, 11, -2 ** 40, 2 ** 40, 0),   # not a tile multiple
        (100_000, 64, 3, -2 ** 40, 2 ** 40, 0),       # T = MASKED_MAX
        (300_001, 6, 4, -3, 3, -5),                   # slots < 0 and > T
        (500_000, 12, 11, BIG - 2 ** 20, BIG, 0),     # wraps mod 2^64
        (500_000, 12, 11, -BIG, -BIG + 2 ** 20, 0),   # wraps mod 2^64
        (200_001, 12, 20, -2 ** 40, 2 ** 40, 0),      # A past one launch
        (200_001, 40, 37, -2 ** 40, 2 ** 40, 0),
        (100_001, 64, 16, -2 ** 40, 2 ** 40, 0),      # a copy per warp
        (50_001, 6000, 2, -2 ** 40, 2 ** 40, 0),      # one shared copy
    ]
    for n, T, A, lo, hi, slot_lo in cases:
        _, _, err = kernel_case(n, T, A, lo, hi, slot_lo, gen)
        max_err = max(max_err, err)
        log(f"phase 3: edge case n={n} T={T} A={A}: equal")
    # more described rows than one launch streams columns
    for T in (3, 12, 40):
        slot = rand_slots(200_001, T, gen, -1)
        rows = rand_rows(200_001, gen) * 3 + rand_rows(200_001, gen) * 2
        max_err = max(max_err, compare_rows(slot, rows, T))
        log(f"phase 3: {len(rows)} described rows, T={T}: equal")
    # columns that are views: stride 0 (a literal argument, a broadcast
    # join side) and every other element of a wider column
    for T in (1, 12, 26):
        n = 300_001
        slot = rand_slots(n, T, gen, -1)
        wide = torch.randint(-BIG, BIG, (2 * n,), generator=gen,
                             dtype=torch.int64).cuda()
        flags = (torch.rand(2 * n, generator=gen) >= 0.3).cuda()
        seven = torch.tensor([7], dtype=torch.int64).cuda().expand(n)
        three = torch.tensor([3], dtype=torch.int32).cuda().expand(n)
        yes = torch.tensor([True]).cuda().expand(n)
        max_err = max(max_err, compare_rows(slot, [
            (None, yes), (seven, yes), (three, flags[:n]), (seven, None),
            (wide[::2], flags[::2]), (None, flags[1::2]), (wide[1::2], yes)],
            T))
        log(f"phase 3: stride-0 and every-other columns, T={T}: equal")
    # every T at the edge of a code path, at sizes below one vector, an
    # odd size, an A-chunk view off the 16-byte grid, and columns and
    # slots that start 1, 2 and 3 elements off it
    for T in (1, 2, 3, 4, 5, 8, 9, 16, 17, 26, 64):
        for n in (1, 2, 3, 4099, 1_000_003):
            slot, contribs, err = kernel_case(n, T, 5, -2 ** 40, 2 ** 40,
                                              -1, gen)
            max_err = max(max_err, err, compare(slot, contribs[1:], T))
        for off in (1, 2, 3):
            n = 300_000 + off
            slot = rand_slots(n + off, T, gen, -1)[off:]
            max_err = max(max_err, compare_rows(
                slot, rand_rows(n, gen, offset=off), T))
            contribs = torch.randint(-BIG, BIG, (3, n), generator=gen,
                                     dtype=torch.int64).cuda()
            max_err = max(max_err, compare(slot, contribs, T))
        log(f"phase 3: T={T}: n in (1, 2, 3, 4099, 1000003), contribs[1:] "
            "and columns 1-3 elements off the 16-byte grid: both entries "
            "equal")
    # the half-word read modes (a wide decimal sum: HI and LO over one
    # column) at every code path (registers, lane columns, the matched
    # kernel), full-range int64 and int32 values, columns off the grid
    for T in (1, 4, 12, 64, 6000):
        for off in (0, 1):
            n = 700_001
            slot = rand_slots(n + off, T, gen, -1)[off:]
            d64 = torch.randint(-2 ** 63, 2 ** 63 - 1, (n + off,),
                                generator=gen, dtype=torch.int64).cuda()[off:]
            d32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + off,),
                                generator=gen, dtype=torch.int32).cuda()[off:]
            v = (torch.rand(n + off, generator=gen) >= 0.2).cuda()[off:]
            max_err = max(max_err, compare_rows(slot, [
                (None, None), (None, v), (d64, v, masked_sums.HI),
                (d64, v, masked_sums.LO), (d64, v), (d32, None,
                                                     masked_sums.HI),
                (d32, v, masked_sums.LO)], T))
        log(f"phase 3: half-word rows (HI, LO of int64 and int32 columns, "
            f"aligned and off the grid), T={T}: equal")
    # all rows in one slot; 1 % and 0 % of the rows live
    n = 1_000_003
    contribs = torch.randint(-2 ** 40, 2 ** 40, (Q1_A, n), generator=gen,
                             dtype=torch.int64).cuda()
    rows = rand_rows(n, gen)
    pick = torch.rand(n, generator=gen).cuda()
    for label, slot in (
            ("all rows in slot 7",
             torch.full((n,), 7, dtype=torch.int32).cuda()),
            ("1 % live", torch.where(pick < 0.01, 3, Q1_T).to(torch.int32)),
            ("0 % live", torch.full((n,), Q1_T, dtype=torch.int32).cuda())):
        max_err = max(max_err, compare(slot, contribs, Q1_T),
                      compare_rows(slot, rows, Q1_T))
        log(f"phase 3: n={n} T={Q1_T} A={Q1_A}, {label}: both entries equal")
    del contribs, rows, pick

    # times at Q1's shape: Q1's 11 rows are count(*), five int64 sums and
    # their five counts over five validity columns
    contribs = torch.randint(-2 ** 40, 2 ** 40, (Q1_A, Q1_N), generator=gen,
                             dtype=torch.int64).cuda()
    data = [torch.randint(-2 ** 40, 2 ** 40, (Q1_N,), generator=gen,
                          dtype=torch.int64).cuda() for _ in range(5)]
    valid = [torch.ones(Q1_N, dtype=torch.bool).cuda() for _ in range(5)]
    rows = [(None, None)] + [(None, v) for v in valid] \
        + [(d, v) for d, v in zip(data, valid)]
    uniform = torch.randint(0, Q1_T, (Q1_N,), generator=gen,
                            dtype=torch.int32).cuda()
    # Q1's skew: three of the 12 slots hold every row, one of them half
    skewed = torch.tensor([0, 0, 5, 9], dtype=torch.int32).cuda()[
        torch.randint(0, 4, (Q1_N,), generator=gen).cuda()]
    max_err = max(max_err,
                  timed_shape("Q1 shape, uniform slots", uniform, contribs,
                              rows, Q1_T),
                  timed_shape("Q1 shape, 3 of 12 slots hold all rows", skewed,
                              contribs, rows, Q1_T))
    sparse = torch.where(torch.rand(Q1_N, generator=gen).cuda() < 0.02, 0,
                         1).to(torch.int32)
    max_err = max(max_err, timed_shape(
        "T = 1, 2 % live", sparse, contribs[:3].contiguous(),
        [(None, None), (None, valid[0]), (data[0], valid[0])], 1))
    return max_err


class spy_rows:
    """Records every masked_slot_sums_rows call the aggregate operator
    makes while the block runs: (row_slot, rows, T). With `first_at` only
    the first call at that T is kept (a sweep's later calls are not, so
    their tensors can go)."""

    def __init__(self, first_at=None):
        self.first_at = first_at
        self.calls = []

    def __enter__(self):
        self.real = plan_mod.masked_slot_sums_rows

        def spy(row_slot, rows, T):
            if self.first_at is None or (T == self.first_at
                                         and not self.calls):
                self.calls.append((row_slot, list(rows), T))
            return self.real(row_slot, rows, T)

        plan_mod.masked_slot_sums_rows = spy
        return self.calls

    def __exit__(self, *exc):
        plan_mod.masked_slot_sums_rows = self.real


def call_shapes(calls):
    return [((len(rows), slot.shape[0]), T) for slot, rows, T in calls]


def hold_call(phase, label, slot, rows, T):
    """Both entries against their plain versions on one call a query made
    (masked_slot_sums on the matrix those rows describe), with times,
    bytes and bounds. Returns the numbers of the kernels line."""
    err = compare_rows(slot, rows, T)
    ms, dev_ms, plain = time_rows(slot, rows, T)
    b = bound(slot, row_columns(rows), T, len(rows))
    contribs = masked_sums.contribution_matrix(slot, rows)
    m_err = compare(slot, contribs, T)
    m_ms, m_dev_ms, m_plain = time_both(slot, contribs, T)
    m_b = bound(slot, list(contribs), T, len(rows))
    lib = library_ms(slot, contribs, T)
    log(f"phase {phase}: {label} (n={slot.shape[0]}, {b['live']} live rows, "
        f"T={T}, A={len(rows)}): masked_slot_sums_rows equal; kernel "
        f"{ms:.4f} ms ({dev_ms:.4f} ms of device work), plain {plain:.4f} ms; "
        f"must read {b['bytes']} B, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share "
        f"{b['bound_ms'] / ms:.3f}")
    log(f"phase {phase}: {label}, as a matrix: masked_slot_sums equal; kernel "
        f"{m_ms:.4f} ms ({m_dev_ms:.4f} ms of device work), plain "
        f"{m_plain:.4f} ms; must read {m_b['bytes']} B, "
        f"bound {m_b['bound_ms']:.4f} ms by {m_b['bound_by']}, share "
        f"{m_b['bound_ms'] / m_ms:.3f}; index_add_ alone {lib:.4f} ms; "
        f"{host_note(slot, contribs, rows, T)}")
    return {
        "masked_slot_sums_rows": {
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": lib},
        "masked_slot_sums": {
            "max_abs_err": m_err, "ms": m_ms, "device_ms": m_dev_ms,
            "plain_ms": m_plain,
            "bound_ms": m_b["bound_ms"], "bound_by": m_b["bound_by"],
            "library_ms": lib}}


def held_err(held):
    return max(v["max_abs_err"] for v in held.values())


def numpy_q1(cols):
    """Q1 over the host columns in numpy and Python ints:
    {(flag, status): [sum_qty, sum_base_price, sum_disc_price, sum_charge,
    avg_qty, avg_price, avg_disc, count]} as scaled integers."""
    def v(name):
        return cols[name].values

    live = v("l_shipdate") <= parse_date("1998-09-02")
    qty, price = v("l_quantity"), v("l_extendedprice")
    disc, tax = v("l_discount"), v("l_tax")
    disc_price = price * (100 - disc)            # scale 4
    charge = disc_price * (100 + tax)            # scale 6
    flags, statuses = cols["l_returnflag"], cols["l_linestatus"]

    def avg(total, count):   # scale 2 -> 6, half away from zero
        q, r = divmod(abs(total) * 10 ** 4, count)
        q += 2 * r >= count
        return q if total >= 0 else -q

    out = {}
    for fi, flag in enumerate(flags.dictionary):
        for si, status in enumerate(statuses.dictionary):
            m = live & (flags.values == fi) & (statuses.values == si)
            n = int(m.sum())
            if not n:
                continue
            s = [int(x[m].sum()) for x in (qty, price, disc_price, charge)]
            out[(flag, status)] = s + [avg(s[0], n), avg(s[1], n),
                                       avg(int(disc[m].sum()), n), n]
    return out


def check_q1(got, schema, cols):
    """Q1's answer (host columns) against numpy_q1 on lineitem's host
    columns, exactly."""
    want = numpy_q1(cols)
    keys = list(zip(got["l_returnflag"][0], got["l_linestatus"][0]))
    if keys != sorted(want):
        raise AssertionError(f"groups {keys} != {sorted(want)}")
    for f in schema.fields[2:]:
        if not got[f.name][1].all():
            raise AssertionError(f"NULL in {f.name}")
    for i, key in enumerate(keys):
        row = [int(got[f.name][0][i]) for f in schema.fields[2:]]
        if row != want[key]:
            raise AssertionError(f"group {key}: {row} != numpy {want[key]}")


def check_answers(got, schema, q):
    """Exact match with answers/sf1/answers/q{q}.out, whose header must
    name the result's columns: `datagen.tbl.diff_expected`, the rule the
    runner's --expected applies (cells at the answer's printed scale,
    position-wise, or, where ORDER BY leaves ties, after sorting both
    sides' rows).

    The answer files come from a float64 oracle, so an exact decimal that
    lies on the midpoint between two printed values (Q9's 22091132.2950 at
    two places) may be printed rounded either way: such a cell matches
    either neighbour, and each one is logged."""
    with open(os.path.join(ANSWER_DIR, f"q{q}.out")) as f:
        header = f.readline().rstrip("\n").split("|")
    names = [f.name for f in schema.fields]
    if header != names:
        raise AssertionError(f"q{q}: columns {names} != answer header {header}")
    notes = []
    mismatch = diff_expected((got, schema), EXPECTED_DIR, q, notes)
    for note in notes:
        log(note)
    if mismatch:
        raise AssertionError(f"q{q}.out: {mismatch}")


def phase_q1():
    t0 = time.perf_counter()
    tables = generate_tpch(SF, SEED, tables=["lineitem"])
    fields, cols = tables["lineitem"]
    n_rows = len(cols["l_orderkey"].values)
    if n_rows != LINEITEM_ROWS:
        raise AssertionError(f"lineitem has {n_rows} rows at SF1")
    ctx = SessionContext(device="cuda")
    ctx.register_host("lineitem", fields, cols)
    df = ctx.sql(TPCH_QUERIES[1])
    used = [leaf.input_id for leaf in ctx.physical_plan(df.plan).leaves()]
    ctx.bind_inputs(used)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"phase 4: datagen + upload {setup_s:.3f} s ({n_rows} rows)")

    reset_counts()
    with spy_rows() as calls:
        t0 = time.perf_counter()
        batch, schema = df.collect()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = read_counts()
    if launches[0] < 1:
        raise AssertionError("Q1 ran without launching masked_slot_sums_rows")
    shapes = call_shapes(calls)
    if shapes != [((Q1_A, Q1_N), Q1_T)]:
        raise AssertionError(f"Q1's kernel calls {shapes} differ from the "
                             f"shape phase 3 checked ({Q1_A}, {Q1_N}), {Q1_T}")
    log(f"phase 4: first run {first_s:.4f} s; masked_slot_sums_rows launches "
        f"{launches[0]}, masked_slot_sums launches {launches[1]}, at (A, n), "
        f"T = {shapes[0]}")

    got = df.to_numpy()
    check_q1(got, schema, cols)
    log("phase 4: result equals the numpy computation exactly")
    check_answers(got, schema, 1)
    INCORE_ANSWERS[1] = got
    log("phase 4: result equals answers/sf1/answers/q1.out exactly")

    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    WARM_MS[1] = med * 1e3
    log(f"phase 4: warm runs (s) {[round(w, 6) for w in warm]}")
    log(f"phase 4: warm median {med * 1e3:.3f} ms, "
        f"{LINEITEM_ROWS / med:.0f} rows/s")
    return launches, calls[0]


def phase_q1_inputs(slot, rows, T):
    """Both entries against their plain versions on the very tensors Q1's
    aggregate passed the kernel. Real slots put about half the rows into
    one slot and nearly all into three of the 12, where phase 3's uniform
    slots spread them evenly."""
    described = [("ones" if d is None and v is None else
                  "count" if d is None else str(d.dtype).split(".")[1])
                 for d, v in rows]
    log(f"phase 5: Q1's rows: {described}; "
        f"{len(row_columns(rows))} distinct columns")
    return hold_call(5, "Q1's own kernel inputs", slot, rows, T)


def numpy_q5(tables):
    """Q5 over the host columns in numpy: {n_name: revenue at scale 4}."""
    def col(table, name):
        return tables[table][1][name]

    def decode(table, name):
        c = col(table, name)
        return c.dictionary[c.values]

    asia = col("region", "r_regionkey").values[
        decode("region", "r_name") == "ASIA"]
    n_key = col("nation", "n_nationkey").values
    n_asia = np.isin(col("nation", "n_regionkey").values, asia)
    nation_name = dict(zip(n_key, decode("nation", "n_name")))
    # dense key -> attribute lookups (keys are 1..N, order keys sparse)
    s_nation = np.full(col("supplier", "s_suppkey").values.max() + 1, -1)
    s_nation[col("supplier", "s_suppkey").values] = \
        col("supplier", "s_nationkey").values
    c_nation = np.full(col("customer", "c_custkey").values.max() + 1, -1)
    c_nation[col("customer", "c_custkey").values] = \
        col("customer", "c_nationkey").values
    odate = col("orders", "o_orderdate").values
    o_ok = (odate >= parse_date("1994-01-01")) & (odate < parse_date("1995-01-01"))
    okey = col("orders", "o_orderkey").values
    o_cnation = np.full(okey.max() + 1, -1)
    o_cnation[okey[o_ok]] = c_nation[col("orders", "o_custkey").values[o_ok]]
    l_cn = o_cnation[col("lineitem", "l_orderkey").values]
    l_sn = s_nation[col("lineitem", "l_suppkey").values]
    m = (l_cn >= 0) & (l_cn == l_sn) & n_asia[np.clip(l_sn, 0, None)]
    rev = (col("lineitem", "l_extendedprice").values[m]
           * (100 - col("lineitem", "l_discount").values[m]))
    out = {}
    for nk in np.unique(l_sn[m]):
        out[nation_name[nk]] = int(rev[l_sn[m] == nk].sum())
    return out


def check_q5(got, tables):
    want = numpy_q5(tables)
    mine = {k: int(v) for k, v in zip(got["n_name"][0], got["revenue"][0])}
    if mine != want or list(got["revenue"][0]) != sorted(want.values(),
                                                         reverse=True):
        raise AssertionError(f"Q5 {mine} != numpy {want}")


def run_query(ctx, q, phase, with_sql=False):
    """First run (with every masked_slot_sums_rows call of the aggregate
    operator recorded), answer check, warm median of 10. `with_sql` times
    `ctx.sql(text).collect()`
    (planning and scalar subqueries included), else `collect()` of one
    planned DataFrame. Returns ((launches through masked_slot_sums_rows,
    through masked_slot_sums), calls, rows)."""
    def run():
        return (ctx.sql(TPCH_QUERIES[q]) if with_sql else df).collect()

    df = None if with_sql else ctx.sql(TPCH_QUERIES[q])
    reset_counts()
    with spy_rows() as calls:
        t0 = time.perf_counter()
        batch, schema = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"phase {phase}: Q{q} first run {first_s:.4f} s; masked_slot_sums_rows "
        f"launches {launches[0]}, masked_slot_sums launches {launches[1]}, "
        f"calls at (A, n), T = {call_shapes(calls)}")
    got = to_numpy(batch, schema)
    check_answers(got, schema, q)
    INCORE_ANSWERS[q] = got
    log(f"phase {phase}: Q{q} result equals answers/sf1/answers/q{q}.out "
        "exactly")
    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    WARM_MS.setdefault(q, med * 1e3)
    log(f"phase {phase}: Q{q} warm runs (s) {[round(w, 6) for w in warm]}")
    log(f"phase {phase}: Q{q} warm median {med * 1e3:.3f} ms, "
        f"{LINEITEM_ROWS / med:.0f} lineitem rows/s")
    return launches, calls, got


def phase_joins():
    t0 = time.perf_counter()
    tables = generate_tpch(SF, SEED)
    n_rows = {name: len(cols[f[0].name].values)
              for name, (f, cols) in tables.items()}
    if n_rows["lineitem"] != LINEITEM_ROWS:
        raise AssertionError(f"lineitem has {n_rows['lineitem']} rows at SF1")
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in tables.items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    for q in (3, 5):
        df = ctx.sql(TPCH_QUERIES[q])
        ctx.bind_inputs([leaf.input_id
                         for leaf in ctx.physical_plan(df.plan).leaves()])
    torch.cuda.synchronize()
    log(f"phase 6: datagen + upload {time.perf_counter() - t0:.3f} s "
        f"({n_rows})")

    q3_launches, _, _ = run_query(ctx, 3, 6)
    q5_launches, calls, got = run_query(ctx, 5, 6)
    if q5_launches[0] < 1:
        raise AssertionError("Q5 ran without launching masked_slot_sums_rows")
    shapes = call_shapes(calls)
    if shapes != [((Q5_A, Q1_N), Q5_T)]:
        raise AssertionError(f"Q5's kernel calls {shapes} differ from "
                             f"({Q5_A}, {Q1_N}), {Q5_T}")
    check_q5(got, tables)
    log("phase 6: Q5 result equals the numpy computation exactly")

    held = hold_call(6, "Q5's own kernel inputs", *calls[0])
    return q3_launches + q5_launches, held, ctx


SIX_TABLE_REST = (4, 6, 7, 10, 12, 13, 15, 18, 21, 22)


def phase_rest(ctx):
    """The remaining six-table queries on phase 6's context. Returns
    (kernel launches over their first runs, max |kernel - plain|)."""
    joins = []
    real = plan_mod.expand_join

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        joins.append(out)
        return out

    total_launches, max_err, kernel_calls = 0, 0, {}
    for q in SIX_TABLE_REST:
        joins.clear()
        n_warn = len(ctx.warnings)
        plan_mod.expand_join = spy
        try:
            launches, calls, _ = run_query(ctx, q, 7, with_sql=True)
        finally:
            plan_mod.expand_join = real
        total_launches += launches
        kernel_calls[q] = (launches, calls)
        # every run repeats the same expanding joins: log each once
        for rows, cap, need in sorted({(int(em.total), em.valid.shape[0],
                                        int(em.need)) for em in joins}):
            log(f"phase 7: Q{q} expanding join: {rows} output rows of "
                f"capacity {cap}, needed {need}, overflow {need > cap}")
        retries = ctx.warnings[n_warn:]
        log(f"phase 7: Q{q} overflow retries over its 11 runs: "
            f"{len(retries)}{(': ' + retries[0]) if retries else ''}")
    for q, T in ((6, 1), (12, 8)):
        launches, calls = kernel_calls[q]
        if launches[0] < 1:
            raise AssertionError(
                f"Q{q} ran without launching masked_slot_sums_rows")
        # the main plan's call: the one at T (Q15/Q22-style subqueries
        # would come first)
        call = next(c for c in calls if c[2] == T)
        max_err = max(max_err, held_err(
            hold_call(7, f"Q{q}'s own kernel inputs", *call)))
    max_err = max(max_err, hold_small_calls(7, kernel_calls, (4, 15, 22)))
    return total_launches, max_err


def hold_small_calls(phase, kernel_calls, queries):
    """The kernel against its plain version on every distinct call shape
    these queries made: calls over 10^4 to 10^6 rows, whose device work is
    short beside the host's time per call (printed with each)."""
    max_err = 0
    for q in queries:
        launches, calls = kernel_calls[q]
        if launches[0] < 1:
            raise AssertionError(
                f"Q{q} ran without launching masked_slot_sums_rows")
        seen = set()
        for slot, rows, T in calls:
            shape = (slot.shape[0], T, len(rows))
            if shape not in seen:
                seen.add(shape)
                max_err = max(max_err, held_err(hold_call(
                    phase, f"Q{q}'s own kernel inputs", slot, rows, T)))
    return max_err


REST = (2, 8, 9, 11, 14, 16, 17, 19, 20)


def phase_rest_part(ctx):
    """The nine part/partsupp queries on phase 6's context. Returns
    (kernel launches over their first runs, max |kernel - plain|)."""
    total_launches, max_err, kernel_calls = 0, 0, {}
    for q in REST:
        n_warn = len(ctx.warnings)
        launches, calls, _ = run_query(ctx, q, 8, with_sql=True)
        total_launches += launches
        kernel_calls[q] = (launches, calls)
        retries = ctx.warnings[n_warn:]
        log(f"phase 8: Q{q} overflow retries over its 11 runs: "
            f"{len(retries)}{(': ' + retries[0]) if retries else ''}")
    for q in (14, 17, 19):
        launches, calls = kernel_calls[q]
        if launches[0] < 1 or not any(T == 1 for _, _, T in calls):
            raise AssertionError(f"Q{q} ran without the kernel at T = 1")
        call = next(c for c in calls if c[2] == 1)
        max_err = max(max_err, held_err(
            hold_call(8, f"Q{q}'s own kernel inputs", *call)))
    max_err = max(max_err, hold_small_calls(8, kernel_calls, (11, 16)))
    # host work of the LIKE queries: planning (which binds the LIKE) and
    # the lookup table alone over p_name's dictionary
    p_name = ctx.tables["part"].host["p_name"].dictionary
    for q, pattern in ((9, "%green%"), (20, "forest%")):
        t0 = time.perf_counter()
        plan = ctx.sql(TPCH_QUERIES[q]).plan
        sql_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.physical_plan(plan)
        phys_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = int(like_lut(p_name, pattern).sum())
        lut_s = time.perf_counter() - t0
        log(f"phase 8: Q{q} host: sql() {sql_s * 1e3:.3f} ms, physical plan "
            f"{phys_s * 1e3:.3f} ms, like_lut({pattern!r}) over {len(p_name)} "
            f"p_name entries {lut_s * 1e3:.3f} ms ({hits} hits)")
    return total_launches, max_err


def _host(ctx, table, name):
    """The values of one registered host column; strings decoded. (The
    generated columns have no NULLs.)"""
    c = ctx.tables[table].host[name]
    if c.dictionary is not None:
        return c.dictionary[c.values].astype(str)
    return c.values


def _row_key(row):
    """Sort key for rows that hold NULLs (None sorts last)."""
    return tuple((x is None, 0 if x is None else x) for x in row)


def _rows(got, names):
    """Output rows as tuples of Python values, NULL as None, sorted."""
    cols = [(v.tolist(), ok.tolist()) for v, ok in (got[n] for n in names)]
    rows = [tuple(v[i] if ok[i] else None for v, ok in cols)
            for i in range(len(cols[0][0]))]
    return sorted(rows, key=_row_key)


def _timed(ctx, sql, phase, label):
    """First run and warm median of 3 of ctx.sql(sql).collect(); the
    answer as host columns."""
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        batch, schema = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"phase {phase}: {label}: {int(batch.num_rows)} rows; first run "
        f"{times[0]:.4f} s, warm median {statistics.median(times[1:]) * 1e3:.3f} ms")
    return to_numpy(batch, schema)


def _check(label, got, want):
    if got != want:
        bad = next((g, w) for g, w in zip(got + [None] * len(want),
                                          want + [None] * len(got)) if g != w)
        raise AssertionError(f"{label}: {len(got)} rows vs numpy {len(want)}; "
                             f"first difference {bad}")
    log(f"phase 9: {label} equals the numpy computation exactly")


def _full_outer_numpy(left, right):
    """FULL OUTER JOIN of [(key, payload)] lists on key: sorted rows."""
    by_key = {}
    for k, v in right:
        by_key.setdefault(k, []).append(v)
    matched, out = set(), []
    for k, v in left:
        for w in by_key.get(k, []):
            out.append((k, v, k, w))
            matched.add(k)
        if k not in by_key:
            out.append((k, v, None, None))
    for k, w in right:
        if k not in matched:
            out.append((None, None, k, w))
    return sorted(out, key=_row_key)


def phase_setops(ctx):
    # full outer, unique path: both keys are primary keys; part keys
    # in the gaps of the sparse order keys, and order keys past the last
    # part, stay unmatched
    sql = """select p_partkey, p_size, o_orderkey, o_totalprice
             from part full outer join orders on p_partkey = o_orderkey"""
    plan = ctx.physical_plan(ctx.sql(sql).plan).display()
    if "HashJoinExec[full_outer,unique]" not in plan:
        raise AssertionError(f"full outer (unique) plan:\n{plan}")
    got = _timed(ctx, sql, 9, "full outer join, unique path")
    part_k = _host(ctx, "part", "p_partkey")
    part_size = _host(ctx, "part", "p_size")
    ord_k = _host(ctx, "orders", "o_orderkey")
    ord_price = _host(ctx, "orders", "o_totalprice")
    (p, p_ok), (o, o_ok) = got["p_partkey"], got["o_orderkey"]
    both = p_ok & o_ok
    by_order = np.argsort(ord_k)
    checks = {
        "row count": len(p) == len(np.union1d(part_k, ord_k)),
        "no all-NULL row": bool((p_ok | o_ok).all()),
        "matched keys": np.array_equal(np.sort(p[both]),
                                       np.intersect1d(part_k, ord_k))
                        and np.array_equal(p[both], o[both]),
        "unmatched parts": np.array_equal(np.sort(p[p_ok & ~o_ok]),
                                          np.setdiff1d(part_k, ord_k)),
        "unmatched orders": np.array_equal(np.sort(o[o_ok & ~p_ok]),
                                           np.setdiff1d(ord_k, part_k)),
        "p_size": np.array_equal(got["p_size"][0][p_ok],
                                 part_size[p[p_ok] - 1]),
        "o_totalprice": np.array_equal(
            got["o_totalprice"][0][o_ok],
            ord_price[by_order[np.searchsorted(ord_k[by_order], o[o_ok])]]),
    }
    if not all(checks.values()) or both.all() or (p_ok & ~o_ok).sum() == 0:
        raise AssertionError(f"full outer join, unique path: {checks}")
    log(f"phase 9: full outer join, unique path equals the numpy computation "
        f"exactly ({int(both.sum())} matched, {int((p_ok & ~o_ok).sum())} "
        f"parts and {int((o_ok & ~p_ok).sum())} orders unmatched)")

    # full outer, expanding path: nation keys repeat on both sides
    sk = _host(ctx, "supplier", "s_suppkey")
    ck = _host(ctx, "customer", "c_custkey")
    sql = """select s_nationkey, s_suppkey, c_nationkey, c_custkey from
             (select s_suppkey, s_nationkey from supplier
              where s_suppkey <= 400 and s_nationkey < 20) s
             full outer join
             (select c_custkey, c_nationkey from customer
              where c_custkey <= 3000 and c_nationkey > 4) c
             on s_nationkey = c_nationkey"""
    plan = ctx.physical_plan(ctx.sql(sql).plan).display()
    if "HashJoinExec[full_outer,expanding]" not in plan:
        raise AssertionError(f"full outer (expanding) plan:\n{plan}")
    got = _timed(ctx, sql, 9, "full outer join, expanding path")
    sn = _host(ctx, "supplier", "s_nationkey")
    cn = _host(ctx, "customer", "c_nationkey")
    ms, mc = (sk <= 400) & (sn < 20), (ck <= 3000) & (cn > 4)
    want = _full_outer_numpy(list(zip(sn[ms].tolist(), sk[ms].tolist())),
                             list(zip(cn[mc].tolist(), ck[mc].tolist())))
    if not (any(r[0] is None for r in want) and any(r[2] is None
                                                    for r in want)):
        raise AssertionError("full outer (expanding): a side has no "
                             "unmatched row")
    mine = _rows(got, ["s_nationkey", "s_suppkey", "c_nationkey",
                       "c_custkey"])
    _check("full outer join, expanding path", mine, want)

    # UNION ALL and UNION over differing dictionaries
    sql = """select c_mktsegment as w, c_custkey as k from customer
             union all select p_container, p_partkey from part"""
    plan = ctx.physical_plan(ctx.sql(sql).plan).display()
    if "DictRemapExec" not in plan:
        raise AssertionError(f"UNION ALL plan:\n{plan}")
    got = _timed(ctx, sql, 9, "UNION ALL")
    seg = _host(ctx, "customer", "c_mktsegment")
    cont = _host(ctx, "part", "p_container")
    pk = _host(ctx, "part", "p_partkey")
    want = sorted(list(zip(seg.tolist(), ck.tolist()))
                  + list(zip(cont.tolist(), pk.tolist())), key=_row_key)
    _check("UNION ALL", _rows(got, ["w", "k"]), want)
    sql = """select c_mktsegment as w from customer
             union select p_mfgr from part
             union select p_container from part where p_size < 3"""
    got = _timed(ctx, sql, 9, "UNION")
    mfgr = _host(ctx, "part", "p_mfgr")
    size = _host(ctx, "part", "p_size")
    want = sorted(((w,) for w in set(seg) | set(mfgr) | set(cont[size < 3])),
                  key=_row_key)
    _check("UNION", _rows(got, ["w"]), want)

    # a theta join whose product passes CrossJoinExec.MAX_CELLS
    sb = _host(ctx, "supplier", "s_acctbal")
    cb = _host(ctx, "customer", "c_acctbal")
    sql = """select s_suppkey, c_custkey from supplier, customer
             where c_acctbal - s_acctbal > 10950"""
    plan = ctx.physical_plan(ctx.sql(sql).plan).display()
    nlj = [line.strip() for line in plan.splitlines()
           if "NestedLoopJoinExec" in line]
    if not nlj or int(nlj[0].split("chunks=")[1].rstrip(")")) < 2:
        raise AssertionError(f"theta join plan:\n{plan}")
    log(f"phase 9: theta join plan: {nlj[0]}")
    got = _timed(ctx, sql, 9, "theta join supplier x customer")
    order = np.argsort(cb, kind="stable")
    cb_sorted = cb[order]
    want = []
    for s_key, s_bal in zip(sk.tolist(), sb.tolist()):
        lo = np.searchsorted(cb_sorted, s_bal + 1_095_000, side="right")
        want += [(s_key, int(c)) for c in ck[order[lo:]]]
    want.sort(key=_row_key)
    if len(want) < 100:
        raise AssertionError(f"theta join: only {len(want)} rows expected")
    _check("theta join supplier x customer", _rows(got, ["s_suppkey",
                                                         "c_custkey"]), want)


def _timed_sql(ctx, name, runs=4):
    """ANALYTIC_QUERIES[name] through ctx.sql(text).collect(): the kernel's
    launches on the first run, first-run and warm-median times, the answer
    as host columns."""
    sql = ANALYTIC_QUERIES[name]
    times = []
    for i in range(runs):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        batch, schema = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_counts()
    log(f"phase 10: {name}: {int(batch.num_rows)} rows; first run "
        f"{times[0]:.4f} s, warm median "
        f"{statistics.median(times[1:]) * 1e3:.3f} ms; masked_slot_sums_rows "
        f"launches {launches[0]}")
    return to_numpy(batch, schema), launches


def _close(label, got, want, rtol):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} vs numpy {want.shape}")
    err = float(np.max(np.abs(got - want) / np.abs(want))) if got.size else 0.0
    if not err <= rtol:
        raise AssertionError(f"{label}: max relative error {err:.3e} > {rtol}")
    log(f"phase 10: {label}: within rtol {rtol} of numpy (max relative error "
        f"{err:.3e})")


def _exact(label, got, want):
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        bad = np.nonzero(np.asarray(got) != np.asarray(want))[0]
        raise AssertionError(f"{label}: {len(bad)} of {len(want)} differ from "
                             f"numpy, first at row {bad[0]}: {got[bad[0]]} vs "
                             f"{want[bad[0]]}")
    log(f"phase 10: {label}: equals the numpy computation exactly "
        f"({len(want)} values)")


def _all_valid(got, names):
    for n in names:
        if not got[n][1].all():
            raise AssertionError(f"NULL in {n}")


def _numpy_moments(gid, x, y):
    """Per group of `gid` (0..G-1, every group present), two passes in f64:
    (stddev_samp(x), var_pop(y), corr(x, y))."""
    n = np.bincount(gid).astype(float)
    dx = x - (np.bincount(gid, x) / n)[gid]
    dy = y - (np.bincount(gid, y) / n)[gid]
    sxx, syy = np.bincount(gid, dx * dx), np.bincount(gid, dy * dy)
    return (np.sqrt(sxx / (n - 1)), syy / n,
            np.bincount(gid, dx * dy) / np.sqrt(sxx * syy))


def analytic_moments(ctx):
    qty = _raw(ctx, "lineitem", "l_quantity") / 100.0
    price = _raw(ctx, "lineitem", "l_extendedprice") / 100.0
    flag, status = (ctx.tables["lineitem"].host[c]
                    for c in ("l_returnflag", "l_linestatus"))
    total = np.zeros(2, dtype=np.int64)
    for name, key, result_key in (
            ("moments_masked",
             flag.values.astype(np.int64) * len(status.dictionary)
             + status.values,
             lambda g: np.searchsorted(flag.dictionary.astype(str),
                                       g["l_returnflag"][0].astype(str))
             * len(status.dictionary)
             + np.searchsorted(status.dictionary.astype(str),
                               g["l_linestatus"][0].astype(str))),
            ("moments_sorted", _raw(ctx, "lineitem", "l_suppkey"),
             lambda g: g["l_suppkey"][0])):
        got, launches = _timed_sql(ctx, name)
        total += launches
        _all_valid(got, ("sd", "vp", "c"))
        groups, gid = np.unique(key, return_inverse=True)
        order = np.argsort(result_key(got))
        _exact(f"{name} groups", result_key(got)[order], groups)
        for col, want in zip(("sd", "vp", "c"),
                             _numpy_moments(gid, qty, price)):
            _close(f"{name} {col}", got[col][0][order], want, MOMENT_RTOL)
    return total


def analytic_percentiles(ctx):
    price = _raw(ctx, "lineitem", "l_extendedprice") / 100.0
    mode = ctx.tables["lineitem"].host["l_shipmode"]
    got, launches = _timed_sql(ctx, "percentiles_grouped")
    _all_valid(got, ("m", "p90"))
    order = np.argsort(got["l_shipmode"][0].astype(str))
    _exact("percentiles_grouped groups",
           got["l_shipmode"][0].astype(str)[order],
           np.sort(mode.dictionary.astype(str)))
    by_name = np.argsort(mode.dictionary.astype(str))
    want = np.array([np.quantile(price[mode.values == k], [0.5, 0.9])
                     for k in by_name])
    _close("median by l_shipmode", got["m"][0][order], want[:, 0],
           PERCENTILE_RTOL)
    _close("percentile_cont(0.9) by l_shipmode", got["p90"][0][order],
           want[:, 1], PERCENTILE_RTOL)
    got, more = _timed_sql(ctx, "percentiles_global")
    _all_valid(got, ("m", "p90"))
    _close("median and percentile_cont(0.9), ungrouped",
           [got["m"][0][0], got["p90"][0][0]], np.quantile(price, [0.5, 0.9]),
           PERCENTILE_RTOL)
    return launches + more


def analytic_partial_final(ctx):
    """Q1's aggregate split in two phases: `partial` over each half of
    lineitem, CoalesceExec, `final`, under Q1's own projection and sort.
    Returns (launches, the final node's kernel call)."""
    df = ctx.sql(TPCH_QUERIES[1])
    sort = ctx.physical_plan(df.plan)
    project, = sort.children
    single, = project.children
    leaf, = single.children
    if not (isinstance(single, plan_mod.HashAggregateExec)
            and isinstance(leaf, plan_mod.InputLeaf)):
        raise AssertionError(f"Q1's plan changed:\n{sort.display()}")
    whole = ctx.bind_inputs([leaf.input_id])[leaf.input_id]
    half = round_capacity(LINEITEM_ROWS // 2)
    n_rows = int(whole.num_rows)
    inputs, partials = {}, []
    for name, lo, hi, rows in (("half0", 0, half, half),
                               ("half1", half, whole.capacity,
                                n_rows - half)):
        inputs[name] = Batch(
            tuple(Column(c.data[lo:hi], c.validity[lo:hi])
                  for c in whole.columns),
            torch.tensor(rows, dtype=torch.int32, device=whole.device))
        partials.append(plan_mod.HashAggregateExec(
            plan_mod.InputLeaf(name, leaf.schema, hi - lo),
            single.group_exprs, single.aggs, mode="partial",
            group_names=single._group_names, pre_filter=single.pre_filter))
    keys = single._group_names
    final = plan_mod.HashAggregateExec(
        plan_mod.CoalesceExec(partials), [Col(k) for k in keys], single.aggs,
        mode="final", group_names=keys)
    plan = plan_mod.SortExec(
        plan_mod.ProjectExec(final, project.exprs,
                             names=[f.name for f in project.schema.fields]),
        sort.keys)
    log(f"phase 10: partial -> final plan:\n{plan.display().rstrip()}")
    times = []
    for i in range(4):
        if i == 0:
            reset_counts()
        with spy_rows() as calls:
            t0 = time.perf_counter()
            batch, overflow = plan_mod.run_plan(plan, inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if i == 0:
            launches, first_calls = read_counts(), list(calls)
    if overflow is not None and bool(overflow):
        raise AssertionError("partial -> final overflowed")
    merged = [c for c in first_calls if c[0].shape[0] == 2 * 128]
    if launches[0] < 3 or len(merged) != 1 or merged[0][2] != Q1_T:
        raise AssertionError(
            "the final aggregate did not launch masked_slot_sums_rows at "
            f"T = {Q1_T} over the two partials' 256 state rows: launches "
            f"{launches}, calls {call_shapes(first_calls)}")
    log(f"phase 10: partial -> final: first run {times[0]:.4f} s, warm median "
        f"{statistics.median(times[1:]) * 1e3:.3f} ms; masked_slot_sums_rows "
        f"launches {launches[0]}, calls at (A, n), T = "
        f"{call_shapes(first_calls)}")
    got = to_numpy(batch, plan.schema)
    want = df.to_numpy()
    if list(got) != list(want):
        raise AssertionError(f"partial -> final columns {list(got)}")
    for name in want:
        if not (np.array_equal(got[name][0], want[name][0])
                and np.array_equal(got[name][1], want[name][1])):
            raise AssertionError(f"partial -> final differs from the single "
                                 f"aggregate in {name}")
    check_answers(got, plan.schema, 1)
    log("phase 10: partial -> final equals the single-mode Q1 answer and "
        "answers/sf1/answers/q1.out exactly")
    return launches, merged[0]


def _runs(part, *order):
    """Rows sorted by (part, *order): (sort index, position, partition
    start and end per sorted position, partition-first flags)."""
    idx = np.lexsort(tuple(reversed((part,) + order)))
    sp = part[idx]
    n = len(idx)
    pos = np.arange(n)
    first = np.r_[True, sp[1:] != sp[:-1]]
    last = np.r_[first[1:], True]
    start = np.maximum.accumulate(np.where(first, pos, 0))
    end = np.minimum.accumulate(np.where(last, pos, n - 1)[::-1])[::-1]
    return idx, pos, start, end, first


def _unsort(idx, values):
    out = np.empty_like(values)
    out[idx] = values
    return out


def _shifted(x, pos, k, lo, hi):
    """(x at sorted position pos + k, whether that lies in [lo, hi])."""
    src = pos + k
    ok = (src >= lo) & (src <= hi)
    return x[np.clip(src, 0, len(x) - 1)], ok


def analytic_windows(ctx):
    okey = _raw(ctx, "lineitem", "l_orderkey")
    line = _raw(ctx, "lineitem", "l_linenumber").astype(np.int64)
    qty = _raw(ctx, "lineitem", "l_quantity")
    price = _raw(ctx, "lineitem", "l_extendedprice")
    ship = _raw(ctx, "lineitem", "l_shipdate")
    idx, pos, start, end, _ = _runs(okey, line)
    sq, sp_, ss = qty[idx], price[idx], ship[idx]
    depth = int((end - start).max())
    total = np.zeros(2, dtype=np.int64)

    def run(name):
        got, launches = _timed_sql(ctx, name)
        total[:] += launches
        # the operator is positional: rows come back in table order
        _exact(f"{name} row order", got["l_orderkey"][0] * 8
               + got["l_linenumber"][0], okey * 8 + line)
        return got

    got = run("window_running")
    _all_valid(got, ("rn", "run"))
    _exact("row_number", got["rn"][0], _unsort(idx, pos - start + 1))
    csum = np.cumsum(sq)
    _exact("running sum(l_quantity)", got["run"][0],
           _unsort(idx, csum - (csum - sq)[start]))

    got = run("window_navigation")
    for col, (want, ok) in (
            ("prev", _shifted(sq, pos, -1, start, end)),
            ("nxt", _shifted(sp_, pos, 2, start, end)),
            ("fv", (ss[start], np.ones(len(pos), dtype=bool)))):
        _exact(f"{col} validity", got[col][1], _unsort(idx, ok))
        _exact(col, got[col][0][got[col][1]], _unsort(idx, want)[got[col][1]])

    def extrema(k_max):
        """min(price) and max(qty) over the k_max rows before and the row."""
        mn, mx = sp_.copy(), sq.copy()
        for k in range(1, k_max + 1):
            v, ok = _shifted(sp_, pos, -k, start, end)
            mn = np.where(ok, np.minimum(mn, v), mn)
            v, ok = _shifted(sq, pos, -k, start, end)
            mx = np.where(ok, np.maximum(mx, v), mx)
        return _unsort(idx, mn), _unsort(idx, mx)

    for name, (mn, mx) in (
            ("window_framed_extrema", extrema(2)),
            ("window_running_extrema", extrema(depth)),
            ("window_partition_extrema",
             (_unsort(idx, np.minimum.reduceat(
                 sp_, np.unique(start))[np.searchsorted(np.unique(start),
                                                        start)]),
              _unsort(idx, np.maximum.reduceat(
                  sq, np.unique(start))[np.searchsorted(np.unique(start),
                                                        start)])))):
        got = run(name)
        _all_valid(got, ("mn", "mx"))
        _exact(f"{name} min(l_extendedprice)", got["mn"][0], mn)
        _exact(f"{name} max(l_quantity)", got["mx"][0], mx)

    cust = _raw(ctx, "orders", "o_custkey")
    got, launches = _timed_sql(ctx, "window_ranks")
    total += launches
    _exact("window_ranks row order", got["o_orderkey"][0],
           _raw(ctx, "orders", "o_orderkey"))
    _all_valid(got, ("rk", "dr", "rp", "dp"))
    # o_totalprice hardly ever ties within a customer; o_orderpriority's
    # five values (codes in dictionary order) tie all the time
    for rank, dense, key in (
            ("rk", "dr", -_raw(ctx, "orders", "o_totalprice")),
            ("rp", "dp", _raw(ctx, "orders", "o_orderpriority"))):
        idx, pos, start, _, first = _runs(cust, key)
        k = key[idx]
        peer_first = first | np.r_[True, k[1:] != k[:-1]]
        peer_start = np.maximum.accumulate(np.where(peer_first, pos, 0))
        _exact(f"rank {rank}", got[rank][0],
               _unsort(idx, peer_start - start + 1))
        run_no = np.cumsum(peer_first)
        _exact(f"dense_rank {dense}", got[dense][0],
               _unsort(idx, run_no - run_no[start] + 1))
    if not (got["rp"][0] != got["dp"][0]).any():
        raise AssertionError("window_ranks: no ties, rank == dense_rank")
    return total


def analytic_setops(ctx):
    cust = _raw(ctx, "orders", "o_custkey")
    nation = _raw(ctx, "customer", "c_nationkey")
    size = int(max(cust.max(), nation.max())) + 1
    left, right = np.bincount(cust, minlength=size), \
        np.bincount(nation, minlength=size)
    total = np.zeros(2, dtype=np.int64)
    for name, want in (("intersect_all", np.minimum(left, right)),
                       ("except_all", np.maximum(left - right, 0))):
        got, launches = _timed_sql(ctx, name)
        total += launches
        _all_valid(got, ("o_custkey",))
        if not 0 < want.sum() < len(cust):
            raise AssertionError(f"{name}: the bags do not overlap in part")
        _exact(f"{name} copies per key",
               np.bincount(got["o_custkey"][0], minlength=size), want)
    return total


def analytic_converge(ctx):
    """Q21 planned once: `converge` gives the plan that ran without
    overflow, `run_plan` runs it again without planning."""
    df = ctx.sql(TPCH_QUERIES[21])
    n_warn = len(ctx.warnings)
    t0 = time.perf_counter()
    plan, inputs, out = df.converge()
    torch.cuda.synchronize()
    log(f"phase 10: Q21 converge {time.perf_counter() - t0:.4f} s, "
        f"{len(ctx.warnings) - n_warn} overflow retries")

    def median_ms(fn):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3, result

    rerun_ms, (batch, overflow) = median_ms(
        lambda: plan_mod.run_plan(plan, inputs))
    if overflow is None or bool(overflow):
        raise AssertionError("Q21's converged plan overflowed when re-run")
    check_answers(to_numpy(batch, plan.schema), plan.schema, 21)
    collect_ms, _ = median_ms(df.collect)
    sql_ms, _ = median_ms(lambda: ctx.sql(TPCH_QUERIES[21]).collect())
    log(f"phase 10: Q21 run_plan on the converged plan {rerun_ms:.3f} ms "
        f"(median of 10, equals answers/sf1/answers/q21.out exactly); "
        f"collect() of the planned DataFrame {collect_ms:.3f} ms; "
        f"ctx.sql(text).collect() {sql_ms:.3f} ms")
    # evaluate calls per run: every distinct node once, against every
    # parent edge once when nothing is shared
    nodes, stack = {}, [plan]
    while stack:
        node = stack.pop()
        nodes[id(node)] = node
        stack.extend(node.children)
    run = plan_mod.Run(inputs)
    run.eval(plan)
    shared = {i: n.n_parents for i, n in nodes.items() if n.n_parents > 1}
    for i in shared:
        nodes[i].n_parents = 1
    try:
        unshared = plan_mod.Run(inputs)
        unshared.eval(plan)
    finally:
        for i, parents in shared.items():
            nodes[i].n_parents = parents
    if not run.evaluated == len(nodes) < unshared.evaluated:
        raise AssertionError(f"Q21: {run.evaluated} evaluate calls for "
                             f"{len(nodes)} nodes, {unshared.evaluated} "
                             "without sharing")
    log(f"phase 10: Q21 evaluate calls per run: {run.evaluated} with shared "
        f"subtrees ({[nodes[i]._label()[:40] for i in shared]}), "
        f"{unshared.evaluated} without")


def _raw(ctx, table, name):
    """The stored values of one registered host column (scaled integers
    for decimals, days for dates; the generated columns have no NULLs)."""
    return ctx.tables[table].host[name].values


def phase_analytic(ctx):
    """Returns (kernel launches over the first runs, max |kernel - plain|
    on the final aggregate's call)."""
    launches = analytic_moments(ctx)
    launches += analytic_percentiles(ctx)
    pf_launches, call = analytic_partial_final(ctx)
    err = held_err(hold_call(10, "the final aggregate's merge of Q1's "
                             "states", *call))
    launches += pf_launches + analytic_windows(ctx) + analytic_setops(ctx)
    analytic_converge(ctx)
    return launches, err




# ---------------------------------------------------------------------------
# phase 11: the client slice
# ---------------------------------------------------------------------------

H2O_N, H2O_K, H2O_SEED = 10 ** 7, 100, 42
H2O_JOIN_N = 10 ** 7
TAXI_N = 10 ** 7
SUM_RTOL = 1e-9     # f64 sums and averages: the card adds in no fixed order


def _register_numpy_timed(ctx, name, table, label):
    """`ctx.register_numpy` of a dict of numpy arrays and the ingest of
    every column, one after another (registration itself ingests
    nothing), with the seconds each column spent in `batch.ingest_column`."""
    import ballista_tpu_torch.batch as batch_mod
    ingest, took = batch_mod.ingest_column, []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        hc = ingest(*args, **kwargs)
        took.append(time.perf_counter() - t0)
        return hc

    batch_mod.ingest_column = timed
    t0 = time.perf_counter()
    try:
        ctx.register_numpy(name, table)
        for cname in table:
            ctx.tables[name].host[cname]
    finally:
        batch_mod.ingest_column = ingest
    total = time.perf_counter() - t0
    tp = ctx.tables[name]
    if len(took) != len(table):
        raise AssertionError(f"{name}: {len(took)} columns ingested of "
                             f"{len(table)}")
    for (cname, values), f, s in zip(table.items(), tp.fields, took):
        d = tp.host[cname].dictionary
        log(f"phase 11: {label}: ingest {name}.{cname} ({values.dtype}, "
            f"{len(values)} rows) as {f.dtype!r}: {s:.3f} s"
            + (f", {len(d)} dictionary entries" if d is not None else ""))
    log(f"phase 11: {label}: register_numpy({name!r}) {total:.3f} s in all")


def _raw_columns(batch, schema):
    """The live rows on the host as stored: name -> (values, validity),
    strings as their codes (a 10^7-row string column is not decoded)."""
    n = int(batch.num_rows)
    return {f.name: (c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
            for f, c in zip(schema.fields, batch.columns)}


def _id_numbers(raw, schema, name):
    """An h2o key column of a result as the numbers the generator drew:
    "id<k>" strings through their dictionary, integers as they are."""
    values, valid = raw[name]
    if not valid.all():
        raise AssertionError(f"NULL in key {name}")
    d = schema.dictionary(name)
    if d is None:
        return values.astype(np.int64)
    lut = np.array([int(s[2:]) for s in d], dtype=np.int64)
    return lut[values]


def _combined(keys, widths):
    out = np.zeros(len(keys[0]), dtype=np.int64)
    for k, w in zip(keys, widths):
        out = out * w + k
    return out


def _layouts(ctx, sql):
    """The layout of every aggregate in the query's physical plan."""
    out, stack = [], [ctx.physical_plan(ctx.sql(sql).plan)]
    while stack:
        node = stack.pop()
        if isinstance(node, plan_mod.HashAggregateExec):
            out.append("masked" if node._masked else "sorted")
        stack.extend(node.children)
    return out or ["no aggregate"]


def _timed_question(ctx, label, sql, phase=11):
    """First run and warm median of 3 of ctx.sql(sql).collect(): returns
    (batch, schema, kernel launches on the first run, overflow retries)."""
    n_warn = len(ctx.warnings)
    times = []
    for i in range(4):
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        batch, schema = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_counts()
            retries = ctx.warnings[n_warn:]
    log(f"phase {phase}: {label}: {int(batch.num_rows)} rows; first run "
        f"{times[0]:.4f} s, warm median "
        f"{statistics.median(times[1:]) * 1e3:.3f} ms; aggregate layout "
        f"{_layouts(ctx, sql)}; masked_slot_sums_rows launches {launches[0]}; "
        f"overflow retries per run {len(retries)}"
        + (f" ({retries[-1]})" if retries else ""))
    return batch, schema, launches, len(retries)


# a correlation is a quotient of sums that cancel: where it comes out
# below this, its error is held relative to this and not to itself
CORR_FLOOR = 1e-6


def _held(label, got, want, rtol=None, floor=0.0):
    """`got` against numpy's `want`: exactly, or within `rtol` of the
    larger of |want| and `floor`."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} vs numpy {want.shape}")
    if rtol is None:
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            raise AssertionError(
                f"{label}: {len(bad)} of {len(want)} differ from numpy, first "
                f"at {bad[0]}: {got[bad[0]]} vs {want[bad[0]]}")
        return "exact"
    # relative to numpy's value; where that is 0, the difference itself
    scale = np.maximum(np.abs(want), floor)
    scale = np.where(scale == 0, 1.0, scale)
    err = float(np.max(np.abs(got - want) / scale)) if got.size else 0.0
    if not err <= rtol:
        raise AssertionError(f"{label}: max relative error {err:.3e} > {rtol}")
    return f"max relative error {err:.3e} within {rtol}"


def _group_stats(gid, n_groups):
    """Helpers over group ids 0..G-1 (every group present): counts, and a
    function giving the rows' order by (group, value) with run starts."""
    counts = np.bincount(gid, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def sorted_by(values):
        return np.lexsort((values, gid))
    return counts, starts, sorted_by


def h2o_groupby_expected(q, t, ids):
    """Question q over the generated table in numpy: (key names, key
    widths, combined group key per row, {output column: (per-group values
    in the order of the sorted combined keys, rtol or None)}). `ids` holds
    the numbers behind the "id<k>" strings."""
    nk = max(H2O_N // H2O_K, 1)
    width = {"id1": H2O_K + 1, "id2": H2O_K + 1, "id3": nk + 1,
             "id4": H2O_K + 1, "id5": H2O_K + 1, "id6": nk + 1}
    names = {1: ["id1"], 2: ["id1", "id2"], 3: ["id3"], 4: ["id4"],
             5: ["id6"], 6: ["id4", "id5"], 7: ["id3"], 9: ["id2", "id4"],
             10: ["id1", "id2", "id3", "id4", "id5", "id6"]}[q]
    widths = [width[n] for n in names]
    key = _combined([ids[n] for n in names], widths)
    groups, gid = np.unique(key, return_inverse=True)
    gid = gid.reshape(-1)
    G = len(groups)
    counts, starts, sorted_by = _group_stats(gid, G)
    v1, v2, v3 = t["v1"], t["v2"], t["v3"]

    def isum(v):         # integer sums stay below 2^53: exact in f64
        return np.bincount(gid, v, minlength=G).astype(np.int64)

    def fsum(v):
        return np.bincount(gid, v, minlength=G)

    if q in (1, 2):
        out = {"v1": (isum(v1), None)}
    elif q == 3:
        out = {"v1": (isum(v1), None), "v3": (fsum(v3) / counts, SUM_RTOL)}
    elif q == 4:
        out = {c: (fsum(v) / counts, SUM_RTOL)
               for c, v in (("v1", v1), ("v2", v2), ("v3", v3))}
    elif q == 5:
        out = {"v1": (isum(v1), None), "v2": (isum(v2), None),
               "v3": (fsum(v3), SUM_RTOL)}
    elif q == 6:
        sv = v3[sorted_by(v3)]
        pos = starts + (counts - 1) / 2.0
        lo, hi = np.floor(pos).astype(np.int64), np.ceil(pos).astype(np.int64)
        median = sv[lo] + (sv[hi] - sv[lo]) * (pos - lo)
        d = v3 - (fsum(v3) / counts)[gid]
        with np.errstate(invalid="ignore", divide="ignore"):
            sd = np.sqrt(fsum(d * d) / (counts - 1))
        out = {"median_v3": (median, PERCENTILE_RTOL),
               "stddev_v3": (np.where(counts > 1, sd, np.nan), MOMENT_RTOL)}
    elif q == 7:
        order = np.argsort(gid, kind="stable")
        out = {"range_v1_v2": (np.maximum.reduceat(v1[order], starts)
                               - np.minimum.reduceat(v2[order], starts),
                               None)}
    elif q == 9:
        x, y = v1.astype(np.float64), v2.astype(np.float64)
        dx, dy = x - (fsum(x) / counts)[gid], y - (fsum(y) / counts)[gid]
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = fsum(dx * dy) / np.sqrt(fsum(dx * dx) * fsum(dy * dy))
        out = {"corr": (corr, MOMENT_RTOL)}
    else:
        out = {"v3": (fsum(v3), SUM_RTOL), "cnt": (counts, None)}
    return names, widths, groups, out


def phase_h2o_groupby():
    t0 = time.perf_counter()
    table = h2o.groupby_table(H2O_N, H2O_K, H2O_SEED)
    # the numbers behind the id strings: the generator's first three draws
    rng = np.random.default_rng(H2O_SEED)
    nk = max(H2O_N // H2O_K, 1)
    ids = {"id1": rng.integers(1, H2O_K + 1, H2O_N),
           "id2": rng.integers(1, H2O_K + 1, H2O_N),
           "id3": rng.integers(1, nk + 1, H2O_N)}
    for name, (hi, w) in (("id1", (H2O_K, 8)), ("id2", (H2O_K, 8)),
                          ("id3", (nk, 12))):
        if not np.array_equal(h2o.id_strings(ids[name], hi, w), table[name]):
            raise AssertionError(f"h2o {name}: strings differ from the draws")
    ids.update({n: table[n] for n in ("id4", "id5", "id6")})
    nbytes = sum(v.nbytes for v in table.values())
    log(f"phase 11: h2o groupby G1_1e7_1e2_0_0: generated {H2O_N} rows x "
        f"{len(table)} columns ({nbytes / 1e9:.2f} GB as numpy arrays) in "
        f"{time.perf_counter() - t0:.2f} s")
    ctx = SessionContext(device="cuda")
    _register_numpy_timed(ctx, "x", table, "h2o groupby")
    t0 = time.perf_counter()
    batch = ctx.bind_inputs(["x"])["x"]
    torch.cuda.synchronize()
    on_card = sum(c.data.numel() * c.data.element_size() + c.validity.numel()
                  for c in batch.columns)
    log(f"phase 11: h2o groupby: upload {time.perf_counter() - t0:.2f} s, "
        f"{on_card / 1e9:.3f} GB on the card")
    del batch

    total = np.zeros(2, dtype=np.int64)
    for q in sorted(h2o.GROUPBY_QUERIES):
        batch, schema, launches, retries = _timed_question(
            ctx, f"h2o groupby q{q}", h2o.GROUPBY_QUERIES[q])
        total += launches
        raw = _raw_columns(batch, schema)
        del batch
        t0 = time.perf_counter()
        if q == 8:
            # the two largest v3 per id6, exact as a multiset of (id6, v3)
            order = np.lexsort((-table["v3"], table["id6"]))
            sid = table["id6"][order]
            first = np.r_[True, sid[1:] != sid[:-1]]
            start = np.maximum.accumulate(np.where(first, np.arange(H2O_N), 0))
            top = order[np.arange(H2O_N) - start < 2]
            want = np.lexsort((table["v3"][top], table["id6"][top]))
            mine = np.lexsort((raw["v3"][0], raw["id6"][0]))
            notes = [
                "id6 " + _held("h2o q8 id6", raw["id6"][0][mine],
                               table["id6"][top][want]),
                "v3 " + _held("h2o q8 v3", raw["v3"][0][mine],
                              table["v3"][top][want])]
        else:
            names, widths, groups, want = h2o_groupby_expected(q, table, ids)
            key = _combined([_id_numbers(raw, schema, n) for n in names],
                            widths)
            order = np.argsort(key, kind="stable")
            notes = ["groups " + _held(f"h2o q{q} groups", key[order], groups)]
            for col, (values, rtol) in want.items():
                got, valid = raw[col]
                # a one-row group has no stddev and no corr: NULL there
                with np.errstate(invalid="ignore"):
                    defined = ~np.isnan(values.astype(np.float64))
                _held(f"h2o q{q} {col} validity", valid[order], defined)
                notes.append(f"{col} " + _held(
                    f"h2o q{q} {col}", got[order][defined], values[defined],
                    rtol, CORR_FLOOR if col == "corr" else 0.0))
        log(f"phase 11: h2o groupby q{q} equals numpy ({'; '.join(notes)}); "
            f"check took {time.perf_counter() - t0:.2f} s")
        if q == 10:
            table_size = ctx.options.max_group_table
            if len(raw["cnt"][0]) <= 4 * table_size or retries < 2:
                raise AssertionError(
                    f"h2o q10: {len(raw['cnt'][0])} groups after {retries} "
                    f"overflow retries: expected more than {4 * table_size} "
                    "groups through at least two retries")
            log(f"phase 11: h2o groupby q10 converged on {len(raw['cnt'][0])} "
                f"groups after {retries} overflow retries (max_group_table "
                f"{table_size} -> {4 * table_size} -> {16 * table_size})")
    ctx.evict_device()
    return total


def _lookup(build_keys, probe_keys):
    """(index into the build side per probe row, whether it matched)."""
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    pos = np.searchsorted(sk, probe_keys).clip(max=len(sk) - 1)
    return order[pos], sk[pos] == probe_keys


def phase_h2o_join():
    t0 = time.perf_counter()
    tables = h2o.join_tables(H2O_JOIN_N, H2O_SEED)
    log(f"phase 11: h2o join J1_1e7: generated x, small, medium, large "
        f"({[len(t['v2' if 'v2' in t else 'v1']) for t in tables.values()]} "
        f"rows) in {time.perf_counter() - t0:.2f} s")
    ctx = SessionContext(device="cuda")
    for name, table in tables.items():
        _register_numpy_timed(ctx, name, table, "h2o join")
    # id6 has about as many distinct values as rows: RAW at the default
    # threshold (BALLISTA_RAW_DICT_MAX unset), the other strings sorted
    raw = {name: tp.schema.unsorted for name, tp in ctx.tables.items()}
    if raw != {"x": {"id6"}, "small": set(), "medium": set(),
               "large": {"id6"}}:
        raise AssertionError(f"phase 11: h2o join RAW columns {raw}")
    log(f"phase 11: h2o join RAW columns {raw}")
    x = tables["x"]
    plan = {1: ("small", "id1", True), 2: ("medium", "id2", True),
            3: ("medium", "id2", False), 4: ("medium", "id5", False),
            5: ("large", "id3", False)}
    total = np.zeros(2, dtype=np.int64)
    for q in sorted(h2o.JOIN_QUERIES):
        batch, schema, launches, _ = _timed_question(
            ctx, f"h2o join q{q}", h2o.JOIN_QUERIES[q])
        total += launches
        raw = _raw_columns(batch, schema)
        del batch
        other, key, inner = plan[q]
        right = tables[other]
        # every build key is unique: one output row per x row (left join)
        # or per matched x row (inner join)
        if len(np.unique(right[key])) != len(right[key]):
            raise AssertionError(f"h2o join q{q}: {other}.{key} repeats")
        idx, found = _lookup(right[key], x[key])
        keep = found if inner else np.ones(len(found), dtype=bool)
        v1, v1_ok = raw["v1"]
        v2, v2_ok = raw["v2"]
        notes = [
            "rows " + _held(f"h2o join q{q} rows", len(v1), int(keep.sum())),
            "matched " + _held(f"h2o join q{q} matched", int(v2_ok.sum()),
                               int(found.sum())),
            "sum(v1) " + _held(f"h2o join q{q} sum(v1)", v1[v1_ok].sum(),
                               x["v1"][keep].sum(), SUM_RTOL),
            "sum(v2) " + _held(f"h2o join q{q} sum(v2)", v2[v2_ok].sum(),
                               right["v2"][idx[found]].sum(), SUM_RTOL)]
        if not v1_ok.all():
            raise AssertionError(f"h2o join q{q}: NULL in v1")
        log(f"phase 11: h2o join q{q} equals numpy ({'; '.join(notes)})")
    ctx.evict_device()
    JOIN_KEPT.update(ctx=ctx, x=x)
    return total


def phase_taxi():
    t0 = time.perf_counter()
    table = nyctaxi.synthetic_tripdata(TAXI_N, H2O_SEED)
    log(f"phase 11: taxi: generated {TAXI_N} trips x {len(table)} columns in "
        f"{time.perf_counter() - t0:.2f} s")
    ctx = SessionContext(device="cuda")
    _register_numpy_timed(ctx, "tripdata", table, "taxi")
    sql = nyctaxi.QUERIES["fare_amt_by_passenger"]
    batch, schema, launches, _ = _timed_question(ctx, "taxi "
                                                 "fare_amt_by_passenger", sql)
    raw = _raw_columns(batch, schema)
    names = [f.name for f in schema.fields]
    order = np.argsort(raw[names[0]][0])
    pc, fare = table["passenger_count"], table["fare_amount"]
    groups = np.unique(pc)
    by_group = np.argsort(pc, kind="stable")
    starts = np.searchsorted(pc[by_group], groups)
    notes = [
        "groups " + _held("taxi groups", raw[names[0]][0][order], groups),
        "min " + _held("taxi min", raw[names[1]][0][order],
                       np.minimum.reduceat(fare[by_group], starts)),
        "max " + _held("taxi max", raw[names[2]][0][order],
                       np.maximum.reduceat(fare[by_group], starts)),
        "sum " + _held("taxi sum", raw[names[3]][0][order],
                       np.bincount(pc, fare)[groups], SUM_RTOL)]
    log(f"phase 11: taxi query equals numpy ({'; '.join(notes)})")
    ctx.evict_device()
    return launches


def phase_frames(ctx):
    """TPC-H Q1 and Q3 at SF1 written as DataFrame calls."""
    total = np.zeros(2, dtype=np.int64)
    for q, frame in ((1, q1_frame), (3, q3_frame)):
        df = frame(ctx)
        times = []
        for i in range(4):
            if i == 0:
                reset_counts()
            with spy_rows() as calls:
                t0 = time.perf_counter()
                batch, schema = df.collect()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if i == 0:
                launches, shapes = read_counts(), call_shapes(calls)
        total += launches
        check_answers(to_numpy(batch, schema), schema, q)
        log(f"phase 11: Q{q} by DataFrame calls equals answers/sf1/answers/"
            f"q{q}.out exactly; first run {times[0]:.4f} s, warm median "
            f"{statistics.median(times[1:]) * 1e3:.3f} ms; "
            f"masked_slot_sums_rows launches {launches[0]}, calls at (A, n), "
            f"T = {shapes}")
        if q == 1 and shapes != [((Q1_A, Q1_N), Q1_T)]:
            raise AssertionError(f"Q1 by DataFrame: kernel calls {shapes}, "
                                 f"expected one at T = {Q1_T}")
    return total


SPARSE_QUERIES = (3, 5, 7, 8, 9, 18, 21)


def phase_sparse_flow(ctx):
    """The nodes `plan_sparse_flow` marked in the join queries' converged
    plans, and the warm `run_plan` of each (their answers are held by
    phases 6 to 8, which run with the pass in)."""
    for q in SPARSE_QUERIES:
        plan, inputs, _ = ctx.sql(TPCH_QUERIES[q]).converge()
        nodes, stack = {}, [plan]
        while stack:
            node = stack.pop()
            nodes[id(node)] = node
            stack.extend(node.children)
        marked = [type(n).__name__ + (f"[{n.join_type}]"
                                      if hasattr(n, "join_type") else "")
                  for n in nodes.values() if getattr(n, "emit_sparse", False)]
        may = [n for n in nodes.values()
               if isinstance(n, plan_mod.FilterExec)
               or (isinstance(n, plan_mod.HashJoinExec) and n.unique_build
                   and n.join_type in ("inner", "semi", "anti"))]
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            out, overflow = plan_mod.run_plan(plan, inputs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if out.live is not None or (overflow is not None and bool(overflow)):
            raise AssertionError(f"Q{q}: sparse or overflowed root output")
        log(f"phase 11: Q{q} sparse flow: {len(marked)} of {len(may)} filters "
            f"and unique inner/semi/anti joins hand on their keep mask "
            f"({len(nodes)} nodes): {sorted(marked)}; run_plan on the converged "
            f"plan, warm median of 5: {statistics.median(times[1:]) * 1e3:.3f} "
            "ms")


def phase_statements(ctx):
    """EXPLAIN, SHOW TABLES and CREATE TABLE AS on the SF1 context.
    Returns (kernel launches, max |kernel - plain| on the new table's
    aggregate call)."""
    got = ctx.sql("explain " + TPCH_QUERIES[3]).to_numpy()
    if list(got["plan_type"][0]) != ["logical_plan", "physical_plan"] \
            or "not available" in got["plan"][0][1] \
            or "HashJoinExec" not in got["plan"][0][1]:
        raise AssertionError(f"EXPLAIN of Q3: {got}")
    log("phase 11: EXPLAIN of Q3: logical_plan of "
        f"{len(got['plan'][0][0].splitlines())} lines, physical_plan of "
        f"{len(got['plan'][0][1].splitlines())} lines")
    shown = ctx.sql("show tables").to_numpy()
    if sorted(shown["table_name"][0]) != sorted(TPCH_TABLES) \
            or set(shown["table_type"][0]) != {"BASE TABLE"}:
        raise AssertionError(f"SHOW TABLES: {shown}")
    log(f"phase 11: SHOW TABLES lists {sorted(shown['table_name'][0])}")

    # Q3's customer-orders subquery as a new table, then a grouped SELECT
    # over it (o_orderpriority has five values: the masked layout)
    t0 = time.perf_counter()
    ctx.sql("""create table building_orders as
               select o_orderkey, o_orderdate, o_orderpriority, o_totalprice
               from customer, orders
               where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
                 and o_orderdate < date '1995-03-15';
               select 1""")
    made = ctx.tables["building_orders"]
    log(f"phase 11: CREATE TABLE AS: building_orders, {made.num_rows} rows, "
        f"{[(f.name, repr(f.dtype)) for f in made.fields]} in "
        f"{time.perf_counter() - t0:.3f} s")
    reset_counts()
    with spy_rows() as calls:
        got = ctx.sql("""select o_orderpriority, count(*) as n,
                                sum(o_totalprice) as total,
                                min(o_orderdate) as first_day,
                                max(o_orderkey) as last_key
                         from building_orders group by o_orderpriority
                         order by o_orderpriority""").to_numpy()
    launches = read_counts()
    seg = _host(ctx, "customer", "c_mktsegment")
    building = np.zeros(_raw(ctx, "customer", "c_custkey").max() + 1,
                        dtype=bool)
    building[_raw(ctx, "customer", "c_custkey")[seg == "BUILDING"]] = True
    odate = _raw(ctx, "orders", "o_orderdate")
    keep = building[_raw(ctx, "orders", "o_custkey")] \
        & (odate < parse_date("1995-03-15"))
    if made.num_rows != int(keep.sum()):
        raise AssertionError(f"building_orders has {made.num_rows} rows, "
                             f"numpy {int(keep.sum())}")
    prio = _host(ctx, "orders", "o_orderpriority")[keep]
    want = []
    for p in np.unique(prio):
        m = prio == p
        want.append((str(p), int(m.sum()),
                     int(_raw(ctx, "orders", "o_totalprice")[keep][m].sum()),
                     int(odate[keep][m].min()),
                     int(_raw(ctx, "orders", "o_orderkey")[keep][m].max())))
    mine = [tuple(v.item() if hasattr(v, "item") else v for v in row)
            for row in zip(*(got[c][0] for c in got))]
    if mine != want:
        raise AssertionError(f"SELECT over building_orders: {mine} != numpy "
                             f"{want}")
    if launches[0] < 1 or not calls:
        raise AssertionError("the SELECT over building_orders ran without "
                             "launching masked_slot_sums_rows")
    log(f"phase 11: SELECT over building_orders equals the numpy computation "
        f"exactly ({len(want)} groups); masked_slot_sums_rows launches "
        f"{launches[0]}, calls at (A, n), T = {call_shapes(calls)}")
    err = held_err(hold_call(11, "the SELECT over building_orders", *calls[0]))
    return launches, err


def phase_client(ctx):
    """Phase 11. Returns (kernel launches over the first runs, max |kernel
    - plain| on the call it holds)."""
    launches = phase_frames(ctx)
    phase_sparse_flow(ctx)
    more, err = phase_statements(ctx)
    ctx.evict_device()
    launches = launches + more + phase_h2o_groupby() + phase_h2o_join() \
        + phase_taxi()
    return launches, err


# ---------------------------------------------------------------------------
# phase 12: the out-of-core slice at SF10
# ---------------------------------------------------------------------------

SF10 = 10.0
SERIAL_P = 8
# the device cap of (c) and (d): the H100's smallest MIG slice, 1g.10gb
CAP_BYTES = 10 * 2 ** 30
# (b) runs every query at SF10 unless it passes this; then the rest of the
# queries run at SF1 against answers/sf1
SERIAL_BUDGET_S = 45
SERIAL_SF10_FIRST = (1, 3, 5, 9, 13, 18, 21)
F64_RTOL = 1e-9
ROUTED = "plan routed out-of-core"
FELL_BACK = "in-core execution exhausted device memory"
GIB = 2 ** 30


def numpy_q6(cols):
    """Q6 over lineitem's host columns: the revenue at scale 4."""
    ship = cols["l_shipdate"].values
    disc = cols["l_discount"].values
    m = ((ship >= parse_date("1994-01-01")) & (ship < parse_date("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (cols["l_quantity"].values < 2400))
    return int((cols["l_extendedprice"].values[m] * disc[m]).sum())


def _same_answer(label, got, want):
    """A host answer ({name: (values, validity)}) against the yardstick:
    names, row count and validity equal, f64 at rtol F64_RTOL, everything
    else exactly; row by row, or, where ties under a LIMIT leave the order
    open, as sorted rows."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    n = len(next(iter(want.values()))[0])
    if len(next(iter(got.values()))[0]) != n:
        raise AssertionError(f"{label}: {len(next(iter(got.values()))[0])} "
                             f"rows, want {n}")

    def rows(ans):
        cols = [(v.tolist(), ok.tolist()) for v, ok in ans.values()]
        return [tuple(v[i] if ok[i] else None for v, ok in cols)
                for i in range(n)]

    def close(a, b):
        return all(x == y or (isinstance(x, float) and isinstance(y, float)
                              and abs(x - y) <= F64_RTOL * abs(y))
                   for x, y in zip(a, b))

    g, w = rows(got), rows(want)
    if all(close(a, b) for a, b in zip(g, w)):
        return
    g, w = sorted(g, key=_row_key), sorted(w, key=_row_key)
    if not all(close(a, b) for a, b in zip(g, w)):
        bad = next(i for i in range(n) if not close(g[i], w[i]))
        raise AssertionError(f"{label}: row {bad} {g[bad]} != {w[bad]}")


def _fresh(ctx=None):
    """Device memory as a query starts: no cached columns, nothing held by
    the allocator, the peak counters reset."""
    if ctx is not None:
        ctx.evict_device()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peaks():
    return torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()


class spy_serial:
    """Records each execute_serial call the contexts make while the block
    runs: (partitions, the run's StageMetrics)."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        self.real = serial_mod.execute_serial

        def spy(ctx, plan, n_partitions, *args, **kwargs):
            out = self.real(ctx, plan, n_partitions, *args, **kwargs)
            self.runs.append((n_partitions, list(ctx.serial_metrics)))
            return out

        serial_mod.execute_serial = spy
        return self.runs

    def __exit__(self, *exc):
        serial_mod.execute_serial = self.real


def _route_plan(ctx, q):
    """The physical plan `collect()` prices for query q."""
    return ctx.physical_plan(rebind_scans(ctx.sql(TPCH_QUERIES[q]).plan, ctx))


def sf10_in_core(ctx, tables):
    """(a): the 22 queries in-core on the whole card. Returns (answers,
    {q: peak allocated}, kernel launches, Q1's kernel call)."""
    answers, peaks, launches = {}, {}, np.zeros(2, dtype=np.int64)
    lineitem = tables["lineitem"][1]
    for q in range(1, 23):
        _fresh(ctx)
        n_warn = len(ctx.warnings)
        reset_counts()
        t0 = time.perf_counter()
        batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches += read_counts()
        answers[q] = to_numpy(batch, schema)
        del batch
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            ctx.sql(TPCH_QUERIES[q]).collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        # the plan the last run answered with (a re-planned one where the
        # first overflowed): one more run, inside the same peak window
        converged, _, _ = ctx.converge(ctx.sql(TPCH_QUERIES[q]).plan)
        alloc, reserved = _peaks()
        peaks[q] = alloc
        est = memory.estimate_plan_hbm(_route_plan(ctx, q))
        est_conv = memory.estimate_plan_hbm(converged)
        del converged
        retries = len(ctx.warnings) - n_warn
        if any(FELL_BACK in w for w in ctx.warnings[n_warn:]):
            raise AssertionError(f"Q{q} fell back to serial on the whole card")
        log(f"phase 12 (a): Q{q} in-core: {len(answers[q][schema.fields[0].name][0])} "
            f"rows; first run {first_s:.4f} s, warm median "
            f"{statistics.median(warm) * 1e3:.3f} ms ({[round(w, 6) for w in warm]}); "
            f"peak allocated {alloc} B ({alloc / GIB:.3f} GiB), reserved "
            f"{reserved} B ({reserved / GIB:.3f} GiB); estimate {est} B "
            f"({est / GIB:.3f} GiB), estimate/peak {est / alloc:.3f}, "
            f"of the converged plan {est_conv} B ({est_conv / alloc:.3f}); "
            f"reserved/allocated {reserved / alloc:.3f}; overflow retries "
            f"{retries} over 5 runs")
        if q == 1:
            check_q1(answers[1], schema, lineitem)
        elif q == 5:
            check_q5(answers[5], tables)
        elif q == 6:
            got = answers[6]["revenue"]
            if not got[1].all() or int(got[0][0]) != numpy_q6(lineitem):
                raise AssertionError(f"Q6 {got} != numpy {numpy_q6(lineitem)}")
        if q in (1, 5, 6):
            log(f"phase 12 (a): Q{q} equals the numpy computation exactly")
    # the kernel on SF10 Q1's own call, held against its plain version
    _fresh(ctx)
    with spy_rows() as calls:
        ctx.sql(TPCH_QUERIES[1]).collect()
    return answers, peaks, launches, calls[0]


def sf10_serial(tables, answers, sf1_ctx):
    """(b): the 22 queries on SessionContext(serial_partitions=8), each
    equal to (a). Past SERIAL_BUDGET_S the queries left run at SF1 against
    answers/sf1. Returns (kernel launches, a serial shard's kernel call)."""
    sctx = SessionContext(device="cuda", serial_partitions=SERIAL_P)
    for name, (fields, cols) in tables.items():
        sctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    sf1 = SessionContext(device="cuda", serial_partitions=SERIAL_P)
    for name, tp in sf1_ctx.tables.items():
        if name in TPCH_TABLES:
            sf1.register_host(name, tp.fields, tp.host,
                              primary_key=TPCH_TABLES[name][1])
    launches = np.zeros(2, dtype=np.int64)
    order = SERIAL_SF10_FIRST + tuple(q for q in range(1, 23)
                                      if q not in SERIAL_SF10_FIRST)
    t_start = time.perf_counter()
    at_sf1 = []
    for q in order:
        over = time.perf_counter() - t_start > SERIAL_BUDGET_S
        ctx = sf1 if over else sctx
        if over:
            at_sf1.append(q)
        _fresh()
        reset_counts()
        with spy_serial() as runs:
            t0 = time.perf_counter()
            batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        launches += read_counts()
        got = to_numpy(batch, schema)
        del batch
        if over:
            check_answers(got, schema, q)
        else:
            _same_answer(f"Q{q} serial", got, answers[q])
        t0 = time.perf_counter()
        ctx.sql(TPCH_QUERIES[q]).collect()
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        alloc, reserved = _peaks()
        stages = [m for _, ms in runs for m in ms]
        est = estimate_serial_hbm(ctx, ctx.sql(TPCH_QUERIES[q]).plan, SERIAL_P)
        log(f"phase 12 (b): Q{q} serial@{SERIAL_P} at SF{1 if over else 10}: "
            f"equals {'answers/sf1' if over else '(a)'}; first run "
            f"{first_s:.4f} s, second {second_s:.4f} s; {len(runs)} serial "
            f"runs, {len(stages)} stages, {sum(m.partitions for m in stages)} "
            f"partitions run, host->device {sum(m.bytes_to_device for m in stages)} B, "
            f"device->host {sum(m.bytes_to_host for m in stages)} B, overflow "
            f"retries {max((m.retries for m in stages), default=0)}; peak "
            f"allocated {alloc} B ({alloc / GIB:.3f} GiB), reserved {reserved} "
            f"B; largest stage estimate {est} B, estimate/peak "
            f"{est / alloc:.3f}")
    log(f"phase 12 (b): {time.perf_counter() - t_start:.1f} s in all; "
        f"queries run at SF1 past {SERIAL_BUDGET_S} s: {at_sf1 or 'none'}")
    # the kernel on one serial shard's partial aggregate of Q1
    _fresh()
    with spy_rows() as calls:
        sctx.sql(TPCH_QUERIES[1]).collect()
    # the partial aggregates read a lineitem shard; the final one reads the
    # P x quota exchanged states
    shard = max((c for c in calls if c[2] == Q1_T), key=lambda c: c[0].shape[0])
    return launches, shard


def _route(n_warn, ctx, runs):
    new = ctx.warnings[n_warn:]
    if not runs:
        return "in-core"
    kind = ("OOM fallback" if any(FELL_BACK in w for w in new)
            else "routed" if any(ROUTED in w for w in new) else "?")
    return f"{kind} serial@{runs[-1][0]}"


def _capped(cap):
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(min(cap / total, 1.0), 0)
    os.environ["BALLISTA_HBM_BYTES"] = str(int(cap))


def sf10_routing(ctx, answers):
    """(c): plain collect() under a 10 GiB cap. Returns kernel launches."""
    _fresh(ctx)
    _capped(CAP_BYTES)
    launches = np.zeros(2, dtype=np.int64)
    routes = {}
    for q in range(1, 23):
        _fresh(ctx)
        n_warn = len(ctx.warnings)
        reset_counts()
        with spy_serial() as runs:
            t0 = time.perf_counter()
            batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches += read_counts()
        _same_answer(f"Q{q} under the cap", to_numpy(batch, schema),
                     answers[q])
        del batch
        alloc, reserved = _peaks()
        routes[q] = _route(n_warn, ctx, runs)
        if reserved > CAP_BYTES:
            raise AssertionError(f"Q{q}: {reserved} B reserved past the cap")
        log(f"phase 12 (c): Q{q} under a {CAP_BYTES / GIB:g} GiB cap: "
            f"{routes[q]}, equals (a); {run_s:.4f} s; peak allocated {alloc} B "
            f"({alloc / GIB:.3f} GiB), reserved {reserved} B")
    routed = [q for q, r in routes.items() if r != "in-core"]
    if not any(r.startswith("routed") for r in routes.values()):
        raise AssertionError("no query was routed under the cap")
    log(f"phase 12 (c): out-of-core under the cap: {routed}")
    return launches


def sf10_oom(ctx, answers, peaks):
    """(d): the largest in-core query of (a) with routing off under the
    cap: a real torch.cuda.OutOfMemoryError, the serial fallback, the memo
    written, then a second collect() routed by the memo alone. Returns
    kernel launches."""
    import shutil
    import tempfile
    q = max(peaks, key=peaks.get)
    cap = CAP_BYTES
    if peaks[q] <= cap:
        cap = peaks[q] // 2
        log(f"phase 12 (d): no in-core peak passes {CAP_BYTES} B; the cap "
            f"is halved below Q{q}'s peak {peaks[q]} B to {cap} B")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    memo_dir = tempfile.mkdtemp(dir=build)
    memo_path = os.path.join(memo_dir, "oom_memo.json")
    real_path = memory._oom_memo_path
    memory._oom_memo_path = lambda: memo_path
    launches = np.zeros(2, dtype=np.int64)
    try:
        _fresh(ctx)
        _capped(cap)
        os.environ["BALLISTA_ROUTE_FACTOR"] = "0"
        for attempt, want in (("first", FELL_BACK), ("second", ROUTED)):
            _fresh(ctx)
            n_warn = len(ctx.warnings)
            reset_counts()
            with spy_serial() as runs:
                t0 = time.perf_counter()
                batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            launches += read_counts()
            _same_answer(f"Q{q} {attempt} collect", to_numpy(batch, schema),
                         answers[q])
            del batch
            new = ctx.warnings[n_warn:]
            if not any(want in w for w in new) or (
                    attempt == "second" and any(FELL_BACK in w for w in new)):
                raise AssertionError(f"Q{q} {attempt} collect: warnings {new}")
            with open(memo_path) as f:
                memo = json.load(f)
            alloc, reserved = _peaks()
            log(f"phase 12 (d): Q{q} (peak {peaks[q]} B in (a)) under a {cap} B "
                f"cap, {attempt} collect: {_route(n_warn, ctx, runs)}, equals "
                f"(a); {run_s:.4f} s; warnings {new}; memo {memo}; peak "
                f"allocated {alloc} B, reserved {reserved} B")
            # the second collect: the estimate can never route, the memo can
            os.environ["BALLISTA_ROUTE_FACTOR"] = "1e12"
    finally:
        memory._oom_memo_path = real_path
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
        os.environ.pop("BALLISTA_HBM_BYTES", None)
        os.environ.pop("BALLISTA_ROUTE_FACTOR", None)
        _fresh(ctx)
        shutil.rmtree(memo_dir, ignore_errors=True)
    return launches


def phase_sf10(sf1_ctx):
    """Phase 12. Returns (kernel launches over its main paths, max |kernel
    - plain| on the two calls it holds)."""
    sf1_ctx.evict_device()
    _fresh()
    t0 = time.perf_counter()
    tables = generate_tpch(SF10, SEED)
    rows = {name: len(cols[f[0].name].values)
            for name, (f, cols) in tables.items()}
    log(f"phase 12: TPC-H SF10 generated in {time.perf_counter() - t0:.1f} s "
        f"({rows})")
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in tables.items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    t0 = time.perf_counter()
    answers, peaks, launches, q1_call = sf10_in_core(ctx, tables)
    log(f"phase 12 (a): {time.perf_counter() - t0:.1f} s")
    err = held_err(hold_call(12, "SF10 Q1's own kernel inputs, in-core",
                             *q1_call))
    del q1_call
    _fresh(ctx)
    t0 = time.perf_counter()
    more, shard_call = sf10_serial(tables, answers, sf1_ctx)
    launches = launches + more
    err = max(err, held_err(hold_call(
        12, "SF10 Q1's kernel inputs on one serial shard", *shard_call)))
    del shard_call
    log(f"phase 12 (b): with the kernel held, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = launches + sf10_routing(ctx, answers)
    log(f"phase 12 (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = launches + sf10_oom(ctx, answers, peaks)
    log(f"phase 12 (d): {time.perf_counter() - t0:.1f} s")
    ctx.evict_device()
    return launches, err


# ---------------------------------------------------------------------------
# Phase 13: the distributed slice at SF1
# ---------------------------------------------------------------------------

DIST_P = 8
SKEW_N = 10 ** 7
SKEW_SQL = ("select k, sum(v + w) as s, count(*) c from fact join dim "
            "on k = dk group by k order by k")
# the in-core answer of each query, from phases 4-8 (phase 13 alone
# computes the ones it lacks)
INCORE_ANSWERS = {}
# phase 13 (a)'s answers, by query (phase 17 (c) holds its own to them)
DIST_ANSWERS = {}
# phase 13 (c)'s options of each attempt (phase 17 (c) holds its to them)
DIST_SKEW_SEQ = []
# seconds g++ took for the native encoder in phase 2
NATIVE_BUILD_S = [0.0]
# the numbers of the partition call phase 13 holds (the kernels line of
# --distributed-only)
LAST_HELD = {}


def _dist_ctx(sf1_ctx, mesh):
    """A distributed context over phase 6's host tables."""
    ctx = SessionContext(device="cuda", distributed=True, mesh=mesh)
    for name, tp in sf1_ctx.tables.items():
        if name in TPCH_TABLES:
            ctx.register_host(name, tp.fields, tp.host,
                              primary_key=TPCH_TABLES[name][1])
    return ctx


def _incore(sf1_ctx, q):
    if q not in INCORE_ANSWERS:
        INCORE_ANSWERS[q] = to_numpy(*sf1_ctx.sql(TPCH_QUERIES[q]).collect())
    return INCORE_ANSWERS[q]


def _job_summary(cl, jobs):
    """Stages, tasks, escalations and per-stage (run_s, output_rows) of
    the jobs a query made (a scalar subquery is a job of its own)."""
    stages = tasks = escalations = 0
    per_stage = []
    for j in jobs:
        jc = cl.launcher.jobs[j]
        stages += len(jc.dplan.stages)
        tasks += cl.scheduler.task_manager.jobs[j]._next_task_id
        escalations += len(jc.attempts) - 1
        per_stage += [(round(m.run_s, 4), m.output_rows)
                      for _, m in sorted(jc.stage_metrics.items())]
    return stages, tasks, escalations, per_stage


def dist_queries(ctx, sf1_ctx):
    """(a): the 22 queries through SessionContext(distributed=True) at
    P = 8 on one card. Returns (answers, kernel launches, Q1's calls)."""
    cl = ctx.cluster()
    answers, launches, q1_calls = {}, np.zeros(2, dtype=np.int64), None
    for q in range(1, 23):
        want = _incore(sf1_ctx, q)
        _fresh(ctx)
        before = set(cl.launcher.jobs)
        reset_counts()
        with spy_rows() as calls:
            t0 = time.perf_counter()
            batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        first_launches = read_counts()
        launches += first_launches
        alloc, reserved = _peaks()
        table_bytes = cl.runtime.table_bytes
        jobs = [j for j in cl.launcher.jobs if j not in before]
        got = to_numpy(batch, schema)
        del batch
        check_answers(got, schema, q)
        _same_answer(f"Q{q} distributed", got, want)
        answers[q] = got
        if q == 1:
            q1_calls = calls
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            ctx.sql(TPCH_QUERIES[q]).collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        stages, tasks, escalations, per_stage = _job_summary(cl, jobs)
        log(f"phase 13 (a): Q{q} at P = {DIST_P}: equals answers/sf1 and the "
            f"in-core answer; first run {first_s:.4f} s, warm median "
            f"{statistics.median(warm):.4f} s (runs "
            f"{[round(w, 4) for w in warm]}); {len(jobs)} jobs, {stages} "
            f"stages, {tasks} tasks, {escalations} escalations; kernel "
            f"launches in the first run {int(first_launches.sum())}; peak "
            f"allocated {alloc} B "
            f"({alloc / GIB:.3f} GiB), reserved {reserved} B; partitioned "
            f"tables {table_bytes} B")
        log(f"phase 13 (a): Q{q} stages (run_s, output_rows): {per_stage}")
    return answers, launches, q1_calls


def dist_default_mesh(sf1_ctx, answers):
    """(b): Q1 through the default mesh (one partition per visible card)."""
    ctx = _dist_ctx(sf1_ctx, None)
    reset_counts()
    t0 = time.perf_counter()
    batch, schema = ctx.sql(TPCH_QUERIES[1]).collect()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = read_counts()
    _same_answer("Q1 on the default mesh", to_numpy(batch, schema), answers[1])
    log(f"phase 13 (b): Q1 on the default mesh, P = {len(ctx.cluster().runtime.mesh)}"
        f": equals (a); {took:.4f} s")
    ctx.evict_device()
    return launches


def skew_run(mesh, label):
    """Phase 13 (c): tests/test_skew.py's shape at 10^7 fact rows, 85 % on
    one key, joined to a 100-row unique dimension through a shuffle join
    on tiny quotas, over `mesh` (one process's, or a global mesh that
    spans processes: phase 17 (c)): the overflow must escalate to salt;
    the answer is checked against numpy on the host arrays. Returns
    (kernel launches, the options of each attempt as (headroom,
    join_salt, max_group_table))."""
    rng = np.random.default_rng(SEED)
    keys = np.where(rng.random(SKEW_N) < 0.85, 7,
                    rng.integers(0, 100, SKEW_N)).astype(np.int64)
    v = rng.integers(0, 1000, SKEW_N).astype(np.int64)
    w = np.arange(100, dtype=np.int64) * 10
    ctx = SessionContext(device="cuda")
    ctx.register_numpy("fact", {"k": keys, "v": v})
    ctx.register_numpy("dim", {"dk": np.arange(100, dtype=np.int64), "w": w},
                       primary_key=("dk",))
    opts = DistOptions(n_partitions=DIST_P, broadcast_threshold=0,
                       min_quota=16, quota_headroom=1.05)
    reset_counts()
    t0 = time.perf_counter()
    batch, schema = execute_distributed(ctx, ctx.sql(SKEW_SQL).plan, mesh,
                                        opts)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = read_counts()
    seq = ctx.dist_attempts
    log(f"{label}: options of each attempt: " + "; ".join(
        f"headroom {o.quota_headroom:.4f}, join_salt {o.join_salt}, "
        f"max_group_table {o.max_group_table}" for o in seq))
    if len(seq) < 2 or seq[-1].join_salt < 2:
        raise AssertionError(f"{label}: the skewed join did not escalate "
                             "to salt")
    got = to_numpy(batch, schema)
    uk, cnt = np.unique(keys, return_counts=True)
    sums = np.zeros(100, dtype=np.int64)
    np.add.at(sums, keys, v + w[keys])
    for name, want in (("k", uk), ("c", cnt), ("s", sums[uk])):
        if not np.array_equal(got[name][0], want) or not got[name][1].all():
            raise AssertionError(f"{label}: column {name} != numpy")
    log(f"{label}: {SKEW_N} fact rows, {int(cnt.max())} on key 7: equals "
        f"numpy; {took:.4f} s for {len(seq)} attempts; stages "
        f"{[(round(m.run_s, 4), m.output_rows) for m in ctx.dist_metrics]}")
    return launches, [(o.quota_headroom, o.join_salt, o.max_group_table)
                      for o in seq]


def dist_control_plane(ctx, sf1_ctx, mesh):
    """(d): Q3 in pull mode; a LIMIT that trips the circuit breaker; two
    jobs submitted before the scheduler runs; their stage states."""
    launches = np.zeros(2, dtype=np.int64)
    pull = StandaloneCluster(ctx, mesh, DistOptions(n_partitions=DIST_P),
                             policy="pull")
    reset_counts()
    batch, schema = pull.collect_sql(TPCH_QUERIES[3])
    launches += read_counts()
    check_answers(to_numpy(batch, schema), schema, 3)
    log("phase 13 (d): Q3 through StandaloneCluster(policy='pull') equals "
        "answers/sf1")
    cl = ctx.cluster()
    reset_counts()
    batch, _ = cl.collect_sql("select l_orderkey from lineitem limit 10")
    launches += read_counts()
    jid = list(cl.launcher.jobs)[-1]
    if int(batch.num_rows) != 10 or not \
            cl.scheduler.circuit_breaker.is_tripped(jid, "global-limit"):
        raise AssertionError("phase 13 (d): LIMIT 10 did not trip the "
                             "circuit breaker")
    log("phase 13 (d): LIMIT 10 over lineitem: 10 rows, the circuit breaker "
        "tripped (global-limit)")
    reset_counts()
    jobs = {q: cl.submit_sql(TPCH_QUERIES[q]) for q in (6, 5)}
    cl.scheduler.run_until_idle()
    launches += read_counts()
    for q, j in jobs.items():
        status = cl.job_status(j)
        states = {sid: st["state"] for sid, st in status["stages"].items()}
        if status["state"] != "successful" or set(states.values()) != {
                "successful"}:
            raise AssertionError(f"phase 13 (d): Q{q}'s job {status}")
        b, s = cl.wait(j)
        check_answers(to_numpy(b, s), s, q)
        log(f"phase 13 (d): Q{q} submitted with another job before the "
            f"scheduler ran: {status['state']}, stage states {states}; "
            "equals answers/sf1")
    return launches


def phase_distributed(sf1_ctx):
    """Phase 13. Returns (kernel launches over its main paths, max |kernel
    - plain| on the partition call it holds)."""
    t_start = time.perf_counter()
    sf1_ctx.evict_device()
    mesh = make_mesh(DIST_P, devices=[torch.device("cuda", 0)] * DIST_P)
    ctx = _dist_ctx(sf1_ctx, mesh)
    t0 = time.perf_counter()
    answers, launches, q1_calls = dist_queries(ctx, sf1_ctx)
    DIST_ANSWERS.update(answers)
    log(f"phase 13 (a): {time.perf_counter() - t0:.1f} s")
    sf1_ctx.evict_device()
    # one partition's partial aggregate of Q1: the largest call at T = 12
    call = max((c for c in q1_calls if c[2] == Q1_T),
               key=lambda c: c[0].shape[0])
    del q1_calls
    held = hold_call(13, f"one partition's partial aggregate of Q1 at "
                     f"P = {DIST_P}", *call)
    LAST_HELD.update(held)
    err = held_err(held)
    del call
    launches = launches + dist_default_mesh(sf1_ctx, answers)
    t0 = time.perf_counter()
    more, seq = skew_run(mesh, "phase 13 (c)")
    launches = launches + more
    DIST_SKEW_SEQ[:] = seq
    log(f"phase 13 (c): {time.perf_counter() - t0:.1f} s with generation")
    launches = launches + dist_control_plane(ctx, sf1_ctx, mesh)
    ctx.evict_device()
    log(f"phase 13: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"{launches.tolist()}")
    return launches, err


def phase_distributed_alone():
    """Phase 13 without phases 3-12: the SF1 tables made here, the
    in-core answers computed on demand."""
    t0 = time.perf_counter()
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in generate_tpch(SF, SEED).items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    log(f"phase 13: TPC-H SF1 generated in {time.perf_counter() - t0:.1f} s")
    return phase_distributed(ctx)


# ---------------------------------------------------------------------------
# Phase 14: the wire slice (scheduler and executor processes over HTTP)
# ---------------------------------------------------------------------------

WIRE_P = 4
# seconds without a heartbeat before the scheduler drops an executor (d)
WIRE_EXPIRY_S = 5.0
WIRE_PUSH = (1, 3, 5, 21)
WIRE_P2P = (3, 5)
# (d): a query that converges at spec v0, so the job's recovery is the
# lost executor's and not an escalation's reset of every stage
WIRE_LOST = 9


class _Executor:
    """One executor process on the card (`python -m
    ballista_tpu_torch.scheduler.executor_process`); its output is kept
    for a failure's report."""

    def __init__(self, url, eid, policy="pull", work_dir=None):
        cmd = [sys.executable, "-m",
               "ballista_tpu_torch.scheduler.executor_process",
               "--scheduler", url, "--executor-id", eid,
               "--device", "cuda",
               "--partitions", str(WIRE_P), "--poll-ms", "10",
               "--heartbeat-s", "1", "--policy", policy]
        if work_dir:
            cmd += ["--work-dir", work_dir]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        self.eid = eid
        self.lines = []
        self.ready = threading.Event()
        self.proc = subprocess.Popen(cmd, env=env, cwd=here,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if line.startswith("EXECUTOR_READY"):
                self.ready.set()

    def wait_ready(self, timeout=120):
        if not self.ready.wait(timeout):
            raise AssertionError(f"phase 14: executor {self.eid} did not "
                                 f"register: {self.lines[-20:]}")

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def _wire_scheduler(work_dir, policy="pull"):
    service, httpd = serve_scheduler(work_dir, policy=policy,
                                     executor_timeout_s=WIRE_EXPIRY_S,
                                     device="cuda")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    return service, httpd, SchedulerRpcClient(url, timeout=120,
                                              device="cuda")


def _wire_job(service, client, job_id):
    """Stages, the stages each executor ran (in any attempt: a stage's
    merged metrics list every executor that finished one of its tasks),
    spec version, bytes spilled, inputs restored and fetched, and kernel
    launches per entry point (masked_slot_sums_rows, masked_slot_sums)
    summed over the job's task metrics."""
    stages = client.job_status(job_id)["stages"]
    per_ex, spilled, restored, fetched = {}, 0, 0, 0
    launches = np.zeros(2, dtype=np.int64)
    for st in stages.values():
        m = st.get("metrics") or {}
        for e in m.get("executors", []):
            per_ex[e] = per_ex.get(e, 0) + 1
        spilled += m.get("spilled_bytes", 0)
        restored += m.get("inputs_restored", 0)
        fetched += m.get("inputs_fetched", 0)
        counts = m.get("kernel_launches", {})
        launches += [counts.get("masked_slot_sums_rows", 0),
                     counts.get("masked_slot_sums", 0)]
    return dict(stages=len(stages), ran=per_ex,
                version=service.specs[job_id].version, spilled=spilled,
                restored=restored, fetched=fetched, launches=launches)


def _wire_query(label, service, client, sf1_ctx, q):
    """Submit, wait, and hold the answer to answers/sf1 and the in-core
    answer; returns (seconds, job summary)."""
    t0 = time.perf_counter()
    job_id = client.submit_sql(TPCH_QUERIES[q], {"kind": "tpch", "sf": SF},
                               options={"n_partitions": WIRE_P}, ctx=sf1_ctx)
    batch, schema = client.wait_batch(job_id, timeout_s=600)
    took = time.perf_counter() - t0
    got = to_numpy(batch, schema)
    check_answers(got, schema, q)
    _same_answer(f"phase 14 {label} Q{q}", got, _incore(sf1_ctx, q))
    return took, job_id, _wire_job(service, client, job_id)


def wire_pull(service, client, sf1_ctx):
    """(a): the 22 queries through two pull executors."""
    launches, ran = np.zeros(2, dtype=np.int64), set()
    t0 = time.perf_counter()
    for q in range(1, 23):
        took, _, j = _wire_query("(a)", service, client, sf1_ctx, q)
        ran |= set(j["ran"])
        launches += j["launches"]
        if q == 1 and j["launches"].sum() < 1:
            raise AssertionError("phase 14 (a): Q1 launched no kernel in "
                                 "the executors")
        log(f"phase 14 (a): Q{q} over the wire: equals answers/sf1 and the "
            f"in-core answer; {took:.4f} s from submit to result; "
            f"{j['stages']} stages; stages run per executor {j['ran']}; spec "
            f"version {j['version']}; {j['spilled']} B spilled; inputs "
            f"restored {j['restored']}, fetched {j['fetched']}; kernel "
            f"launches in the executors {j['launches'].tolist()}")
    if ran != {"pull-a", "pull-b"}:
        raise AssertionError(f"phase 14 (a): tasks ran on {sorted(ran)}")
    log(f"phase 14 (a): {time.perf_counter() - t0:.1f} s for 22 queries; "
        f"kernel launches in the executors {launches.tolist()}")
    return launches


def wire_push(service, client, sf1_ctx):
    """(b): Q1, Q3, Q5 and Q21 through two push executors."""
    launches = np.zeros(2, dtype=np.int64)
    for q in WIRE_PUSH:
        took, _, j = _wire_query("(b)", service, client, sf1_ctx, q)
        launches += j["launches"]
        log(f"phase 14 (b): Q{q} pushed: equal; {took:.4f} s; stages run "
            f"per executor {j['ran']}; kernel launches "
            f"{j['launches'].tolist()}")
    return launches


def wire_p2p(service, client, sf1_ctx, sched_dir):
    """(c): Q3 and Q5 between executors whose work dirs are their own."""
    launches, fetched = np.zeros(2, dtype=np.int64), 0
    for q in WIRE_P2P:
        took, _, j = _wire_query("(c)", service, client, sf1_ctx, q)
        launches += j["launches"]
        fetched += j["fetched"]
        log(f"phase 14 (c): Q{q} peer to peer: equal; {took:.4f} s; stages "
            f"run per executor {j['ran']}; stage inputs fetched from peers "
            f"{j['fetched']}, restored {j['restored']}")
    if fetched < 1:
        raise AssertionError("phase 14 (c): no stage input crossed "
                             "through fetch_partition")
    stray = [f for _, _, fs in os.walk(sched_dir) for f in fs]
    if stray:
        raise AssertionError(f"phase 14 (c): the scheduler's store holds "
                             f"{stray[:5]}")
    return launches


def wire_lost(service, client, sf1_ctx, executors):
    """(d): SIGKILL the executor whose task reports first; the job ends on
    the survivor."""
    t0 = time.perf_counter()
    job_id = client.submit_sql(TPCH_QUERIES[WIRE_LOST],
                               {"kind": "tpch", "sf": SF},
                               options={"n_partitions": WIRE_P}, ctx=sf1_ctx)
    victim = None
    while victim is None and time.perf_counter() - t0 < 120:
        ran = _wire_job(service, client, job_id)["ran"]
        victim = next((ex for ex in executors if ex.eid in ran), None)
        time.sleep(0.005)
    if victim is None:
        raise AssertionError("phase 14 (d): no task reported")
    victim.kill()
    killed_at = time.perf_counter() - t0
    batch, schema = client.wait_batch(job_id, timeout_s=600)
    took = time.perf_counter() - t0
    got = to_numpy(batch, schema)
    check_answers(got, schema, WIRE_LOST)
    _same_answer(f"phase 14 (d) Q{WIRE_LOST}", got,
                 _incore(sf1_ctx, WIRE_LOST))
    j = _wire_job(service, client, job_id)
    survivor = [ex for ex in executors if ex is not victim][0]
    if survivor.eid not in j["ran"] or survivor.proc.poll() is not None:
        raise AssertionError(f"phase 14 (d): {j['ran']}")
    log(f"phase 14 (d): Q{WIRE_LOST}: {victim.eid} killed (SIGKILL) "
        f"{killed_at:.3f} s after submit, after its first task reported; "
        f"the job finished on {survivor.eid}, equal; {took:.4f} s; spec "
        f"version {j['version']}; stages run per executor {j['ran']}; "
        f"inputs restored {j['restored']}")
    return victim, j["launches"]


def wire_stop(services, executors):
    """(e): SIGTERM every live executor; each exits 0 and leaves its
    scheduler's registry."""
    for ex in executors:
        ex.proc.send_signal(signal.SIGTERM)
    for ex in executors:
        code = ex.proc.wait(timeout=60)
        if code != 0:
            raise AssertionError(f"phase 14 (e): {ex.eid} exited {code}")
    deadline = time.perf_counter() + 30
    left = [ex.eid for ex in executors]
    while left and time.perf_counter() < deadline:
        left = [eid for eid in left if any(
            eid in svc.scheduler.executor_manager.executors
            for svc in services)]
        time.sleep(0.05)
    if left or not all(any(svc.scheduler.executor_manager.is_dead(ex.eid)
                           for svc in services) for ex in executors):
        raise AssertionError(f"phase 14 (e): still registered: {left}")
    log(f"phase 14 (e): {len(executors)} executors stopped by SIGTERM, "
        "exit code 0, deregistered")


def wire_held(sf1_ctx):
    """The kernel against its plain version on the call an executor's
    partial aggregate of Q1 makes at P = WIRE_P (the same stage run in this
    process)."""
    mesh = make_mesh(WIRE_P, devices=[torch.device("cuda")] * WIRE_P)
    with spy_rows() as calls:
        execute_distributed(sf1_ctx, sf1_ctx.sql(TPCH_QUERIES[1]).plan, mesh,
                            DistOptions(n_partitions=WIRE_P))
    call = max((c for c in calls if c[2] == Q1_T),
               key=lambda c: c[0].shape[0])
    del calls
    held = hold_call(14, f"one partition's partial aggregate of Q1 at "
                     f"P = {WIRE_P}, the executors' call", *call)
    sf1_ctx.evict_device()
    return held


def phase_wire(sf1_ctx):
    """Phase 14. Returns (kernel launches in the executors and this
    process, the held call's numbers)."""
    import tempfile
    t_start = time.perf_counter()
    # the in-core answers phase 14 holds the wire's to, computed before the
    # launches are counted (phases 4-8 leave them all; --wire-only does not)
    for q in range(1, 23):
        _incore(sf1_ctx, q)
    _fresh(sf1_ctx)     # the executor processes share the card
    held = wire_held(sf1_ctx)
    procs, servers, services = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            pull = _wire_scheduler(os.path.join(tmp, "shuffle"))
            push = _wire_scheduler(os.path.join(tmp, "shuffle_push"), "push")
            p2p_dir = os.path.join(tmp, "sched_p2p")
            p2p = _wire_scheduler(p2p_dir)
            for svc, httpd, _ in (pull, push, p2p):
                services.append(svc)
                servers.append(httpd)
            pulls = [_Executor(pull[2].url, eid) for eid in ("pull-a",
                                                              "pull-b")]
            pushes = [_Executor(push[2].url, eid, "push")
                      for eid in ("push-a", "push-b")]
            peers = [_Executor(p2p[2].url, eid,
                               work_dir=os.path.join(tmp, eid))
                     for eid in ("p2p-a", "p2p-b")]
            procs = pulls + pushes + peers
            for ex in procs:
                ex.wait_ready()
            log(f"phase 14: 3 schedulers, {len(procs)} executor processes "
                f"of {WIRE_P} partitions on the card registered in "
                f"{time.perf_counter() - t_start:.1f} s")
            reset_counts()
            launches = wire_pull(pull[0], pull[2], sf1_ctx)
            t0 = time.perf_counter()
            launches += wire_push(push[0], push[2], sf1_ctx)
            log(f"phase 14 (b): {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            launches += wire_p2p(p2p[0], p2p[2], sf1_ctx, p2p_dir)
            log(f"phase 14 (c): {time.perf_counter() - t0:.1f} s")
            victim, lost_launches = wire_lost(pull[0], pull[2], sf1_ctx,
                                              pulls)
            launches += lost_launches
            wire_stop(services, [ex for ex in procs if ex is not victim])
            here = read_counts()
        finally:
            for ex in procs:
                ex.kill()
            for httpd in servers:
                httpd.shutdown()
                httpd.server_close()
    log(f"phase 14: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"in the executors {launches.tolist()}, in this process (the "
        f"client's folded subqueries) {here.tolist()}")
    return launches + here, held


def phase_wire_alone():
    """Phase 14 without phases 3-13: the SF1 tables made here, the in-core
    answers computed at the phase's start."""
    t0 = time.perf_counter()
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in generate_tpch(SF, SEED).items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    log(f"phase 14: TPC-H SF1 generated in {time.perf_counter() - t0:.1f} s")
    return phase_wire(ctx)


# ---------------------------------------------------------------------------
# Phase 15: RAW strings at full width
# ---------------------------------------------------------------------------

RAW_DIST_QUERIES = (1, 13)
# phase 11's J1_1e7 context and x, which (b) reads
JOIN_KEPT = {}
# (a)'s answers, which (c) holds its paths to
RAW_ANSWERS = {}


class raw_threshold:
    """BALLISTA_RAW_DICT_MAX set to `value` while the block runs: what
    every process of the port reads at ingest (the executors started in
    the block inherit it)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("BALLISTA_RAW_DICT_MAX")
        os.environ["BALLISTA_RAW_DICT_MAX"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("BALLISTA_RAW_DICT_MAX", None)
        else:
            os.environ["BALLISTA_RAW_DICT_MAX"] = self.old


class spy_tables:
    """Host seconds spent making dictionary tables while the block runs,
    by kind (`exprs.dict_cached`'s `make`: "str" conversions, "recode"
    dense ranks, "like" lookup tables, "value_hash"), each kind's own
    time: a recode that converts its dictionary first counts that under
    "str"."""

    def __enter__(self):
        self.real = exprs_mod.dict_cached
        seconds, stack = {}, []

        def cached(dictionary, what, make):
            def timed():
                stack.append(0.0)
                t0 = time.perf_counter()
                try:
                    return make()
                finally:
                    took = time.perf_counter() - t0
                    inner = stack.pop()
                    seconds[what[0]] = seconds.get(what[0], 0.0) + took - inner
                    if stack:
                        stack[-1] += took
            return self.real(dictionary, what, timed)

        exprs_mod.dict_cached = cached
        return seconds

    def __exit__(self, *exc):
        exprs_mod.dict_cached = self.real


def _seconds(secs):
    return ", ".join(f"{k} {v:.3f} s" for k, v in sorted(secs.items())) \
        or "none made"


def raw_tpch(sf1_ctx):
    """(a): the 22 queries over phase 6's rows with every string column
    RAW. Returns (the RAW context, kernel launches over the first runs,
    the held Q1 call's numbers)."""
    t0 = time.perf_counter()
    ctx = SessionContext(device="cuda")
    with raw_threshold("0"):
        register_tpch(ctx, SF, data={
            name: (tp.fields, tp.host) for name, tp in sf1_ctx.tables.items()
            if name in TPCH_TABLES})
    for name, tp in ctx.tables.items():
        strings = {f.name for f in tp.fields
                   if f.dtype.kind is TypeKind.STRING}
        # lineitem is above the eager-metadata threshold: ingest its strings
        tp.ensure_meta(sorted(strings))
        if tp.schema.unsorted != strings:
            raise AssertionError(f"phase 15 (a): {name} RAW columns "
                                 f"{tp.schema.unsorted} != {strings}")
    n_comment = len(ctx.tables["lineitem"].host["l_comment"].dictionary)
    if n_comment != LINEITEM_ROWS:
        raise AssertionError(f"phase 15 (a): l_comment RAW dictionary of "
                             f"{n_comment} entries")
    log(f"phase 15 (a): the eight SF1 tables registered with every string "
        f"column RAW in {time.perf_counter() - t0:.2f} s (l_comment: "
        f"{n_comment} dictionary entries)")
    launches, held = np.zeros(2, dtype=np.int64), None
    for q in range(1, 23):
        sql = TPCH_QUERIES[q]
        reset_counts()
        with spy_rows() as calls, spy_tables() as secs:
            t0 = time.perf_counter()
            batch, schema = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        counts = read_counts()
        launches += counts
        got = to_numpy(batch, schema)
        del batch
        check_answers(got, schema, q)
        _same_answer(f"phase 15 (a) Q{q}", got, _incore(sf1_ctx, q))
        RAW_ANSWERS[q] = got
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            ctx.sql(sql).collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        log(f"phase 15 (a): Q{q} all RAW: equals answers/sf1 and the sorted "
            f"answer; first run {first:.4f} s (dictionary tables made: "
            f"{_seconds(secs)}), warm median "
            f"{statistics.median(warm) * 1e3:.3f} ms; masked_slot_sums_rows "
            f"launches {counts[0]}, calls at (A, n), T = "
            f"{call_shapes(calls)}")
        if q == 1:
            if counts[0] < 1 or call_shapes(calls) != [((Q1_A, Q1_N), Q1_T)]:
                raise AssertionError(f"phase 15 (a): all-RAW Q1's kernel "
                                     f"calls {call_shapes(calls)}")
            held = hold_call(15, "all-RAW Q1's own kernel inputs", *calls[0])
        del calls
    ctx.evict_device()
    return ctx, launches, held


def _count_like(uniq, counts, piece):
    """Rows whose value holds `piece`, by a Python test over the distinct
    values (a reference independent of the port's LIKE)."""
    return int(sum(c for s, c in zip(uniq.tolist(), counts.tolist())
                   if piece in s))


def raw_h2o_x(ctx, x):
    """(b): id6 of J1_1e7's x (RAW at the default threshold) against numpy
    on the same host arrays. Returns the kernel launches."""
    ids = x["id6"]
    t0 = time.perf_counter()
    uniq, inv, counts = np.unique(ids, return_inverse=True,
                                  return_counts=True)
    log(f"phase 15 (b): numpy: {len(uniq)} distinct id6 of {len(ids)} rows "
        f"in {time.perf_counter() - t0:.2f} s")
    launches = np.zeros(2, dtype=np.int64)

    def question(label, sql):
        with spy_tables() as secs:
            batch, schema, n, retries = _timed_question(ctx, label, sql, 15)
        log(f"phase 15 (b): {label}: dictionary tables made: "
            f"{_seconds(secs)}; overflow retries {retries}")
        nonlocal launches
        launches = launches + n
        got = _raw_columns(batch, schema)
        del batch
        return got, schema

    got, schema = question(
        "GROUP BY id6", "SELECT id6, count(*) c, sum(id1) s FROM x GROUP BY "
        "id6")
    codes, ok = got["id6"]
    if not ok.all() or len(codes) != len(uniq):
        raise AssertionError(f"phase 15 (b): {len(codes)} groups, numpy "
                             f"{len(uniq)}")
    order = np.argsort(codes, kind="stable")
    keys = schema.dictionary("id6")[codes[order]].astype(str)
    if not np.array_equal(keys, uniq):
        raise AssertionError("phase 15 (b): GROUP BY id6 keys differ")
    sums = np.bincount(inv.reshape(-1), weights=x["id1"]).astype(np.int64)
    for name, want in (("c", counts), ("s", sums)):
        if not np.array_equal(got[name][0][order], want):
            raise AssertionError(f"phase 15 (b): GROUP BY id6 {name} differs")
    del got, codes, keys, sums, order
    log("phase 15 (b): GROUP BY id6 equals numpy exactly")

    got, schema = question("ORDER BY id6 LIMIT 100",
                           "SELECT id6 FROM x ORDER BY id6 LIMIT 100")
    first = schema.dictionary("id6")[got["id6"][0]].astype(str)
    if not np.array_equal(first, np.repeat(uniq[:100], counts[:100])[:100]):
        raise AssertionError("phase 15 (b): ORDER BY id6 LIMIT 100 differs")

    got, schema = question("min and max", "SELECT min(id6) mn, max(id6) mx "
                           "FROM x")
    ext = [str(schema.dictionary(k)[got[k][0][0]]) for k in ("mn", "mx")]
    if ext != [uniq[0], uniq[-1]]:
        raise AssertionError(f"phase 15 (b): min/max {ext}")

    needle = str(ids[len(ids) // 3])
    members = [str(ids[len(ids) // k]) for k in (5, 7, 11)] + ["id-none"]
    for label, where, mask in (
            ("equality", f"id6 = '{needle}'", ids == needle),
            ("IN", "id6 IN (" + ", ".join(f"'{v}'" for v in members) + ")",
             np.isin(ids, members)),
            ("LIKE", "id6 LIKE '%4242%'", None)):
        got, _ = question(label, f"SELECT count(*) c, sum(v1) s FROM x "
                          f"WHERE {where}")
        want_c = (int(mask.sum()) if mask is not None
                  else _count_like(uniq, counts, "4242"))
        notes = "count " + _held(f"phase 15 (b) {label} count",
                                 int(got["c"][0][0]), want_c)
        if mask is not None:
            notes += "; sum(v1) " + _held(f"phase 15 (b) {label} sum",
                                          float(got["s"][0][0]),
                                          float(x["v1"][mask].sum()),
                                          SUM_RTOL)
        log(f"phase 15 (b): {label} on id6 equals numpy ({notes})")
    ctx.evict_device()
    return launches


def raw_paths(raw_ctx):
    """(c): Q1 and Q13 over the RAW tables through the partitioned
    runtime at P = 8 and over the wire. Returns the kernel launches
    (this process's, and those the executors' task metrics report)."""
    launches = np.zeros(2, dtype=np.int64)
    mesh = make_mesh(DIST_P, devices=[torch.device("cuda", 0)] * DIST_P)
    dctx = _dist_ctx(raw_ctx, mesh)
    for q in RAW_DIST_QUERIES:
        reset_counts()
        t0 = time.perf_counter()
        got = to_numpy(*dctx.sql(TPCH_QUERIES[q]).collect())
        took = time.perf_counter() - t0
        launches += read_counts()
        _same_answer(f"phase 15 (c) Q{q} at P = {DIST_P}", got,
                     RAW_ANSWERS[q])
        log(f"phase 15 (c): Q{q} all RAW at P = {DIST_P} equals (a) in "
            f"{took:.3f} s")
    dctx.evict_device()
    del dctx
    _fresh(raw_ctx)
    import tempfile
    procs, httpd = [], None
    with raw_threshold("0"), tempfile.TemporaryDirectory() as tmp:
        try:
            t0 = time.perf_counter()
            service, httpd, client = _wire_scheduler(os.path.join(tmp, "s"))
            procs = [_Executor(client.url, eid)
                     for eid in ("raw-a", "raw-b")]
            for ex in procs:
                ex.wait_ready()
            log(f"phase 15 (c): scheduler and 2 executors started with "
                f"BALLISTA_RAW_DICT_MAX=0 in {time.perf_counter() - t0:.1f} s")
            for q in RAW_DIST_QUERIES:
                reset_counts()
                t0 = time.perf_counter()
                job = client.submit_sql(TPCH_QUERIES[q], {"kind": "tpch",
                                                          "sf": SF},
                                        options={"n_partitions": WIRE_P},
                                        ctx=raw_ctx)
                batch, schema = client.wait_batch(job, timeout_s=600)
                took = time.perf_counter() - t0
                if schema.unsorted:
                    raise AssertionError(f"phase 15 (c): the wire answered "
                                         f"RAW columns {schema.unsorted}")
                got = to_numpy(batch, schema)
                check_answers(got, schema, q)
                _same_answer(f"phase 15 (c) Q{q} over the wire", got,
                             RAW_ANSWERS[q])
                summary = _wire_job(service, client, job)
                launches += summary["launches"] + read_counts()
                log(f"phase 15 (c): Q{q} all RAW over the wire equals (a) in "
                    f"{took:.3f} s (the executors' first task generates SF1); "
                    f"stages {summary['stages']}, ran {summary['ran']}, "
                    f"spec v{summary['version']}, kernel launches in the "
                    f"executors {summary['launches'].tolist()}")
        finally:
            for ex in procs:
                ex.kill()
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
    return launches


def phase_raw(sf1_ctx):
    """Phase 15. Returns (kernel launches over its paths, max |kernel -
    plain| on the call it holds)."""
    t_start = time.perf_counter()
    sf1_ctx.evict_device()
    raw_ctx, launches, held = raw_tpch(sf1_ctx)
    log(f"phase 15 (a): {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    launches = launches + raw_h2o_x(JOIN_KEPT["ctx"], JOIN_KEPT["x"])
    JOIN_KEPT.clear()
    log(f"phase 15 (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = launches + raw_paths(raw_ctx)
    log(f"phase 15 (c): {time.perf_counter() - t0:.1f} s")
    raw_ctx.evict_device()
    log(f"phase 15: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"{launches.tolist()}")
    return launches, held


def phase_raw_alone():
    """Phase 11's h2o join and phase 15 without the other phases: the SF1
    tables made here, the sorted in-core answers computed on demand."""
    t0 = time.perf_counter()
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in generate_tpch(SF, SEED).items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    log(f"phase 15: TPC-H SF1 generated in {time.perf_counter() - t0:.1f} s")
    launches = phase_h2o_join()
    more, held = phase_raw(ctx)
    return launches + more, held


# ---------------------------------------------------------------------------
# Phase 16: the TPC-H tools at full width (SF1)
# ---------------------------------------------------------------------------

TBL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "tpch_sf1_tbl")
# the query whose answer file prints an exact midpoint at SF1 (Q9's JAPAN
# 1998, 22091132.2950 at two places): the runner must report it
MIDPOINT_Q = 9
LOAD_QUERIES = (1, 3, 6)
SCALING_P = (1, 2, 4, 8)
CLI_QUERIES = "1,6,21"
WIRE_TBL_QUERIES = (1, 6)
AVRO_QUERIES = (13, 22)
PLUGIN_SRC = '''BALLISTA_PLUGIN_API = 1


def register(ctx):
    from ballista_tpu_torch.schema import INT64
    ctx.register_udf("smoke_triple_plus_one", lambda x: x * 3 + 1, INT64)
'''


def _repo_env():
    here = os.path.dirname(os.path.abspath(__file__))
    return here, dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))


def tools_write():
    """(a): the datagen CLI writes the eight SF1 tables as .tbl files."""
    here, env = _repo_env()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.datagen", "--sf", str(SF),
         "--format", "tbl", "--out", TBL_DIR], cwd=here, env=env,
        capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"phase 16 (a): datagen exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    for line in (out.stderr + out.stdout).splitlines():
        log(f"phase 16 (a): {line}")
    sizes = {name: os.path.getsize(os.path.join(TBL_DIR, f"{name}.tbl"))
             for name in TPCH_TABLES}
    log(f"phase 16 (a): `python -m ballista_tpu_torch.datagen --sf 1 "
        f"--format tbl` in {took:.2f} s; bytes per table {sizes}")


def tools_read_back(source):
    """(b): every column read back by read_tbl equals the generated host
    column (values, validity, the strings behind the codes). Returns the
    tables read."""
    tables, secs = {}, {}
    for name in TPCH_TABLES:
        t0 = time.perf_counter()
        fields, cols = read_tbl(os.path.join(TBL_DIR, f"{name}.tbl"), name)
        secs[name] = round(time.perf_counter() - t0, 3)
        want_fields, want = source[name]
        if tuple(fields) != tuple(want_fields):
            raise AssertionError(f"phase 16 (b): {name} fields {fields}")
        for f in fields:
            a, b = cols[f.name], want[f.name]
            same = (np.array_equal(a.validity, b.validity)
                    and a.values.dtype == b.values.dtype
                    and np.array_equal(a.values, b.values)
                    and (a.dictionary is None) == (b.dictionary is None)
                    and (a.dictionary is None or np.array_equal(
                        a.dictionary.astype(str), b.dictionary.astype(str))))
            if not same:
                raise AssertionError(f"phase 16 (b): {name}.{f.name} read "
                                     "back differs from the generated column")
        tables[name] = (fields, cols)
    log(f"phase 16 (b): the eight tables read back equal to "
        f"generate_tpch(1, {SEED}) column by column; read_tbl seconds per "
        f"table {secs}, {sum(secs.values()):.2f} s in all")
    return tables


def tools_runner(source):
    """(c): runner.run over the .tbl files, every query exact against
    answers/sf1; Q1's kernel call held against its plain version. Returns
    (kernel launches, the held call's numbers)."""
    reset_counts()
    t0 = time.perf_counter()
    with spy_rows(first_at=Q1_T) as calls:
        results = runner_mod.run(SF, list(range(1, 23)), 3, tbl_dir=TBL_DIR,
                                 expected=EXPECTED_DIR, device="cuda")
    took = time.perf_counter() - t0
    launches = read_counts()
    bad = {q: r for q, r in results.items() if r.get("match") is not True}
    if bad:
        raise AssertionError(f"phase 16 (c): runner results {bad}")
    if not results[MIDPOINT_Q].get("midpoints"):
        raise AssertionError(f"phase 16 (c): Q{MIDPOINT_Q}'s midpoint was "
                             "not reported")
    for q, r in results.items():
        warm = WARM_MS.get(q)
        log(f"phase 16 (c): Q{q} runner {r['ms']:.3f} ms warm (mean of 3 "
            f"run_plan), first run {r['compile_s']:.3f} s, {r['rows']} rows, "
            f"equals answers/sf1; phases 4-8 warm median "
            + (f"{warm:.3f} ms" if warm is not None else "not run")
            + "".join(f"; {note}" for note in r.get("midpoints", [])))
    q1_n = round_capacity(len(source["lineitem"][1]["l_orderkey"].values))
    if launches[0] < 1 or call_shapes(calls) != [((Q1_A, q1_n), Q1_T)]:
        raise AssertionError(f"phase 16 (c): Q1's kernel calls "
                             f"{call_shapes(calls)}")
    held = hold_call(16, "tbl-ingested Q1 through runner.run", *calls[0])
    del calls
    log(f"phase 16 (c): runner.run of 22 queries over .tbl in {took:.1f} s; "
        f"kernel launches {launches.tolist()}")
    return launches, held


def tools_runner_cli():
    """(d): the runner's command line, distributed, against answers/sf1."""
    here, env = _repo_env()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.benchmarks.runner",
         "--tbl-dir", TBL_DIR, "--queries", CLI_QUERIES, "--distributed",
         "--expected", EXPECTED_DIR, "--iterations", "1", "--device",
         "cuda"],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    if out.returncode or not lines:
        raise AssertionError(f"phase 16 (d): runner exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    summary = json.loads(lines[-1])["queries"]
    for line in lines[:-1]:
        log(f"phase 16 (d): {line}")
    if [int(q) for q in summary] != [int(q) for q in CLI_QUERIES.split(",")] \
            or not all(r.get("match") is True for r in summary.values()):
        raise AssertionError(f"phase 16 (d): {summary}")
    log(f"phase 16 (d): `runner --tbl-dir --queries {CLI_QUERIES} "
        f"--distributed --expected answers/sf1`: every match true; "
        f"{took:.1f} s")


def tools_wire(tbl_ctx):
    """(e): a scheduler and one pull executor process over the .tbl data
    environment. Returns the kernel launches in the executor."""
    import tempfile
    spec = {"kind": "tbl", "dir": TBL_DIR}
    launches = np.zeros(2, dtype=np.int64)
    t0 = time.perf_counter()
    ex = httpd = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            service, httpd, client = _wire_scheduler(os.path.join(tmp, "s"))
            ex = _Executor(client.url, "tbl-a")
            ex.wait_ready()
            for q in WIRE_TBL_QUERIES:
                t1 = time.perf_counter()
                job_id = client.submit_sql(TPCH_QUERIES[q], spec,
                                           options={"n_partitions": WIRE_P},
                                           ctx=tbl_ctx)
                batch, schema = client.wait_batch(job_id, timeout_s=600)
                check_answers(to_numpy(batch, schema), schema, q)
                j = _wire_job(service, client, job_id)
                launches += j["launches"]
                log(f"phase 16 (e): Q{q} over the wire on {spec}: equals "
                    f"answers/sf1; {time.perf_counter() - t1:.3f} s from "
                    f"submit to result; {j['stages']} stages; kernel "
                    f"launches in the executor {j['launches'].tolist()}")
        finally:
            if ex is not None:
                ex.kill()
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
    if launches.sum() < 1:
        raise AssertionError("phase 16 (e): Q1 launched no kernel in the "
                             "executor")
    log(f"phase 16 (e): {time.perf_counter() - t0:.1f} s, the executor's "
        "own .tbl parse included")
    return launches


def tools_load_scaling(tbl_ctx):
    """(f): loadtest, scaling and the scheduler event bench. Returns the
    kernel launches of the first two."""
    reset_counts()
    t0 = time.perf_counter()
    load = runner_mod.loadtest(SF, 4, 4, list(LOAD_QUERIES), ctx=tbl_ctx)
    if load["total_queries"] != 16:
        raise AssertionError(f"phase 16 (f): loadtest {load}")
    log(f"phase 16 (f): loadtest 4 clients x 4 requests over "
        f"{LOAD_QUERIES}: {json.dumps(load)}; {time.perf_counter() - t0:.1f} s")
    tbl_ctx.evict_device()
    t0 = time.perf_counter()
    answers = {}
    points = scaling_mod.run(SF, 1, list(SCALING_P), 3, ctx=tbl_ctx,
                             answers=answers)
    for p in SCALING_P[1:]:
        _same_answer(f"phase 16 (f) scaling P={p}", answers[p], answers[1])
    for pt in points:
        log(f"phase 16 (f): scaling Q1 at P = {pt['partitions']} on "
            f"{pt['devices']} card(s): {pt['ms']:.3f} ms, "
            f"{pt['rows_per_s']} input rows/s, efficiency "
            f"{pt['efficiency_vs_linear']}; equals P = 1")
    log(f"phase 16 (f): scaling {time.perf_counter() - t0:.1f} s")
    launches = read_counts()
    t0 = time.perf_counter()
    events = [scheduler_events.bench_inproc(200, 8, 8, 4),
              scheduler_events.bench_wire(200, 8, 8, device="cuda")]
    for e in events:
        log(f"phase 16 (f): scheduler_events {e['mode']}: {json.dumps(e)}")
    log(f"phase 16 (f): scheduler_events {time.perf_counter() - t0:.1f} s")
    tbl_ctx.evict_device()
    return launches


def tools_avro(tbl_ctx, source):
    """(g): customer written as Avro (deflate) and registered in place of
    the .tbl one; Q13 and Q22 exact. Returns the kernel launches."""
    path = os.path.join(os.path.dirname(TBL_DIR), "customer_sf1.avro")
    try:
        t0 = time.perf_counter()
        write_avro(path, source["customer"], codec="deflate")
        wrote = time.perf_counter() - t0
        t0 = time.perf_counter()
        tbl_ctx.register_avro("customer", path,
                              primary_key=TPCH_TABLES["customer"][1])
        read = time.perf_counter() - t0
        n = tbl_ctx.tables["customer"].num_rows
        if n != len(source["customer"][1]["c_custkey"].values):
            raise AssertionError(f"phase 16 (g): {n} customers")
        log(f"phase 16 (g): customer ({n} rows) written with write_avro "
            f"(deflate) in {wrote:.2f} s ({os.path.getsize(path)} bytes), "
            f"registered with register_avro in {read:.2f} s")
    finally:
        if os.path.exists(path):
            os.remove(path)
    reset_counts()
    for q in AVRO_QUERIES:
        t0 = time.perf_counter()
        batch, schema = tbl_ctx.sql(TPCH_QUERIES[q]).collect()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        check_answers(to_numpy(batch, schema), schema, q)
        log(f"phase 16 (g): Q{q} over the Avro customer equals "
            f"answers/sf1; first run {took:.4f} s")
    return read_counts()


def tools_plugin(tbl_ctx):
    """(h): a plugin directory with one UDF, loaded and run over lineitem,
    against numpy. Returns the kernel launches."""
    import shutil
    import tempfile
    plugin_dir = tempfile.mkdtemp(dir=os.path.dirname(TBL_DIR))
    try:
        with open(os.path.join(plugin_dir, "smoke_udf.py"), "w") as f:
            f.write(PLUGIN_SRC)
        loaded = tbl_ctx.load_plugins(plugin_dir)
    finally:
        shutil.rmtree(plugin_dir)
    if loaded != ["smoke_udf"]:
        raise AssertionError(f"phase 16 (h): loaded {loaded}")
    reset_counts()
    t0 = time.perf_counter()
    batch, schema = tbl_ctx.sql(
        "select sum(smoke_triple_plus_one(l_orderkey)) as s, count(*) as n "
        "from lineitem where l_shipdate <= date '1998-09-02'").collect()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    got = to_numpy(batch, schema)
    cols = tbl_ctx.tables["lineitem"].host
    live = cols["l_shipdate"].values <= parse_date("1998-09-02")
    keys = cols["l_orderkey"].values[live]
    want = (int((keys * 3 + 1).sum()), int(live.sum()))
    mine = (int(got["s"][0][0]), int(got["n"][0][0]))
    if mine != want:
        raise AssertionError(f"phase 16 (h): {mine} != numpy {want}")
    log(f"phase 16 (h): plugin {loaded} loaded; its UDF summed over "
        f"{want[1]} lineitem rows equals numpy ({want[0]}); {took:.4f} s")
    return read_counts()


def phase_tools(source, keep_files=False):
    """Phase 16. `source` is the generated SF1 tables ({name: (fields,
    host columns)}) the files are held to. With `keep_files` the .tbl
    files stay for phase 17, which deletes them. Returns (kernel
    launches, the held Q1 call's numbers)."""
    import shutil
    t_start = time.perf_counter()
    launches = np.zeros(2, dtype=np.int64)
    try:
        t0 = time.perf_counter()
        tools_write()
        log(f"phase 16 (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tables = tools_read_back(source)
        log(f"phase 16 (b): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        more, held = tools_runner(source)
        launches += more
        log(f"phase 16 (c): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tools_runner_cli()
        log(f"phase 16 (d): {time.perf_counter() - t0:.1f} s")
        tbl_ctx = SessionContext(device="cuda")
        register_tpch(tbl_ctx, SF, data=tables)
        del tables
        t0 = time.perf_counter()
        launches += tools_wire(tbl_ctx)
        log(f"phase 16 (e): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches += tools_load_scaling(tbl_ctx)
        log(f"phase 16 (f): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches += tools_avro(tbl_ctx, source)
        log(f"phase 16 (g): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches += tools_plugin(tbl_ctx)
        log(f"phase 16 (h): {time.perf_counter() - t0:.1f} s")
        tbl_ctx.evict_device()
    finally:
        if not keep_files:
            shutil.rmtree(TBL_DIR, ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"in this process and the wire's executor {launches.tolist()}")
    return launches, held


def phase_tools_alone():
    """Phase 16 without phases 3-15: the SF1 tables the files are held
    to are generated here."""
    t0 = time.perf_counter()
    source = generate_tpch(SF, SEED)
    log(f"phase 16: TPC-H SF1 generated in {time.perf_counter() - t0:.1f} s")
    return phase_tools(source)


# ---------------------------------------------------------------------------
# Phase 17: the last modules (lazy ingest, the native encoder, multi-process
# execution on torch.distributed, the Flight SQL codecs)
# ---------------------------------------------------------------------------

# partitions per process of (c): two processes of four, P = 8 on cuda:0
MP_PER = 4
MP_WORLD = 2
# seconds a worker's collective waits for a lost peer, and a whole
# worker's limit
MP_PEER_TIMEOUT_S = 60
MP_LIMIT_S = 400


def rest_lazy(out):
    """(a): the 22 through runner.run(lazy_ingest=True) over the .tbl
    files: every query exact; parse + ingest seconds per column ingested,
    the columns never ingested; Q1's kernel call held. Returns (kernel
    launches, the held call's numbers)."""
    from ballista_tpu_torch.datagen.tbl import register_tpch_tbl
    ctx = SessionContext(device="cuda")
    t0 = time.perf_counter()
    register_tpch_tbl(ctx, TBL_DIR)
    reg_s = time.perf_counter() - t0
    log(f"phase 17 (a): register_tpch_tbl (separators only) {reg_s:.2f} s: "
        + ", ".join(f"{n} {tp.tbl.seconds:.2f} s"
                    for n, tp in ctx.tables.items()))
    reset_counts()
    t0 = time.perf_counter()
    with spy_rows(first_at=Q1_T) as calls:
        results = runner_mod.run(SF, list(range(1, 23)), 1, ctx=ctx,
                                 expected=EXPECTED_DIR, lazy_ingest=True)
    took = time.perf_counter() - t0
    launches = read_counts()
    bad = {q: r for q, r in results.items() if r.get("match") is not True}
    if bad:
        raise AssertionError(f"phase 17 (a): runner results {bad}")
    parsed, never = 0.0, {}
    for name, tp in ctx.tables.items():
        secs = tp.tbl.parse_seconds
        parsed += sum(secs.values())
        log(f"phase 17 (a): {name}: parse + ingest s per column ingested "
            + json.dumps({c: round(v, 3) for c, v in secs.items()}))
        never[name] = [f.name for f in tp.fields
                       if f.name not in tp.host.ingested]
    log(f"phase 17 (a): the 22 through runner.run(lazy_ingest=True) all "
        f"equal answers/sf1 in {took:.1f} s; parse + ingest of the columns "
        f"read {parsed:.2f} s in all (phase 16 (c) ingests every column in "
        f"its warm pass: its '# ingest' line); never ingested "
        f"({sum(map(len, never.values()))}): {json.dumps(never)}")
    if "l_comment" not in never["lineitem"]:
        raise AssertionError("phase 17 (a): l_comment was ingested")
    if launches[0] < 1 or call_shapes(calls) != [((Q1_A, Q1_N), Q1_T)]:
        raise AssertionError(f"phase 17 (a): Q1's kernel calls "
                             f"{call_shapes(calls)}")
    held = hold_call(17, "lazily ingested .tbl Q1 through runner.run",
                     *calls[0])
    del calls
    out["tables"] = {n: tp.tbl for n, tp in ctx.tables.items()}
    ctx.evict_device()
    return launches, held


def rest_native(tbls):
    """(b): the native encoder over every string column of the SF1 .tbl
    files against the plain path (`batch._sorted_distinct` over the
    fields' bytes): codes and dictionaries equal, seconds of both."""
    from ballista_tpu_torch import native
    from ballista_tpu_torch.batch import _sorted_distinct
    from ballista_tpu_torch.datagen.tbl import _field_bytes
    tot_native = tot_plain = 0.0
    for name, tbl in tbls.items():
        for j, f in enumerate(tbl.fields):
            if f.dtype.kind is not TypeKind.STRING:
                continue
            start = tbl.line_start if j == 0 else tbl.ends[:, j - 1] + 1
            end = tbl.ends[:, j]
            t0 = time.perf_counter()
            codes, dictionary = native.dict_encode(tbl.buf, start, end)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            mat, _, _ = _field_bytes(tbl.buf, start, end)
            uniq, inv = _sorted_distinct(
                np.ascontiguousarray(mat).view(f"S{mat.shape[1]}").ravel())
            t_plain = time.perf_counter() - t0
            if not (np.array_equal(codes, inv.astype(np.int32))
                    and np.array_equal(dictionary, uniq.astype(str))):
                raise AssertionError(f"phase 17 (b): {name}.{f.name}: native "
                                     "!= plain")
            tot_native += t_native
            tot_plain += t_plain
            log(f"phase 17 (b): {name}.{f.name} ({len(codes)} rows, "
                f"{len(dictionary)} distinct): native {t_native:.3f} s, "
                f"plain {t_plain:.3f} s, codes and dictionary equal")
    log(f"phase 17 (b): every string column: native {tot_native:.2f} s, "
        f"plain {tot_plain:.2f} s; g++ build {NATIVE_BUILD_S[0]:.2f} s "
        "(phase 2)")


def mp_worker(pid, nproc, port, scenario, out_dir):
    """One process of (c), run as `python3 chip_smoke.py --mp-worker pid
    nproc port scenario out_dir`: joins the group over gloo, makes the
    global mesh of MP_PER partitions per process on cuda:0 and runs the
    scenario through execute_distributed (every process the same driver).
    Prints one line `MP_RESULT {json}` and pickles its answers."""
    import pickle

    from ballista_tpu_torch.parallel.multihost import (init_multihost,
                                                       make_global_mesh)
    t0 = time.perf_counter()
    init_multihost(f"127.0.0.1:{port}", nproc, pid)
    mesh = make_global_mesh(MP_PER, device="cuda:0")
    if os.environ.get("BALLISTA_CRASH_WORKER") == str(pid):
        os._exit(17)     # dies without a word: the peer must notice
    masked_sums.load()
    result = {"pid": pid, "scenario": scenario,
              "join_s": round(time.perf_counter() - t0, 3)}
    launches = np.zeros(2, dtype=np.int64)
    answers = {}
    if scenario == "skew":
        more, result["attempts"] = skew_run(mesh, f"phase 17 (c) p{pid} skew")
        launches += more
    else:
        t0 = time.perf_counter()
        ctx = SessionContext(device="cuda")
        register_tpch(ctx, SF)
        result["datagen_s"] = round(time.perf_counter() - t0, 3)
        queries = [1] if scenario == "rerun" else list(range(1, 23))
        firsts = {}
        for q in queries:
            reset_counts()
            with spy_rows(first_at=Q1_T) as calls:
                t0 = time.perf_counter()
                batch, schema = execute_distributed(
                    ctx, ctx.sql(TPCH_QUERIES[q]).plan, mesh,
                    DistOptions(n_partitions=len(mesh)))
                torch.cuda.synchronize()
                firsts[q] = round(time.perf_counter() - t0, 4)
            launches += read_counts()
            got = to_numpy(batch, schema)
            check_answers(got, schema, q)
            answers[q] = got
            if q == 1 and pid == 0 and scenario == "basic":
                if not calls or call_shapes(calls)[0][0][0] != Q1_A:
                    raise AssertionError(f"Q1's kernel calls "
                                         f"{call_shapes(calls)}")
                result["held"] = hold_call(
                    17, f"p{pid}'s partition of Q1 at P = {len(mesh)} over "
                    f"{nproc} processes", *calls[0])
            del calls, batch
        result["first_s"] = firsts
        log(f"phase 17 (c) p{pid}: the {len(queries)} queries equal "
            f"answers/sf1; first runs {json.dumps(firsts)}")
    result["launches"] = launches.tolist()
    with open(os.path.join(out_dir, f"p{pid}.pkl"), "wb") as f:
        pickle.dump(answers, f)
    print("MP_RESULT " + json.dumps(result), flush=True)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mp_pair(scenario, out_dir, extra_env=None, limit=MP_LIMIT_S):
    """Start MP_WORLD worker processes of `scenario` and wait for both
    (each with a time limit; every process is killed in a finally).
    Returns [(exit code, output lines, its MP_RESULT or None)]."""
    here, env = _repo_env()
    env = dict(env, BALLISTA_PEER_TIMEOUT=str(MP_PEER_TIMEOUT_S),
               **(extra_env or {}))
    port = _free_port()
    procs = []
    try:
        for pid in range(MP_WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker",
                 str(pid), str(MP_WORLD), str(port), scenario, out_dir],
                cwd=here, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        out = []
        deadline = time.perf_counter() + limit
        for p in procs:
            text = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0]
            lines = text.splitlines()
            res = [json.loads(l[len("MP_RESULT "):]) for l in lines
                   if l.startswith("MP_RESULT ")]
            out.append((p.returncode, lines, res[0] if res else None))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _mp_check(label, runs):
    for pid, (rc, lines, res) in enumerate(runs):
        for line in lines:
            if not line.startswith("MP_RESULT "):
                log(f"phase 17 (c) {label} p{pid}| {line}")
        if rc != 0 or res is None:
            raise AssertionError(f"phase 17 (c) {label}: worker {pid} exited "
                                 f"{rc}")


def rest_multiprocess():
    """(c): two processes on cuda:0 over gloo, four partitions each: the
    22 at SF1 (exact, and equal to phase 13's where it ran), the skew
    scenario (phase 13 (c)'s sequence of options), the crash of one
    worker (the survivor exits non-zero within its timeout) and a fresh
    pair's Q1. Returns (kernel launches in the workers, p0's held Q1
    call)."""
    import pickle
    import shutil
    import tempfile
    launches = np.zeros(2, dtype=np.int64)
    out_dir = tempfile.mkdtemp(dir=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build"))
    try:
        t0 = time.perf_counter()
        runs = mp_pair("basic", out_dir)
        _mp_check("basic", runs)
        took = time.perf_counter() - t0
        for pid, (_, _, res) in enumerate(runs):
            launches += res["launches"]
            with open(os.path.join(out_dir, f"p{pid}.pkl"), "rb") as f:
                answers = pickle.load(f)
            for q, got in answers.items():
                if q in DIST_ANSWERS:
                    _same_answer(f"phase 17 (c) p{pid} Q{q} against phase 13",
                                 got, DIST_ANSWERS[q])
        held = runs[0][2]["held"]
        log(f"phase 17 (c): the 22 at SF1 over {MP_WORLD} processes x "
            f"{MP_PER} partitions on cuda:0: every answer equals "
            f"answers/sf1" + (" and phase 13's" if DIST_ANSWERS else "")
            + f" in both processes; {took:.1f} s in all (join "
            f"{[r[2]['join_s'] for r in runs]} s, datagen "
            f"{[r[2]['datagen_s'] for r in runs]} s); kernel launches per "
            f"process {[r[2]['launches'] for r in runs]}")
        t0 = time.perf_counter()
        runs = mp_pair("skew", out_dir)
        _mp_check("skew", runs)
        seqs = [r[2]["attempts"] for r in runs]
        if seqs[0] != seqs[1] or (DIST_SKEW_SEQ and [tuple(a) for a in
                                                     seqs[0]] != DIST_SKEW_SEQ):
            raise AssertionError(f"phase 17 (c) skew: attempts {seqs} vs "
                                 f"phase 13 {DIST_SKEW_SEQ}")
        for _, _, res in runs:
            launches += res["launches"]
        log(f"phase 17 (c): skew at {SKEW_N} rows: both processes equal "
            f"numpy and took the same options"
            + (" as phase 13 (c)" if DIST_SKEW_SEQ else "")
            + f" {seqs[0]}; {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        runs = mp_pair("basic", out_dir, {"BALLISTA_CRASH_WORKER": "1"},
                       limit=MP_PEER_TIMEOUT_S + 120)
        (rc0, lines0, res0), (rc1, _, _) = runs
        lost = time.perf_counter() - t0
        if rc1 != 17 or rc0 == 0 or res0 is not None:
            raise AssertionError(f"phase 17 (c) crash: exit codes {rc0}, "
                                 f"{rc1}: {lines0[-20:]}")
        log(f"phase 17 (c): crash: worker 1 exited 17 after joining; worker "
            f"0 exited {rc0} without an answer after {lost:.1f} s (peer "
            f"timeout {MP_PEER_TIMEOUT_S} s): {lines0[-1] if lines0 else ''}")
        t0 = time.perf_counter()
        runs = mp_pair("rerun", out_dir)
        _mp_check("rerun", runs)
        for _, _, res in runs:
            launches += res["launches"]
        log(f"phase 17 (c): a fresh pair answers Q1 exactly; "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches, held


def rest_flightsql():
    """(d): the Flight SQL codecs round-trip (pure Python, no pyarrow);
    then, without pyarrow, `serve --flight-port` and `datagen --chunks`
    raise an ImportError that names it; with it, they run."""
    from ballista_tpu_torch import flightsql as fsql
    from ballista_tpu_torch import serve
    from ballista_tpu_torch.datagen.__main__ import main as datagen
    t0 = time.perf_counter()
    q = "select l_returnflag, count(*) from lineitem group by 1 -- é"
    checks = [
        (fsql.parse_statement_query(
            fsql.unpack_any(fsql.command_statement_query(q))[1]), q),
        (fsql.parse_ticket_statement(fsql.unpack_any(
            fsql.ticket_statement_query(b"h\x00\xff"))[1]), b"h\x00\xff"),
        (fsql.parse_get_tables(fsql.unpack_any(fsql.command_get_tables(
            "ballista", "pub%", "line%", ("TABLE",), True))[1]),
         {"catalog": "ballista", "db_schema_filter": "pub%",
          "table_name_filter": "line%", "table_types": ("TABLE",),
          "include_schema": True}),
        (fsql.parse_get_sql_info(fsql.unpack_any(
            fsql.command_get_sql_info((0, 1, 500)))[1]), (0, 1, 500)),
        (fsql.parse_do_put_update_result(fsql.do_put_update_result(2 ** 40)),
         2 ** 40),
        (fsql.unpack_any(fsql.command_get_catalogs()),
         ("CommandGetCatalogs", b"")),
    ]
    for got, want in checks:
        if got != want:
            raise AssertionError(f"phase 17 (d): {got!r} != {want!r}")
    log(f"phase 17 (d): {len(checks)} Flight SQL messages round-trip "
        f"through ballista_tpu_torch.flightsql on this host "
        f"({(time.perf_counter() - t0) * 1000:.2f} ms)")
    try:
        import pyarrow.flight  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        log(f"phase 17 (d): no pyarrow here ({e})")
        rest_without_pyarrow(serve, datagen)
    else:
        rest_with_pyarrow(datagen)


def rest_without_pyarrow(serve, datagen):
    """(d) without pyarrow: `serve --flight-port` and `datagen --chunks`
    raise an ImportError naming it, before serving or writing anything."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for what, call in (
                ("serve --flight-port", lambda: serve.main(
                    ["--flight-port", "8815", "--device", "cuda", "--port",
                     "0"])),
                ("datagen --chunks", lambda: datagen(
                    ["--sf", "0.01", "--chunks", "2", "--out",
                     os.path.join(tmp, "chunks")]))):
            try:
                call()
            except ImportError as e:
                if "pyarrow" not in str(e):
                    raise
                log(f"phase 17 (d): {what} raises ImportError: {e}")
            else:
                raise AssertionError(f"phase 17 (d): {what} did not raise")
        if os.listdir(tmp):
            raise AssertionError("phase 17 (d): datagen --chunks wrote "
                                 f"{os.listdir(tmp)}")


def rest_with_pyarrow(datagen):
    """(d) where pyarrow is installed: `datagen --chunks 3 --workers 2`
    writes orders at SF 0.1, it registers as a parquet dataset on the
    card, and a Flight SQL server over that context answers as the
    context does."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ballista_tpu_torch.flight import BallistaFlightServer, flight_query
    out = os.path.join(os.path.dirname(TBL_DIR), "chunks_sf01")
    sql = ("select o_orderpriority, count(*) n, sum(o_totalprice) p from "
           "orders group by o_orderpriority order by o_orderpriority")
    server = None
    try:
        t0 = time.perf_counter()
        datagen(["--sf", "0.1", "--chunks", "3", "--workers", "2",
                 "--tables", "orders", "--out", out])
        wrote = time.perf_counter() - t0
        ctx = SessionContext(device="cuda")
        ctx.register_parquet_dataset("orders", os.path.join(out, "orders"),
                                     TPCH_TABLES["orders"][1])
        rows = pq.read_table(os.path.join(out, "orders")).num_rows
        if not ctx.tables["orders"].num_rows == rows == 150_000:
            raise AssertionError(f"phase 17 (d): {rows} orders")
        direct = to_numpy(*ctx.sql(sql).collect())
        server = BallistaFlightServer(ctx=ctx)
        t0 = time.perf_counter()
        got = flight_query(f"grpc://127.0.0.1:{server.port}", sql)
        took = time.perf_counter() - t0
        if got.column("n").to_pylist() != direct["n"][0].tolist() or \
                sum(got.column("n").to_pylist()) != rows:
            raise AssertionError(f"phase 17 (d): Flight {got} != {direct}")
        log(f"phase 17 (d): pyarrow {pa.__version__} is installed here: "
            f"datagen --chunks 3 --workers 2 wrote orders at SF 0.1 in "
            f"{wrote:.2f} s; registered as a dataset on the card, a Flight "
            f"SQL server over it answers as the context does ({took:.3f} s)")
    finally:
        if server is not None:
            server.shutdown()
        import shutil
        shutil.rmtree(out, ignore_errors=True)


def phase_last(write_files):
    """Phase 17. `write_files`: the .tbl files are written here (phase 16
    did not run and leave them). Returns (kernel launches, the held
    numbers of (a)'s Q1 call, those of (c)'s worker call)."""
    import shutil
    t_start = time.perf_counter()
    launches = np.zeros(2, dtype=np.int64)
    out = {}
    try:
        if write_files:
            t0 = time.perf_counter()
            tools_write()
            log(f"phase 17: .tbl files written in "
                f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        more, held = rest_lazy(out)
        launches += more
        log(f"phase 17 (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rest_native(out.pop("tables"))
        log(f"phase 17 (b): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(TBL_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    more, mp_held = rest_multiprocess()
    launches += more
    log(f"phase 17 (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rest_flightsql()
    log(f"phase 17 (d): {time.perf_counter() - t0:.1f} s")
    log(f"phase 17: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"in this process and the workers {launches.tolist()}")
    return launches, held, mp_held


# ---------------------------------------------------------------------------
# Phase 18: TPC-H SF100 on one card, out of core over chunked parquet
# ---------------------------------------------------------------------------

SF100 = 100.0
SF100_CHUNKS = 100
SF100_SERIAL_P = 8
SF100_WARM = 3
SF100_LIMIT_S = 1500        # a datagen or sweep process's time limit
# rows of the plain version's chunks on the SF100 call (its contribution
# matrix of 12 x 6e8 int64 would not fit beside the columns)
PLAIN_CHUNK = 1 << 25


def _host_state(phase, where):
    """nproc, free host memory and free disk where the data goes."""
    import shutil
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            mem[key] = int(rest.split()[0]) * 1024
    free = shutil.disk_usage(where).free
    log(f"phase {phase} (a): nproc {os.cpu_count()}; host memory available "
        f"{mem['MemAvailable'] / GIB:.1f} of {mem['MemTotal'] / GIB:.1f} "
        f"GiB; disk free at {where}: {free / GIB:.1f} GiB")
    return free


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def sf100_datagen(phase, sf, out, tables=None):
    """`python -m ballista_tpu_torch.datagen --sf sf --chunks 100 --workers
    $(nproc)`: chunked parquet under `out`."""
    here, env = _repo_env()
    cmd = [sys.executable, "-m", "ballista_tpu_torch.datagen", "--sf",
           str(sf), "--format", "parquet", "--chunks", str(SF100_CHUNKS),
           "--workers", str(os.cpu_count()), "--out", out]
    if tables:
        cmd += ["--tables", ",".join(tables)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                         text=True, timeout=SF100_LIMIT_S)
    took = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"phase {phase} (b): datagen exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        log(f"phase {phase} (b): {line}")
    log(f"phase {phase} (b): `{' '.join(cmd[2:])}` in {took:.1f} s, "
        f"{_dir_bytes(out)} bytes of parquet")
    return took


def _host_peak():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _dataset_ctx(root, **kwargs):
    ctx = SessionContext(device="cuda", **kwargs)
    for name in sorted(os.listdir(root)):
        ctx.register_parquet_dataset(name, os.path.join(root, name),
                                     TPCH_TABLES[name][1])
    return ctx


def _route_of(ctx, runs):
    warnings = " ".join(ctx.take_warnings())
    if FELL_BACK in warnings:
        return f"in-core OOM -> serial@{runs[-1][0]}"
    if ROUTED in warnings:
        return f"routed serial@{runs[-1][0]}"
    return "in-core"


def sf100_collect(ctx, q, keep_call):
    """(c): one query through collect() with routing on: first run (the
    columns read from the part files included) and warm median; route,
    peaks, host peak RSS. Returns (to_numpy answer, schema, the kernel
    call at T = 12 or None, launches of the first run)."""
    _fresh(ctx)
    ctx.take_warnings()
    before = read_counts()
    with spy_serial() as runs, spy_rows(first_at=12 if keep_call
                                        else -1) as calls:
        t0 = time.perf_counter()
        batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    launches = read_counts() - before
    route = _route_of(ctx, runs)
    alloc, reserved = _peaks()
    got = to_numpy(batch, schema)
    del batch
    read = ctx.tables["lineitem"].read_bytes
    log(f"phase 18 (c): Q{q} route {route}; first run {first:.2f} s "
        f"(parquet read {read} B so far); peak allocated "
        f"{alloc / GIB:.2f} GiB, reserved {reserved / GIB:.2f} GiB; host "
        f"peak RSS {_host_peak() / GIB:.2f} GiB; launches {launches.tolist()}")
    return got, schema, (calls[0] if calls else None), launches, route


def sf100_warm(ctx, q):
    warm = []
    for _ in range(SF100_WARM):
        t0 = time.perf_counter()
        ctx.sql(TPCH_QUERIES[q]).collect()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"phase 18 (c): Q{q} warm runs (s) {[round(w, 4) for w in warm]}, "
        f"median {statistics.median(warm) * 1e3:.3f} ms, "
        f"{ctx.tables['lineitem'].num_rows / statistics.median(warm):.0f} "
        "lineitem rows/s")


def _plain_chunked(slot, rows, T):
    """The plain version over row chunks of PLAIN_CHUNK, summed (int64
    sums wrap alike, so the total is the whole call's)."""
    out = None
    for lo in range(0, slot.shape[0], PLAIN_CHUNK):
        hi = lo + PLAIN_CHUNK
        part = masked_sums.masked_slot_sums_rows_reference(
            slot[lo:hi], [tuple(t[lo:hi] if isinstance(t, torch.Tensor)
                                else t for t in row) for row in rows], T)
        out = part if out is None else out + part
    return out


def hold_sf100_call(slot, rows, T):
    """(d): the kernel's Q1 call at SF100 against its plain version (over
    row chunks), with times, the bytes it must read, its bound at
    3.35 TB/s and index_add_ on the same call (per chunk, its contribution
    matrix prepared, times the chunks)."""
    err = _equal(masked_sums.masked_slot_sums_rows(slot, rows, T),
                 _plain_chunked(slot, rows, T),
                 f"SF100 rows A={len(rows)} n={slot.shape[0]} T={T}")
    call = lambda: masked_sums.masked_slot_sums_rows(slot, rows, T)  # noqa
    ms, dev_ms = cuda_ms(call), cuda_ms(call, queued=True)
    plain = cuda_ms(lambda: _plain_chunked(slot, rows, T), iters=2, warm=1)
    b = bound(slot, row_columns(rows), T, len(rows))
    n = slot.shape[0]
    chunk = min(PLAIN_CHUNK, n)
    contribs = masked_sums.contribution_matrix(
        slot[:chunk], [tuple(t[:chunk] if isinstance(t, torch.Tensor) else t
                             for t in row) for row in rows])
    lib = library_ms(slot[:chunk], contribs, T) * n / chunk
    del contribs
    halves = sum(1 for row in rows if len(row) > 2 and row[2])
    log(f"phase 18 (d): SF100 Q1's own kernel call (n={n}, {b['live']} live "
        f"rows, T={T}, A={len(rows)} described rows, {halves} of them "
        f"half-word): masked_slot_sums_rows equal to its plain version; "
        f"kernel {ms:.4f} ms ({dev_ms:.4f} ms of device work), plain (over "
        f"{-(-n // chunk)} row chunks) {plain:.2f} ms; must read {b['bytes']} "
        f"B, bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share "
        f"{b['bound_ms'] / dev_ms:.3f} of device work; index_add_ "
        f"{lib:.2f} ms (one {chunk}-row chunk x {n / chunk:.1f})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": lib}


def _same_numpy(label, got, want):
    """Two to_numpy answers equal exactly (values where valid, validity)."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    for name in want:
        gv, gm = got[name]
        wv, wm = want[name]
        if not np.array_equal(gm, wm) or list(gv[gm]) != list(wv[wm]):
            raise AssertionError(f"{label}: column {name} differs: "
                                 f"{list(gv[gm])} != {list(wv[wm])}")


def _same_as_reference(label, got, schema, table):
    """A to_numpy answer equals the numpy reference's arrow table: scaled
    integers for decimals, strings, counts."""
    import decimal
    for f in table.schema:
        values, valid = got[f.name]
        dt = schema.field(f.name).dtype
        want = table.column(f.name).to_pylist()
        if dt.kind is TypeKind.DECIMAL:
            want = [int(decimal.Decimal(v).scaleb(dt.scale)) for v in want]
        have = [v if isinstance(v, str) else int(v) for v in values]
        if not valid.all() or have != want:
            raise AssertionError(f"{label}: {f.name} {have} != numpy {want}")


def sf100_q1_sql(where, order_by):
    sql = TPCH_QUERIES[1].replace(
        "l_shipdate <= date '1998-09-02'",
        "l_shipdate <= date '1998-09-02'" + where)
    return sql[:sql.index("order by")] + f"order by\n    {order_by}\n"


def sf100_reads(ctx):
    """(c) on its own context, no part file decoded again: Q1 over
    l_linestatus = 'F' ordered by sum_charge desc, a sum wide by its bound
    whose values fit int64, narrowed; Q1 ordered by sum_charge, whose N|O
    value passes int64, must raise the wide-decimal error naming it.
    Returns (kernel launches, the first's to_numpy answer, its schema)."""
    li = ctx.tables["lineitem"]
    read = li.read_bytes
    sql = sf100_q1_sql(" and l_linestatus = 'F'", "sum_charge desc")
    if narrowed_sums(ctx, sql) != ["sum_charge"]:
        raise AssertionError("SF100 Q1 over 'F': sum_charge not narrowed")
    before = read_counts()
    t0 = time.perf_counter()
    batch, schema = ctx.sql(sql).collect()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    got = to_numpy(batch, schema)
    del batch
    dt = schema.field("sum_charge").dtype
    if repr(dt) != "decimal(18,6)":
        raise AssertionError(f"SF100 Q1 over 'F': sum_charge is {dt!r}")
    log(f"phase 18 (c): Q1 over l_linestatus = 'F' by sum_charge desc: "
        f"sum_charge narrowed to {dt!r}; {took:.3f} s; "
        f"{len(got['l_returnflag'][0])} rows, largest "
        f"{max(int(v) for v in got['sum_charge'][0])}")
    t0 = time.perf_counter()
    try:
        ctx.sql(sf100_q1_sql("", "sum_charge")).collect()
    except NotImplementedError as e:
        if "sum_charge" not in str(e) or "wide decimal" not in str(e):
            raise AssertionError(f"SF100 Q1 by sum_charge: {e}") from e
        log(f"phase 18 (c): Q1 by sum_charge raised as it must in "
            f"{time.perf_counter() - t0:.3f} s: {e}")
    else:
        raise AssertionError("SF100 Q1 by sum_charge answered: N|O passes "
                             "int64 and must raise")
    if li.read_bytes != read:
        raise AssertionError(f"the reads decoded {li.read_bytes - read} B "
                             "of part files again")
    return read_counts() - before, got, schema


def phase_sf100():
    """Phase 18. Returns (kernel launches of (c) and (e), the held numbers
    of (d))."""
    import shutil
    import tempfile
    from ballista_tpu_torch.benchmarks import sf100 as sweep
    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ballista_sf100_")
    launches = np.zeros(2, dtype=np.int64)
    try:
        _host_state(18, root)
        sf100_datagen(18, SF100, root, tables=["lineitem"])
        ctx = _dataset_ctx(root)
        li = ctx.tables["lineitem"]
        log(f"phase 18 (c): lineitem {li.num_rows} rows in "
            f"{len(li.files)} part files")
        q1, schema1, call, more, route = sf100_collect(ctx, 1, True)
        launches += more
        if call is None:
            raise AssertionError("SF100 Q1 made no kernel call at T = 12")
        wide = schema1.field("sum_charge").dtype
        if not wide.is_wide:
            raise AssertionError(f"SF100 Q1's sum_charge is {wide!r}, not "
                                 "a wide decimal")
        held = hold_sf100_call(*call)
        del call
        sf100_warm(ctx, 1)
        more, q1f, schema1f = sf100_reads(ctx)
        launches += more
        q6, schema6, _, more, _ = sf100_collect(ctx, 6, False)
        launches += more
        sf100_warm(ctx, 6)
        ctx.evict_device()
        _fresh()

        t0 = time.perf_counter()
        sctx = _dataset_ctx(root, serial_partitions=SF100_SERIAL_P)
        before = read_counts()
        batch, schema = sctx.sql(TPCH_QUERIES[1]).collect()
        torch.cuda.synchronize()
        launches += read_counts() - before
        m = sctx.serial_metrics
        _same_numpy("SF100 Q1 serial vs in-core", to_numpy(batch, schema), q1)
        log(f"phase 18 (e): Q1 on serial_partitions={SF100_SERIAL_P} in "
            f"{time.perf_counter() - t0:.2f} s, equal to (c) exactly; "
            f"{len(m)} stages, {sum(x.partitions for x in m)} partition runs,"
            f" {sum(x.bytes_to_device for x in m)} B up, "
            f"{sum(x.bytes_to_host for x in m)} B down, parquet read "
            f"{sctx.tables['lineitem'].read_bytes} B; peak allocated "
            f"{_peaks()[0] / GIB:.2f} GiB")
        del batch, sctx

        t0 = time.perf_counter()
        ref = sweep.numpy_q1(root)
        _same_as_reference("SF100 Q1", q1, schema1, ref)
        _same_as_reference("SF100 Q6", q6, schema6, sweep.numpy_q6(root))
        ref_status, ref_charge = (ref.column(c).to_pylist()
                                  for c in ("l_linestatus", "sum_charge"))
        over_f = [i for i, v in enumerate(ref_status) if v == "F"]
        _same_as_reference("SF100 Q1 over 'F' by sum_charge desc", q1f,
                           schema1f, ref.take(sorted(
                               over_f, key=lambda i: -ref_charge[i])))
        charge = dict(zip(zip(q1["l_returnflag"][0], q1["l_linestatus"][0]),
                          q1["sum_charge"][0]))[("N", "O")]
        if charge <= 0:
            raise AssertionError(f"N|O sum_charge {charge} is not positive")
        log(f"phase 18 (f): Q1, Q6 and (c)'s Q1 over 'F' equal the "
            f"streaming numpy reference exactly "
            f"({time.perf_counter() - t0:.1f} s); N|O sum_charge "
            f"{charge / 10 ** wide.scale:.6f} ({wide!r}; past 2^63 scaled: "
            f"{charge > 2 ** 63 - 1}); route of Q1 in (c): {route}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 18: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"{launches.tolist()}")
    return launches, held


def phase_sf100_sweep(queries):
    """--sf100-only: SF10 and SF100, every table, chunked; the queries
    through `benchmarks/sf100.py` (SF10 each in-core and serial, saved;
    SF100 each in its own process, held to the invariants). Returns
    whether every query answered and passed."""
    import shutil
    import tempfile
    from ballista_tpu_torch.benchmarks import sf100 as sweep
    root = tempfile.mkdtemp(prefix="ballista_sweep_")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "sf100")
    try:
        _host_state(18, root)
        for sf, name in ((10, "sf10"), (SF100, "sf100")):
            sf100_datagen(18, sf, os.path.join(root, name))
        ten = sweep.sf10_pass(os.path.join(root, "sf10"), out, queries,
                              timeout=SF100_LIMIT_S, log=log)
        hundred = sweep.sf100_pass(os.path.join(root, "sf100"), out, queries,
                                   timeout=SF100_LIMIT_S, log=log)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(out, "sweep.json"), "w") as f:
        json.dump({"sf10": ten, "sf100": hundred}, f, indent=1, default=str)
    bad = [f"sf10 q{q}" for q, r in ten.items() if not r.get("verified")] + [
        f"sf100 q{q}" for q, r in hundred.items()
        if "error" in r or r.get("verified") is False]
    log(f"phase 18: sweep over {queries}: failed {bad or 'none'}")
    return not bad



# ---------------------------------------------------------------------------
# Phase 19: wide SUMs read as values at SF1
# ---------------------------------------------------------------------------

# Q1 with the NULL-safe sum_charge, sorted by it: its bound (coalesce's
# hull) keeps it narrow at SF1
P19_CHARGE = ("sum(coalesce(l_extendedprice * (1 - l_discount) * (1 + l_tax),"
              " 0)) as sum_charge")
P19_HAVING = ("select l_returnflag, l_linestatus, sum(abs(l_quantity)) as q "
              "from lineitem group by l_returnflag, l_linestatus "
              "having sum(abs(l_quantity)) > 1000000 "
              "order by l_returnflag, l_linestatus")
# the roll-up's sum over 6e6 rows of sums is wide by its bound: narrowed
P19_ROLLUP = ("with g as (select l_returnflag, l_linestatus, "
              "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price "
              "from lineitem where l_shipdate <= date '1998-09-02' "
              "group by l_returnflag, l_linestatus) "
              "select l_returnflag, sum(sum_disc_price) as total from g "
              "group by l_returnflag order by total")
# a many-to-many join: 8e5 x 6e6 rows times the price bound pass int64
P19_JOIN = ("select l_returnflag, sum(l_extendedprice) as s from partsupp "
            "join lineitem on ps_partkey = l_partkey group by l_returnflag "
            "order by s")


def p19_q1_sql():
    sql = TPCH_QUERIES[1].replace(
        "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge",
        P19_CHARGE)
    return sql[:sql.index("order by")] + "order by\n    sum_charge desc\n"


def narrowed_sums(ctx, sql):
    """The names of the SUMs that the in-core plan of `sql` narrows."""
    root = ctx.physical_plan(rebind_scans(ctx.sql(sql).plan, ctx))
    out, todo = [], [root]
    while todo:
        node = todo.pop()
        if isinstance(node, plan_mod.HashAggregateExec):
            out += [shown for _, shown in node._narrow]
        todo.extend(node.children)
    return out


def p19_run(ctx, label, sql, route, calls=None):
    """First run (its launches and kernel calls) and warm median of 3;
    the answer as host columns."""
    before = read_counts()
    with spy_rows() as seen:
        t0 = time.perf_counter()
        batch, schema = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    launches = read_counts() - before
    if calls is not None:
        calls += seen
    del seen
    got = to_numpy(batch, schema)
    del batch
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        ctx.sql(sql).collect()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(f"phase 19: {label} route {route}: first run {first:.4f} s, warm "
        f"median {statistics.median(warm) * 1e3:.3f} ms, kernel launches "
        f"{launches.tolist()}; types "
        f"{[repr(f.dtype) for f in schema.fields]}")
    return got, schema, launches


def p19_expected_q1(root):
    """answers/sf1's Q1 rows ordered by sum_charge, descending, in a copy
    of the answers directory under `root`: (the copy, the keys in order)."""
    with open(os.path.join(ANSWER_DIR, "q1.out")) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    at = lines[0].split("|").index("sum_charge")
    rows = sorted(lines[1:], key=lambda r: -float(r.split("|")[at]))
    os.makedirs(os.path.join(root, "answers"), exist_ok=True)
    with open(os.path.join(root, "answers", "q1.out"), "w") as f:
        f.write("\n".join([lines[0]] + rows) + "\n")
    return root, [tuple(r.split("|")[:2]) for r in rows]


def p19_q1(sf1_ctx, expected, keys, calls):
    """(a): in-core, on serial_partitions=8 and over P = 8 partitions of
    the card, each answer answers/sf1's rows in sum_charge's order."""
    sql = p19_q1_sql()
    sctx = SessionContext(device="cuda", serial_partitions=SERIAL_P)
    dctx = _dist_ctx(sf1_ctx, make_mesh(
        DIST_P, devices=[torch.device("cuda", 0)] * DIST_P))
    for name, tp in sf1_ctx.tables.items():
        if name in TPCH_TABLES:
            sctx.register_host(name, tp.fields, tp.host,
                               primary_key=TPCH_TABLES[name][1])
    launches = np.zeros(2, dtype=np.int64)
    for ctx, route in ((sf1_ctx, "in-core"),
                       (sctx, f"serial@{SERIAL_P}"),
                       (dctx, f"P = {DIST_P}")):
        got, schema, more = p19_run(
            ctx, "(a) Q1 by sum(coalesce(...)) desc", sql, route,
            calls if ctx is sf1_ctx else None)
        launches += more
        notes = []
        bad = diff_expected((got, schema), expected, 1, notes)
        order = list(zip(got["l_returnflag"][0], got["l_linestatus"][0]))
        if bad or order != keys:
            raise AssertionError(f"phase 19 (a) {route}: {bad or order}")
        log(f"phase 19 (a): {route}: the 4 rows equal answers/sf1's Q1 in "
            f"sum_charge's order {order}")
        ctx.evict_device()
    return launches


def p19_numpy(ctx):
    """(b)-(d)'s answers over the host columns, as {key: scaled int}."""
    flag = _host(ctx, "lineitem", "l_returnflag")
    status = _host(ctx, "lineitem", "l_linestatus")
    qty = ctx.tables["lineitem"].host["l_quantity"].values
    price = ctx.tables["lineitem"].host["l_extendedprice"].values
    disc = ctx.tables["lineitem"].host["l_discount"].values
    ship = ctx.tables["lineitem"].host["l_shipdate"].values
    part = ctx.tables["lineitem"].host["l_partkey"].values
    ps_part = ctx.tables["partsupp"].host["ps_partkey"].values
    having, rollup, join = {}, {}, {}
    copies = np.bincount(ps_part, minlength=int(part.max()) + 1)[part]
    live = ship <= parse_date("1998-09-02")
    for f in np.unique(flag):
        fm = flag == f
        join[(f,)] = int((price[fm] * copies[fm]).sum())
        rollup[(f,)] = sum(int((price[m] * (100 - disc[m])).sum())
                           for s in np.unique(status)
                           for m in [fm & (status == s) & live] if m.any())
        for s in np.unique(status):
            m = fm & (status == s)
            q = int(np.abs(qty[m]).sum())
            if m.any() and q > 1000000 * 100:
                having[(f, s)] = q
    return having, rollup, join


def p19_check(label, got, keys, name, want, order_by_value):
    rows = list(zip(*(got[k][0] for k in keys)))
    values = [int(v) for v in got[name][0]]
    if not got[name][1].all() or dict(zip(rows, values)) != want \
            or len(rows) != len(want):
        raise AssertionError(f"phase 19 {label}: {dict(zip(rows, values))} "
                             f"!= numpy {want}")
    if not want:
        raise AssertionError(f"phase 19 {label}: numpy keeps no row")
    ordered = values == sorted(values) if order_by_value else \
        rows == sorted(rows)
    if not ordered:
        raise AssertionError(f"phase 19 {label}: rows out of order: {rows}")
    log(f"phase 19 {label}: equal to numpy exactly: "
        f"{dict(zip(rows, values))}")


def phase_wide_reads(sf1_ctx):
    """Phase 19. Returns (kernel launches of its first runs, max |kernel
    - plain| on the calls it holds, the held numbers of its largest
    call)."""
    import shutil
    import tempfile
    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ballista_p19_")
    calls = []
    try:
        expected, keys = p19_expected_q1(root)
        launches = p19_q1(sf1_ctx, expected, keys, calls)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    having, rollup, join = p19_numpy(sf1_ctx)
    for label, sql, kcols, name, want, by_value, narrowed in (
            ("(b) HAVING sum(abs(l_quantity))", P19_HAVING,
             ("l_returnflag", "l_linestatus"), "q", having, False, []),
            ("(c) a CTE's roll-up of sum_disc_price", P19_ROLLUP,
             ("l_returnflag",), "total", rollup, True, ["total"]),
            ("(d) partsupp x lineitem on ps_partkey alone", P19_JOIN,
             ("l_returnflag",), "s", join, True, ["s"])):
        if narrowed_sums(sf1_ctx, sql) != narrowed:
            raise AssertionError(f"phase 19 {label}: narrowed "
                                 f"{narrowed_sums(sf1_ctx, sql)}, not "
                                 f"{narrowed}")
        got, _, more = p19_run(sf1_ctx, label, sql, "in-core", calls)
        launches += more
        p19_check(label, got, kcols, name, want, by_value)
        log(f"phase 19 {label}: narrowed {narrowed or 'nothing'} (the "
            "bounds keep the rest narrow)")
    sf1_ctx.evict_device()
    # each distinct call shape once, the latest (after any overflow retry)
    shapes = {}
    for slot, rows, T in calls:
        shapes[(T, len(rows), slot.shape[0])] = (slot, rows, T)
    del calls
    err, largest = 0, None
    for (T, A, n), call in sorted(shapes.items(), key=lambda kv: kv[0][2]):
        wide = sum(1 for row in call[1] if len(row) > 2 and row[2])
        largest = hold_call(19, f"a call of phase 19 ({wide} half-word "
                            "rows)", *call)
        err = max(err, held_err(largest))
    del shapes
    log(f"phase 19: {time.perf_counter() - t_start:.1f} s; kernel launches "
        f"{launches.tolist()}")
    return launches, err, largest


def phase_wide_reads_alone():
    """Phase 19 without the earlier phases: SF1 made here."""
    t0 = time.perf_counter()
    ctx = SessionContext(device="cuda")
    for name, (fields, cols) in generate_tpch(SF, SEED).items():
        ctx.register_host(name, fields, cols, primary_key=TPCH_TABLES[name][1])
    log(f"phase 19: TPC-H SF1 generated in {time.perf_counter() - t0:.1f} s")
    launches, err, held = phase_wide_reads(ctx)
    held["masked_slot_sums_rows"]["max_abs_err"] = err
    return launches, held


def main():
    t_script = time.perf_counter()
    if sys.argv[1:2] == ["--mp-worker"]:
        pid, nproc, port, scenario, out_dir = sys.argv[2:7]
        mp_worker(int(pid), int(nproc), port, scenario, out_dir)
        return
    alone = sys.argv[1:] in (["--distributed-only"], ["--wire-only"],
                             ["--raw-only"], ["--tools-only"],
                             ["--rest-only"], ["--wide-only"])
    sweep = sys.argv[1:2] == ["--sf100-only"] and (
        len(sys.argv) == 2 or (len(sys.argv) == 4
                               and sys.argv[2] == "--queries"))
    if sys.argv[1:] and not (alone or sweep):
        print("usage: python3 chip_smoke.py [--distributed-only | "
              "--wire-only | --raw-only | --tools-only | --rest-only | "
              "--wide-only | --sf100-only [--queries 1,6,...]]",
              file=sys.stderr)
        sys.exit(2)
    log(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)

    # nvcc for the kernel and g++ for the native encoder, started together
    from ballista_tpu_torch import native
    built = {}

    def build_native():
        try:
            built["native"] = native.build()
        except Exception as e:  # noqa: BLE001 - raised below, in order
            built["error"] = e

    t0 = time.perf_counter()
    encoder = threading.Thread(target=build_native)
    encoder.start()
    lib = masked_sums.build()
    log(f"phase 2: built {os.path.relpath(lib)} in "
        f"{time.perf_counter() - t0:.2f} s")
    encoder.join()
    if "error" in built:
        raise built["error"]
    NATIVE_BUILD_S[0] = native.build.seconds
    log(f"phase 2: built {os.path.relpath(built['native'])} with g++ in "
        f"{NATIVE_BUILD_S[0]:.2f} s (0: it was there), beside nvcc")
    # ptxas -v: registers and spills of every kernel instance
    entry = None
    for line in masked_sums.build.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line or "Used" in line:
            log(f"phase 2: ptxas {entry}: "
                f"{line.replace('ptxas info    :', '').strip()}")
    log(f"phase 2: {masked_sums.smem_bytes('cuda')} B of shared memory per "
        f"block on request; a_chunk(26) = {masked_sums.a_chunk(26, 'cuda')}")

    if sweep:
        queries = ([int(q) for q in sys.argv[3].split(",")]
                   if len(sys.argv) == 4 else list(range(1, 23)))
        ok = phase_sf100_sweep(queries)
        log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
        if not ok:
            sys.exit(1)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if alone:
        if sys.argv[1] == "--distributed-only":
            launches, err = phase_distributed_alone()
            held = LAST_HELD
        elif sys.argv[1] == "--wire-only":
            launches, held = phase_wire_alone()
            err = held_err(held)
        elif sys.argv[1] == "--tools-only":
            launches, held = phase_tools_alone()
            err = held_err(held)
        elif sys.argv[1] == "--rest-only":
            launches, held, mp_held = phase_last(write_files=True)
            err = max(held_err(held), held_err(mp_held))
        elif sys.argv[1] == "--wide-only":
            launches, held = phase_wide_reads_alone()
            err = held_err(held)
        else:
            launches, held = phase_raw_alone()
            err = held_err(held)
        print(json.dumps({"kernels": [{
            "name": "masked_slot_sums", "route": "cuda",
            "source": "ballista_tpu_torch/csrc/masked_slot_sums.cu",
            "replaces": "ballista_tpu/ops/pallas_agg.py:106",
            "launches": int(launches.sum()),
            **held["masked_slot_sums_rows"], "max_abs_err": err}]}))
        log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    max_err = phase_kernel()
    launches, q1_call = phase_q1()
    q1_held = phase_q1_inputs(*q1_call)
    del q1_call     # its tensors would count in phase 12's peaks
    join_launches, q5_held, ctx = phase_joins()
    rest_launches, rest_err = phase_rest(ctx)
    part_launches, part_err = phase_rest_part(ctx)
    phase_setops(ctx)
    analytic_launches, analytic_err = phase_analytic(ctx)
    client_launches, client_err = phase_client(ctx)
    sf10_launches, sf10_err = phase_sf10(ctx)
    dist_launches, dist_err = phase_distributed(ctx)
    wire_launches, wire_held_numbers = phase_wire(ctx)
    raw_launches, raw_held = phase_raw(ctx)
    wide_launches, wide_err, _ = phase_wide_reads(ctx)
    ctx.evict_device()
    tools_launches, tools_held = phase_tools(
        {name: (tp.fields, tp.host) for name, tp in ctx.tables.items()
         if name in TPCH_TABLES}, keep_files=True)
    last_launches, last_held, mp_held = phase_last(write_files=False)
    sf100_launches, sf100_held = phase_sf100()

    # one record for the kernel file; its times and bound are those of
    # Q1's own call through the entry the queries use. `entry_points`
    # gives each wrapper's own numbers on that call; launches are those of
    # the 22 queries', the analytic slice's and the client slice's first
    # runs, counted per wrapper, those the executor processes of phases
    # 14, 15 and 16 reported, and phase 16's runner, load test, scaling,
    # Avro and plugin runs, and phase 17's, its worker processes' included.
    launches = (launches + join_launches + rest_launches + part_launches
                + analytic_launches + client_launches + sf10_launches
                + dist_launches + wire_launches + raw_launches
                + tools_launches + last_launches + sf100_launches
                + wide_launches)
    worst = max(max_err, held_err(q1_held), held_err(q5_held), rest_err,
                part_err, analytic_err, client_err, sf10_err, dist_err,
                held_err(wire_held_numbers), held_err(raw_held),
                held_err(tools_held), held_err(last_held),
                held_err(mp_held), sf100_held["max_abs_err"], wide_err)
    entries = [dict(name=name, launches=int(count), **q1_held[name])
               for name, count in zip(("masked_slot_sums_rows",
                                       "masked_slot_sums"), launches)]
    print(json.dumps({"kernels": [{
        "name": "masked_slot_sums", "route": "cuda",
        "source": "ballista_tpu_torch/csrc/masked_slot_sums.cu",
        "replaces": "ballista_tpu/ops/pallas_agg.py:106",
        "launches": int(launches.sum()),
        **q1_held["masked_slot_sums_rows"], "max_abs_err": worst,
        "entry_points": entries}]}))
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
