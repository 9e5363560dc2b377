"""Times the masked per-slot sum kernel on the card, as built from the
source and from variants of it with some of its constants replaced:

    python -m ballista_tpu_torch.benchmarks.kernel_probe \
        --variant REGISTER_T=16 --variant UNROLL=2 --variant TILE=4096,UNROLL=8

Every variant (and the source as it is, first) is built, held against the
plain PyTorch version on a dense and a sparse call, and timed at
n = 5,998,336 rows (lineitem's capacity at SF1): an 11-row matrix and
Q1-shaped described rows (count(*), five int64 sums over five validity
columns and their five counts) at each T of --slots on uniform slots, and
3-row calls with 2 %, 0.002 % and (T = 26) 0.125 % of the rows live. Each
line gives the time of calls made back to back, the time of their device
work alone (the calls queued behind a spinning kernel), and the host time
of one call. A variant is a comma-separated list of NAME=VALUE over the
`constexpr int NAME = VALUE;` lines of csrc/masked_slot_sums.cu; the
variant sources are written beside the built libraries and nothing in the
package changes. `--source PATH` (repeatable) times another source file
after them, in the order given: to hold a change against its parent on one
card, unpack the parent's source (`git show
PARENT:ballista_tpu_torch/csrc/masked_slot_sums.cu > build/parent.cu`) and
pass `--source build/parent.cu --source
ballista_tpu_torch/csrc/masked_slot_sums.cu --source build/parent.cu`
(change, parent, change, parent). A source with
the half-word read mode is also timed on Q1's rows with the fifth sum read
as HI and LO (a wide sum, twelve rows). `--n` sets the rows. `--library`
also times `index_add_`, the one PyTorch call that computes the same sums,
on each call's contribution matrix (once, before the sources: it does not
depend on them), and adds calls at Q1's shape whose rows lie in 3 of the
12 slots and sparse calls of 5 rows at T = 8.
"""

from __future__ import annotations

import argparse
import re
import subprocess
from pathlib import Path

import torch

from ..ops import masked_sums as m
from .timing import cuda_ms, host_ms, library_ms

N = 5_998_336


def _build(source_text, name):
    """Write a source text beside the built libraries, build it and make
    it the library the wrappers launch; returns ptxas's register lines."""
    path = m.BUILD_DIR / f"probe_{name}.cu"
    m.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(source_text)
    m.load(path)
    return [line.split(":", 1)[1].strip()
            for line in m.build.log.splitlines() if "Used" in line]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE...] over the source's "
                         "constexpr ints")
    ap.add_argument("--slots", type=int, nargs="+",
                    default=[1, 2, 4, 6, 8, 12, 16, 26])
    ap.add_argument("--source", action="append", default=[],
                    help="another kernel source file to time, in order")
    ap.add_argument("--n", type=int, default=N, help="rows per call")
    ap.add_argument("--library", action="store_true",
                    help="also time index_add_ on every call's inputs")
    args = ap.parse_args()
    n = args.n
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    source = m.SOURCE.read_text()

    g = torch.Generator().manual_seed(1)
    contribs = torch.randint(-2 ** 40, 2 ** 40, (11, n), generator=g,
                             dtype=torch.int64).cuda()
    uniform = torch.randint(0, 2 ** 20, (n,), generator=g,
                            dtype=torch.int32).cuda()
    valid = [torch.ones(n, dtype=torch.bool).cuda() for _ in range(5)]
    rows = [(None, None)] + [(None, v) for v in valid] \
        + [(contribs[i], v) for i, v in enumerate(valid)]
    halves = rows[:-1] + [(contribs[4], valid[4], m.HI),
                          (contribs[4], valid[4], m.LO)]
    pick = torch.rand(n, generator=g).cuda()
    sparse = {"T=1, 2 % live": (torch.where(pick < 0.02, 0, 1), 1),
              "T=1, 0.002 % live": (torch.where(pick < 0.00002, 0, 1), 1),
              "T=26, 0.125 % live": (torch.where(pick < 0.00125, 3, 26), 26)}
    three = contribs[:3]
    if args.library:
        _library(n, args.slots, uniform, rows, halves, contribs, pick, sparse)

    runs = [("", source)] + [(spec, None) for spec in args.variant] + [
        (path, Path(path).read_text()) for path in args.source]
    for k, (spec, text) in enumerate(runs):
        if text is None:
            text = source
            for pair in filter(None, spec.split(",")):
                name, value = pair.split("=")
                text, hits = re.subn(rf"(constexpr int {name} = )\d+;",
                                     rf"\g<1>{value};", text)
                if hits != 1:
                    raise SystemExit(f"no constexpr int {name} in the "
                                     "source")
        label = spec or "source"
        regs = _build(text, f"{k}_" + re.sub(r"\W", "_", label))
        print(f"{label}: ptxas {regs}", flush=True)

        def report(what, fn):
            print(f"  {label}: {what}: {cuda_ms(fn):.4f} ms back to back, "
                  f"{cuda_ms(fn, queued=True):.4f} ms of device work, "
                  f"{host_ms(fn):.4f} ms of host time per call", flush=True)

        for T in args.slots:
            slot = (uniform % T).to(torch.int32)
            if not torch.equal(m.masked_slot_sums_rows(slot, rows, T),
                               m.masked_slot_sums_rows_reference(slot, rows,
                                                                 T)):
                raise SystemExit(f"{label}: rows != plain at T={T}")
            report(f"matrix A=11 T={T} dense",
                   lambda: m.masked_slot_sums(slot, contribs, T))
            report(f"rows Q1-shaped T={T} dense",
                   lambda: m.masked_slot_sums_rows(slot, rows, T))
            if "half_of" in text:
                if not torch.equal(
                        m.masked_slot_sums_rows(slot, halves, T),
                        m.masked_slot_sums_rows_reference(slot, halves, T)):
                    raise SystemExit(f"{label}: half rows != plain at T={T}")
                report(f"rows Q1-shaped, a sum as HI and LO, T={T} dense",
                       lambda: m.masked_slot_sums_rows(slot, halves, T))
        for what, (slot, T) in sparse.items():
            slot = slot.to(torch.int32)
            if not torch.equal(m.masked_slot_sums(slot, three, T),
                               m.masked_slot_sums_reference(slot, three, T)):
                raise SystemExit(f"{label}: matrix != plain at {what}")
            report(f"matrix A=3 {what}",
                   lambda: m.masked_slot_sums(slot, three, T))
            report(f"rows A=3 {what}", lambda: m.masked_slot_sums_rows(
                slot, [(None, None), (None, valid[0]), (three[2], valid[0])],
                T))


def _library(n, slots, uniform, rows, halves, contribs, pick, sparse):
    """index_add_ on the calls the kernel is timed on, each held against
    the kernel's plain version first; plus calls at Q1's shape on 3 of 12
    slots and sparse 5-row calls at T = 8."""
    def report(what, slot, rows_, T):
        slot = slot.to(torch.int32)
        matrix = m.contribution_matrix(slot, rows_)
        if not torch.equal(m.masked_slot_sums_rows(slot, rows_, T),
                           m.masked_slot_sums_rows_reference(slot, rows_, T)):
            raise SystemExit(f"rows != plain at {what}")
        live = int(((slot >= 0) & (slot < T)).sum())
        print(f"  index_add_: {what} (n={n}, {live} live, T={T}, "
              f"A={matrix.shape[0]}): {library_ms(slot, matrix, T):.4f} ms",
              flush=True)

    skew = torch.where(uniform % 4 == 0, 9, uniform % 3)    # 3 of 12 slots
    for T in slots:
        report(f"rows Q1-shaped T={T} dense", uniform % T, rows, T)
        report(f"rows Q1-shaped, a sum as HI and LO, T={T} dense",
               uniform % T, halves, T)
    report("rows Q1-shaped T=12, 3 of 12 slots hold every row", skew, rows,
           12)
    five = [(None, None), (None, rows[1][1])] + [
        (contribs[i], rows[1][1]) for i in range(3)]
    for what, (slot, T) in sparse.items():
        report(f"rows A=3 {what}", slot, five[:2] + five[4:], T)
    for frac in (0.02, 0.00002):
        report(f"rows A=5 T=8, {frac * 100:g} % live",
               torch.where(pick < frac, (uniform % 8), 8), five, 8)


if __name__ == "__main__":
    main()
