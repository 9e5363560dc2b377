"""Dataset generation / conversion CLI (`convert-tpch`, tpch.rs:731
parity; port of ballista_tpu/datagen/__main__.py): writes the
deterministic TPC-H tables as dbgen `.tbl` ('|'-delimited, for diffing
against dbgen output), csv or parquet.

  python -m ballista_tpu_torch.datagen --sf 1 --format tbl --out DIR

  python -m ballista_tpu_torch.datagen --sf 10 --chunks 16 --workers 4 \
      --out DIR     # DIR/<table>/part_*.parquet

`.tbl` is written from the generator's host columns with numpy alone
(`tbl.write_tbl`), byte for byte the file the JAX package's CLI writes;
csv and parquet go through pyarrow, imported where it is used. `--chunks
N` streams each table as N independently generated parquet part files
with bounded RAM (`tpch.generate_tpch_parquet`; register the directory
with `SessionContext.register_parquet_dataset`), `--workers K` builds them
in K processes, with the same bytes for any K.
"""

import argparse
import os
import sys
import time

from ..batch import columns_to_arrow, host_to_numpy
from .tbl import write_tbl
from .tpch import TPCH_TABLES, generate_tpch, generate_tpch_parquet


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Generate/convert TPC-H data (tpch.rs convert-tpch)")
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--out", default="tpch")
    ap.add_argument("--format", choices=("parquet", "csv", "tbl"),
                    default="parquet")
    ap.add_argument("--tables", default=None,
                    help="comma-separated subset (default: all 8)")
    ap.add_argument("--chunks", type=int, default=0,
                    help="stream each table as N independently generated "
                         "parquet part files with bounded RAM (dbgen -C/-S "
                         "chunking)")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel chunk-builder processes (chunks draw "
                         "from independent streams: the same bytes)")
    args = ap.parse_args(argv)

    names = args.tables.split(",") if args.tables else list(TPCH_TABLES)
    if args.chunks:
        if args.format != "parquet":
            raise ValueError("--chunks writes parquet part files")
        t0 = time.perf_counter()
        counts = generate_tpch_parquet(args.sf, args.out, args.chunks,
                                       tables=names, workers=args.workers)
        for name, rows in counts.items():
            print(f"{name}: {rows} rows -> {args.out}/{name}/part_*.parquet")
        print(f"# written in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        return
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    data = generate_tpch(args.sf, tables=names)
    print(f"# generated in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    for name in names:
        fields, cols = data[name]
        path = os.path.join(args.out, f"{name}.{args.format}")
        t0 = time.perf_counter()
        if args.format == "tbl":
            write_tbl(path, fields, cols)
        elif args.format == "parquet":
            import pyarrow.parquet as pq
            pq.write_table(columns_to_arrow(fields, host_to_numpy(fields,
                                                                  cols)), path)
        else:
            import pyarrow.csv as pacsv
            pacsv.write_csv(columns_to_arrow(fields, host_to_numpy(fields,
                                                                   cols)), path)
        n = len(cols[fields[0].name].values)
        print(f"{name}: {n} rows -> {path} ({os.path.getsize(path)} bytes, "
              f"{time.perf_counter() - t0:.3f} s)")


if __name__ == "__main__":
    main()
