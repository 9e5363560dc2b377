"""Dataset generation / conversion CLI (`convert-tpch`, tpch.rs:731
parity; port of ballista_tpu/datagen/__main__.py): writes the
deterministic TPC-H tables as dbgen `.tbl` ('|'-delimited, for diffing
against dbgen output), csv or parquet.

  python -m ballista_tpu_torch.datagen --sf 1 --format tbl --out DIR

`.tbl` is written from the generator's host columns with numpy alone
(`tbl.write_tbl`), byte for byte the file the JAX package's CLI writes;
csv and parquet go through pyarrow, imported where it is used. The
chunked parquet datagen (`--chunks`, the JAX package's
`generate_tpch_parquet`) is not ported yet.
"""

import argparse
import os
import sys
import time

from ..batch import columns_to_arrow, host_to_numpy
from .tbl import write_tbl
from .tpch import TPCH_TABLES, generate_tpch


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
                    help="stream each table as N parquet part files "
                         "(not ported)")
    ap.add_argument("--workers", type=int, default=1,
                    help="parallel chunk-builder processes (with --chunks; "
                         "not ported)")
    args = ap.parse_args(argv)
    if args.chunks or args.workers != 1:
        raise NotImplementedError(
            "--chunks / --workers: the chunked parquet datagen "
            "(generate_tpch_parquet) is not ported yet")

    names = args.tables.split(",") if args.tables else list(TPCH_TABLES)
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
