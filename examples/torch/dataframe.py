"""DataFrame API example on the PyTorch/CUDA port (twin of
examples/dataframe.py; reference: examples/src/bin/dataframe.rs).

Builds a query with the DataFrame API instead of SQL over a table
registered from Python lists (`register_numpy`: no pyarrow, no pandas).
`main` prints the result as a table and returns its rows (one dict per
row).
Run:  PYTHONPATH=. python examples/torch/dataframe.py [--device cuda|cpu]
"""

import argparse
import json

from ballista_tpu_torch.cli import format_rows
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.dataframe import col, lit
from ballista_tpu_torch.exec.aggregate import AggExpr


def main(device="cuda"):
    ctx = SessionContext(device=device)
    ctx.register_numpy("t", {
        "a": [1, 2, 3, 4, 5],
        "b": [10.0, 20.0, 5.0, 40.0, 2.5],
        "tag": ["x", "y", "x", "y", "x"],
    })

    df = (ctx.table("t")
          .filter(col("b") > lit(4.0))
          .aggregate([col("tag")],
                     [AggExpr("sum", col("a"), "sum_a"),
                      AggExpr("count_star", alias="n")])
          .sort(col("tag")))
    batch, schema = df.collect()
    print(format_rows(batch, schema), end="")
    return [json.loads(line) for line in
            format_rows(batch, schema, "json").splitlines()]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
