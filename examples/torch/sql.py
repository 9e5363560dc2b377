"""SQL example on the PyTorch/CUDA port (twin of examples/sql.py;
reference: examples/src/bin/sql.rs:23-50).

Registers a CSV as an external table and runs SQL against the engine.
`main` prints the result as a table and returns its rows (one dict per
row). CSV reading uses pyarrow.
Run:  PYTHONPATH=. python examples/torch/sql.py [--device cuda|cpu]
"""

import argparse
import json
import os
import tempfile

from ballista_tpu_torch.cli import format_rows
from ballista_tpu_torch.client import SessionContext


def main(device="cuda"):
    ctx = SessionContext(device=device)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "test.csv")
        with open(path, "w") as f:
            f.write("c1,c2,c3\n")
            for i in range(10):
                f.write(f"{i},{i * 2},{i * i}\n")

        ctx.sql(
            f"CREATE EXTERNAL TABLE test STORED AS CSV WITH HEADER ROW "
            f"LOCATION '{path}'; SELECT 1 as ok")
        batch, schema = ctx.sql(
            "SELECT c1, MIN(c3) as min_c3, MAX(c3) as max_c3 FROM test "
            "WHERE c2 >= 4 GROUP BY c1 ORDER BY c1 LIMIT 5").collect()
    print(format_rows(batch, schema), end="")
    return [json.loads(line) for line in
            format_rows(batch, schema, "json").splitlines()]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
