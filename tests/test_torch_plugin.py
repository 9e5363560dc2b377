"""UDF plugins (`ballista_tpu_torch/plugin.py`, `SessionContext.
load_plugins`, `set_config`, `cli --plugin-dir`) and `file_metadata`
(`client/context.py`) against the JAX package's: the same plugin source
loads in both packages and its UDF's answers are equal; a mismatched API
version and a missing `register` raise PluginError; the dict
`file_metadata` gives for parquet, csv and json files equals the JAX
package's (the cases of tests/test_parity_extras.py)."""

import contextlib
import io
import textwrap

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.client.context import file_metadata as jax_file_metadata
from ballista_tpu_torch import cli
from ballista_tpu_torch import exprs
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import file_metadata
from ballista_tpu_torch.config import BALLISTA_PLUGIN_DIR, BallistaConfig
from ballista_tpu_torch.plugin import PLUGIN_API_VERSION, PluginError

torch.set_num_threads(2)

# one source for both packages: the output type comes from the package of
# the context the plugin is given
PLUGIN = textwrap.dedent("""
    import importlib

    BALLISTA_PLUGIN_API = 1

    def register(ctx):
        package = type(ctx).__module__.split(".")[0]
        S = importlib.import_module(package + ".schema")
        ctx.register_udf("{name}", lambda x: x * 3 + 1, S.INT64)
""")


def _plugin_dir(tmp_path, name, file="tripler"):
    d = tmp_path / "plugins"
    d.mkdir(exist_ok=True)
    (d / f"{file}.py").write_text(PLUGIN.format(name=name))
    return str(d)


def test_same_plugin_loads_in_both_packages(tmp_path):
    d = _plugin_dir(tmp_path, "plugin_triple")
    jctx, tctx = JaxContext(), SessionContext(device="cpu")
    assert jctx.load_plugins(d) == tctx.load_plugins(d) == ["tripler"]
    x = np.array([5, -2, 7, 0, 11], dtype=np.int64)
    jctx.register_arrow("t", pa.table({"x": x}))
    tctx.register_numpy("t", {"x": x})
    sql = ("select x, plugin_triple(x) as y from t where plugin_triple(x) "
           "> 0 order by y")
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert got.values.tolist() == want.values.tolist() == \
        [[0, 1], [5, 16], [7, 22], [11, 34]]


def test_api_version_gate(tmp_path):
    (tmp_path / "old.py").write_text(
        "BALLISTA_PLUGIN_API = 0\ndef register(ctx): pass\n")
    with pytest.raises(PluginError, match=f"requires {PLUGIN_API_VERSION}"):
        SessionContext(device="cpu").load_plugins(str(tmp_path))


def test_missing_register(tmp_path):
    (tmp_path / "bare.py").write_text("BALLISTA_PLUGIN_API = 1\n")
    with pytest.raises(PluginError, match="no register"):
        SessionContext(device="cpu").load_plugins(str(tmp_path))


def test_missing_dir_and_no_dir():
    ctx = SessionContext(device="cpu")
    assert ctx.load_plugins("") == []
    with pytest.raises(PluginError, match="does not exist"):
        ctx.load_plugins("/no/such/plugin/dir")


def test_set_config_loads_the_plugin_dir(tmp_path):
    d = _plugin_dir(tmp_path, "cfg_triple")
    ctx = SessionContext(device="cpu")
    cfg = BallistaConfig({BALLISTA_PLUGIN_DIR: d})
    ctx.set_config(cfg)
    assert ctx.config is cfg and "cfg_triple" in exprs._UDF_REGISTRY


def test_cli_plugin_dir(tmp_path):
    d = _plugin_dir(tmp_path, "cli_triple")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(["--sf", "0.001", "--plugin-dir", d, "--format", "csv",
                  "-c", "select cli_triple(n_nationkey) as y from nation "
                        "where n_nationkey < 3 order by y"], device="cpu")
    assert "loaded plugins: tripler" in err.getvalue()
    assert [line for line in out.getvalue().splitlines()
            if line.strip()][:4] == ["y", "1", "4", "7"]


def _write(kind, path):
    t = pa.table({"a": [1, 2, 3], "b": ["x", None, "z"],
                  "c": [1.5, 2.5, None]})
    if kind == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(t, path)
    elif kind == "csv":
        with open(path, "w") as fh:
            fh.write("a,b,c\n1,x,1.5\n2,,2.5\n3,z,\n")
    else:
        with open(path, "w") as fh:
            fh.write('{"a": 1, "b": "x", "c": 1.5}\n{"a": 2, "c": 2.5}\n'
                     '{"a": 3, "b": "z"}\n')


@pytest.mark.parametrize("kind", ["parquet", "csv", "json"])
def test_file_metadata_equals_jax(tmp_path, kind):
    path = str(tmp_path / f"t.{kind}")
    _write(kind, path)
    meta = file_metadata(path)
    assert meta == jax_file_metadata(path)
    assert meta["num_rows"] == 3
    assert [f["name"] for f in meta["fields"]] == ["a", "b", "c"]


def test_file_metadata_unsupported():
    with pytest.raises(ValueError, match="unsupported file type"):
        file_metadata("whatever.xlsx")
