"""The port's twins of the JAX package's examples (`examples/torch/`): each
twin's `main(device="cpu")` returns the rows the JAX example prints. The
JAX examples are loaded from their files and run as they are, with their
module's `print` captured."""

import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*path):
    name = "example_" + "_".join(p.replace(".py", "") for p in path)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_printed(name):
    """What the JAX example `examples/{name}.py` prints, object by object."""
    module = _load(f"{name}.py")
    printed = []
    module.print = printed.append
    module.main()
    return printed


def _same_rows(got, frame):
    want = frame.to_dict("records")
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for key, value in w.items():
            assert g[key] == (value.item() if hasattr(value, "item")
                              else value), (key, g, w)


@pytest.mark.parametrize("name", ["sql", "dataframe"])
def test_twin_returns_the_jax_examples_rows(name, capsys):
    got = _load("torch", f"{name}.py").main(device="cpu")
    (frame,) = _jax_printed(name)
    assert len(got) == len(frame) > 0
    _same_rows(got, frame)
    assert capsys.readouterr().out.splitlines()[0].split() == list(frame)


@pytest.mark.parametrize("partitions", [None, 4])
def test_standalone_twin_returns_the_jax_examples_rows(partitions):
    rows, status = _load("torch", "standalone_sql.py").main(
        device="cpu", partitions=partitions)
    frame, jax_status = _jax_printed("standalone_sql")
    assert len(rows) == 4
    _same_rows(rows, frame)
    assert status["state"] == jax_status["state"] == "successful"
    assert all(st["partitions"] == (partitions or 1)
               for st in status["stages"].values())
