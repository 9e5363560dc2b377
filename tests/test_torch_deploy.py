"""The port's deployment files (`deploy/torch/`): the k8s manifests pass
every check `tests/test_k8s_manifests.py` makes of `deploy/k8s/`; every
process the compose file, the manifests and `local_cluster.sh` start is a
`ballista_tpu_torch` module whose own argument parser takes its arguments
(with `--device cuda` where the process executes stages); nothing there
names the JAX package; and the local cluster answers a query over the wire
on the CPU."""

import glob
import importlib
import os
import re
import shlex
import subprocess

import pytest
import yaml

import test_k8s_manifests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_DEPLOY = os.path.join(REPO, "deploy", "torch")
K8S_DIR = os.path.join(TORCH_DEPLOY, "k8s")
# modules that execute stages on their device
EXECUTING = {"ballista_tpu_torch.serve",
             "ballista_tpu_torch.scheduler.executor_process",
             "ballista_tpu_torch.benchmarks.runner",
             "ballista_tpu_torch.cli"}
# the shell values local_cluster.sh and the manifests fill in
SHELL_VALUES = {"$PORT": "50050", "$POLICY": "push", "$DEVICE": "cuda",
                "$WORK_DIR": "/tmp/cluster", "$i": "1",
                "$(POD_NAME)": "ballista-executor-0"}


@pytest.mark.parametrize("check", sorted(
    name for name in dir(test_k8s_manifests) if name.startswith("test_")))
def test_manifest_checks_pass_on_the_twins(check, monkeypatch):
    monkeypatch.setattr(test_k8s_manifests, "K8S_DIR", K8S_DIR)
    getattr(test_k8s_manifests, check)()


def _fill(text):
    for var, value in SHELL_VALUES.items():
        text = text.replace(var, value)
    return text


def _argv_after_module(argv):
    """(module, its arguments) of a `python -m module args...` argv."""
    at = argv.index("-m")
    assert argv[at - 1] == "python", argv
    return argv[at + 1], argv[at + 2:]


def _compose_commands():
    with open(os.path.join(TORCH_DEPLOY, "docker-compose.yml")) as f:
        services = yaml.safe_load(f)["services"]
    return {f"compose {name}": shlex.split(svc["command"])
            for name, svc in services.items()}


def _manifest_commands():
    out = {}
    for path in sorted(glob.glob(os.path.join(K8S_DIR, "*.yaml"))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                spec = (doc or {}).get("spec", {}).get("template", {})
                for c in spec.get("spec", {}).get("containers", []):
                    argv = list(c.get("command", [])) + list(c.get("args", []))
                    if argv[:2] == ["/bin/sh", "-c"]:
                        argv = shlex.split(_fill(argv[2]))
                        argv = argv[1:] if argv[0] == "exec" else argv
                    out[f"{os.path.basename(path)} {c['name']}"] = argv
    return out


def _shell_commands():
    with open(os.path.join(TORCH_DEPLOY, "local_cluster.sh")) as f:
        text = f.read().replace("\\\n", " ")
    text = re.sub(r"\$\{(\w+)\}", r"$\1", text)
    out = {}
    for k, m in enumerate(re.finditer(r"python -m (\S+)([^\n]*)", text)):
        line = m.group(0).split(">")[0].split(")\"")[0]
        out[f"local_cluster.sh {k}"] = shlex.split(_fill(line))
    return out


COMMANDS = {**_compose_commands(), **_manifest_commands(), **_shell_commands()}


def test_every_file_starts_processes():
    kinds = {label.split()[0] for label in COMMANDS}
    assert kinds == {"compose", "local_cluster.sh", "scheduler.yaml",
                     "executor.yaml"}
    assert len([c for c in COMMANDS if c.startswith("local_cluster")]) == 3


@pytest.mark.parametrize("label", sorted(COMMANDS))
def test_process_is_a_port_module_whose_parser_takes_its_arguments(label):
    module, args = _argv_after_module(COMMANDS[label])
    assert module.startswith("ballista_tpu_torch."), (label, module)
    parsed = importlib.import_module(module)._parser().parse_args(args)
    if module in EXECUTING:
        assert parsed.device == "cuda", label
    if module == "ballista_tpu_torch.serve" and not label.startswith(
            "local_cluster"):
        assert parsed.flight_port == 8815, label


def test_no_file_names_the_jax_package():
    for path in glob.glob(os.path.join(TORCH_DEPLOY, "**", "*"),
                          recursive=True):
        if os.path.isfile(path):
            with open(path) as f:
                text = f.read()
            assert "ballista_tpu." not in text, path
            assert "jax" not in text.lower(), path


def test_executors_take_a_gpu_each():
    with open(os.path.join(TORCH_DEPLOY, "docker-compose.yml")) as f:
        services = yaml.safe_load(f)["services"]
    ids = []
    for name in ("executor-1", "executor-2"):
        (dev,) = services[name]["deploy"]["resources"]["reservations"][
            "devices"]
        assert dev["capabilities"] == ["gpu"]
        ids += dev["device_ids"]
    assert sorted(ids) == ["0", "1"]
    with open(os.path.join(K8S_DIR, "executor.yaml")) as f:
        (ss,) = [d for d in yaml.safe_load_all(f)
                 if d.get("kind") == "StatefulSet"]
    limits = ss["spec"]["template"]["spec"]["containers"][0]["resources"][
        "limits"]
    assert limits["nvidia.com/gpu"] == 1


def test_local_cluster_on_the_cpu():
    env = dict(os.environ, BALLISTA_CLUSTER_DEVICE="cpu", OMP_NUM_THREADS="2")
    env.pop("BALLISTA_CLUSTER_PORT", None)
    res = subprocess.run([os.path.join(TORCH_DEPLOY, "local_cluster.sh"), "2",
                          "push"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "CLUSTER_SMOKE_OK"
