"""The port's REST API (`api.py`), its graphviz renderings (`utils/dot.py`)
and `python -m ballista_tpu_torch.serve`: the cases of tests/test_api.py
and tests/test_serde_dot.py against the port, each route's JSON equal key
for key to the JAX package's ApiServer over the same cluster state (Q1
and Q6 run by a standalone cluster of each package, 8 partitions); the
API over the scheduler's RPC service; and `serve` with the RPC wire.

Where the two differ: `/api/metrics` `stage_metrics` is empty in the JAX
package's standalone cluster (its job contexts never fill the runtime's
metrics, which only its `execute_distributed` writes) and holds the
latest StageMetrics of each stage id in the port's, with the JAX
package's fields (but compile_s) and the bytes the port moved; operator labels carry the
group-table size each package chose (the port lowers the plan again with
the rows each stage sent), so their output rows are compared as a
multiset. `/api/file_metadata` answers the dict of `client/context.py
file_metadata`, which the JAX package's gives for the same file."""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from ballista_tpu_torch import batch as B
from ballista_tpu_torch.api import ApiServer
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.scheduler.distributed_planner import (
    DistOptions, DistributedPlanner)
from ballista_tpu_torch.scheduler.standalone import StandaloneCluster
from ballista_tpu_torch.serde.plans import plan_from_json, plan_to_json
from ballista_tpu_torch.utils.dot import (distributed_plan_dot,
                                          logical_plan_dot, stage_dot)

torch.set_num_threads(2)

SF = 0.002
P = 8
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module")
def apis():
    """(port server, port cluster, JAX server, JAX cluster, job ids): each
    cluster ran Q1 to the end."""
    from ballista_tpu.api import ApiServer as JaxApi
    from ballista_tpu.client import SessionContext as JaxContext
    from ballista_tpu.datagen import register_tpch as jax_register
    from ballista_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ballista_tpu.scheduler.distributed_planner import \
        DistOptions as JaxDistOptions
    from ballista_tpu.scheduler.standalone import \
        StandaloneCluster as JaxCluster

    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    tcl = StandaloneCluster(tctx, make_mesh(P, devices=[torch.device("cpu")]
                                            * P), DistOptions(n_partitions=P))
    jctx = JaxContext()
    jax_register(jctx, SF)
    jcl = JaxCluster(jctx, jax_make_mesh(P), JaxDistOptions(n_partitions=P))
    jobs = {}
    for name, cl in (("port", tcl), ("jax", jcl)):
        done = cl.submit_sql(TPCH_QUERIES[1])
        cl.scheduler.run_until_idle()
        jobs[name] = done
    servers = ApiServer(tcl).start(), JaxApi(jcl).start()
    yield servers[0], tcl, servers[1], jcl, jobs
    for s in servers:
        s.stop()


def get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def keys(doc):
    """The key structure of a JSON document: dicts by key (job ids and
    stage ids, which differ between the runs, by position), lists by
    their first item."""
    if isinstance(doc, dict):
        if "operator_rows" in doc:
            doc = dict(doc, operator_rows=sorted(doc["operator_rows"].values()))
        if all(re.fullmatch(r"[a-z0-9]{7}|\d+", k) for k in doc) and doc:
            return ["*", keys(next(iter(doc.values())))]
        return {k: keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [keys(doc[0])] if doc else []
    return type(doc).__name__ if doc is not None else None


@pytest.mark.parametrize("route", [
    "/api/state", "/api/jobs", "/api/job/{job}", "/api/executors",
    "/api/job/{job}/stages", "/api/scaler/is_active", "/api/scaler/metrics",
    "/api/metrics", "/api/job/nope123"])
def test_route_json_equals_jax_key_for_key(apis, route):
    tserver, _, jserver, _, jobs = apis
    _, mine = get(tserver, route.format(job=jobs["port"]))
    _, theirs = get(jserver, route.format(job=jobs["jax"]))
    mine, theirs = json.loads(mine), json.loads(theirs)
    if route == "/api/metrics":
        from ballista_tpu.scheduler.runtime import StageMetrics
        assert theirs["stage_metrics"] == {}
        extra = {"partitions", "bytes_to_device", "bytes_to_host",
                 "bytes_exchanged"}
        assert mine["stage_metrics"]
        for m in mine["stage_metrics"].values():
            # eager torch compiles nothing: no compile_s
            assert set(m) - extra == set(StageMetrics().as_dict()) - {
                "compile_s"}
        del mine["stage_metrics"], theirs["stage_metrics"]
    assert keys(mine) == keys(theirs)
    if route == "/api/job/{job}/stages":
        assert [sorted(s["metrics"]["operator_rows"].values())
                for s in mine["stages"]] == \
            [sorted(s["metrics"]["operator_rows"].values())
             for s in theirs["stages"]]


def test_state_jobs_metrics_dot(apis):
    server, cl, *_ , jobs = apis
    job_id = jobs["port"]
    code, body = get(server, "/api/state")
    assert code == 200 and json.loads(body)["executors"][0]["id"] == \
        "mesh-executor-0"
    code, body = get(server, "/api/jobs")
    assert any(j["job_id"] == job_id for j in json.loads(body))
    code, body = get(server, f"/api/job/{job_id}")
    assert json.loads(body)["state"] == "successful"
    code, body = get(server, f"/api/job/{job_id}/dot")
    assert code == 200 and body.startswith("digraph")
    assert body == distributed_plan_dot(cl.launcher.jobs[job_id].dplan)
    code, body = get(server, "/api/metrics")
    m = json.loads(body)
    assert m["jobs_successful"] >= 1 and not m["active"]
    code, body = get(server, "/api/job/nope123")
    assert json.loads(body)["state"] == "not_found"


def test_executors_stages_scaler_routes(apis):
    server, cl, *_, jobs = apis
    job_id = jobs["port"]
    code, body = get(server, "/api/executors")
    ex = json.loads(body)
    assert code == 200 and ex[0]["task_slots"] >= 1 and "last_seen_s" in ex[0]
    code, body = get(server, f"/api/job/{job_id}/stages")
    stages = json.loads(body)["stages"]
    assert code == 200 and stages
    assert all(s["state"] == "successful" for s in stages)
    assert any(s["metrics"]["operator_rows"] for s in stages)
    sid = stages[0]["stage_id"]
    code, body = get(server, f"/api/job/{job_id}/stage/{sid}/dot")
    assert code == 200 and body.startswith(f"digraph stage_{sid}")
    with pytest.raises(urllib.error.HTTPError) as e:
        get(server, f"/api/job/{job_id}/stage/99/dot")
    assert e.value.code == 404
    code, body = get(server, "/api/scaler/is_active")
    assert code == 200 and json.loads(body)["result"] is False
    code, body = get(server, "/api/scaler/metrics")
    assert json.loads(body)["metricName"] == "pending_tasks"
    code, body = get(server, "/metrics")
    assert code == 200
    try:
        code, body = get(server, f"/api/job/{job_id}/dot_svg")
        assert shutil.which("dot") and "<svg" in body
    except urllib.error.HTTPError as e:
        assert e.code == 501 and not shutil.which("dot")


def test_file_metadata_is_not_ported(apis, tmp_path):
    """The route answers 200 with the file's metadata, the JAX package's
    dict (the test's name is from when it answered 501), and 400 for a
    file type it cannot read."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from ballista_tpu.client.context import file_metadata as jax_metadata
    server, jax_server = apis[0], apis[2]
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}), path)
    code, body = get(server, f"/api/file_metadata?path={path}")
    assert code == 200
    assert json.loads(body) == jax_metadata(path) == json.loads(
        get(jax_server, f"/api/file_metadata?path={path}")[1])
    with pytest.raises(urllib.error.HTTPError) as e:
        get(server, "/api/file_metadata?path=x.xlsx")
    assert e.value.code == 400
    assert "unsupported file type" in e.value.read().decode()


def test_cancel_job(apis):
    server, cl, *_ = apis
    job_id = cl.submit_sql(TPCH_QUERIES[6])
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/api/job/{job_id}", method="PATCH")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["cancelled"]
    assert cl.job_status(job_id)["state"] == "cancelled"


def test_dashboard_and_udf(apis):
    server, cl, *_ = apis
    code, body = get(server, "/")
    assert code == 200 and "ballista_tpu_torch scheduler" in body
    from ballista_tpu_torch.schema import INT64
    cl.ctx.register_udf("double_it", lambda x: x * 2, INT64)
    batch, schema = cl.ctx.sql("select double_it(n_nationkey) as d from "
                               "nation order by d desc limit 2").collect()
    assert list(B.to_numpy(batch, schema)["d"][0]) == [48, 46]


def test_read_json_and_csv(tmp_path):
    jpath = tmp_path / "t.jsonl"
    jpath.write_text("\n".join(json.dumps({"a": i, "b": f"s{i}"})
                               for i in range(5)))
    cpath = tmp_path / "t.csv"
    cpath.write_text("a,b\n1,x\n2,y\n")
    ctx = SessionContext(device="cpu")
    assert list(ctx.read_json(str(jpath)).to_pandas()["a"]) == [0, 1, 2, 3, 4]
    assert list(ctx.read_csv(str(cpath)).to_pandas()["b"]) == ["x", "y"]


def test_api_over_the_rpc_service(tmp_path):
    """The same routes over the scheduler's RPC service, whose stages run
    in executor processes: the dot renderings come from the plan the
    service made at submission."""
    from ballista_tpu_torch.scheduler.rpc import (SchedulerRpcClient,
                                                  serve_scheduler)
    service, httpd = serve_scheduler(str(tmp_path), device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    api = ApiServer(service).start()
    try:
        client = SchedulerRpcClient(
            f"http://127.0.0.1:{httpd.server_address[1]}", device="cpu")
        tables = {"kind": "tpch", "sf": SF}
        job_id = client.submit_sql(TPCH_QUERIES[3], tables,
                                   options={"n_partitions": 2})
        code, body = get(api, f"/api/job/{job_id}")
        assert json.loads(body)["state"] in ("queued", "running")
        code, body = get(api, f"/api/job/{job_id}/dot")
        assert body == distributed_plan_dot(service.plans[job_id])
        assert body.count("subgraph") == len(service.plans[job_id].stages)
        code, body = get(api, f"/api/job/{job_id}/stages")
        assert len(json.loads(body)["stages"]) == \
            len(service.plans[job_id].stages)
        code, body = get(api, "/api/metrics")
        m = json.loads(body)
        assert m["stage_metrics"] == {} and m["pending_tasks"] >= 1
        assert get(api, "/api/state")[0] == 200
    finally:
        api.stop()
        httpd.shutdown()
        httpd.server_close()


# -- tests/test_serde_dot.py --

@pytest.fixture(scope="module")
def ctx():
    c = SessionContext(device="cpu")
    register_tpch(c, SF)
    return c


@pytest.mark.parametrize("query", [1, 3, 5, 8, 12, 19])
def test_plan_json_roundtrip_executes(ctx, query):
    plan = ctx.sql(TPCH_QUERIES[query]).plan
    plan2 = plan_from_json(plan_to_json(plan))
    b1, s1 = ctx.collect(plan)
    b2, s2 = ctx.collect(plan2)
    assert B.to_pandas(b1, s1).equals(B.to_pandas(b2, s2))


def test_dot_outputs(ctx):
    from ballista_tpu.utils import dot as jdot
    plan = ctx.sql(TPCH_QUERIES[3]).plan
    dot = logical_plan_dot(plan)
    assert dot.startswith("digraph") and "Aggregate" in dot
    dp = DistributedPlanner(ctx, DistOptions(n_partitions=8)).plan(plan)
    ddot = distributed_plan_dot(dp)
    assert "cluster_0" in ddot and "shuffle" in ddot
    assert ddot.count("subgraph") == len(dp.stages)
    assert stage_dot(dp, 0).startswith("digraph stage_0")
    with pytest.raises(KeyError):
        stage_dot(dp, 99)
    # the renderers are the JAX package's, line for line
    assert open(jdot.__file__).read().split('"""', 2)[2] == \
        open(os.path.join(REPO, "ballista_tpu_torch", "utils", "dot.py")
             ).read().split('"""', 2)[2]


def test_job_store_version_guard(tmp_path):
    from ballista_tpu_torch.scheduler.job_store import (FileJobStore,
                                                        recover_graphs)
    from ballista_tpu_torch.serde.plans import WireVersionError
    store = FileJobStore(str(tmp_path))
    with open(tmp_path / "zzz9999.json", "w") as f:
        json.dump({"@wire": 999, "graph": {}}, f)
    with pytest.raises(WireVersionError):
        recover_graphs(store)


# -- serve --

def test_serve_refuses_flight(monkeypatch):
    """Without pyarrow (the card machine has none) `--flight-port` raises
    an ImportError naming it before anything starts; with pyarrow the
    Flight server runs (tests/test_torch_flight.py)."""
    import sys
    from ballista_tpu_torch import serve
    monkeypatch.setitem(sys.modules, "pyarrow.flight", None)
    with pytest.raises(ImportError, match="pyarrow"):
        serve.main(["--flight-port", "8815", "--device", "cpu"])


def test_serve_with_the_rpc_wire(tmp_path):
    """`python -m ballista_tpu_torch.serve --device cpu` serves the REST API
    over its in-process cluster and the RPC wire on another port; an
    executor process registers there and runs a query submitted over it."""
    from ballista_tpu_torch.batch import to_numpy
    from ballista_tpu_torch.scheduler.rpc import SchedulerRpcClient
    from test_torch_rpc import spawn_executor
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        rpc_port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.serve", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--partitions", "2",
         "--sf-demo", str(SF), "--policy", "pull",
         "--work-dir", str(tmp_path / "spill"),
         "--scheduler-rpc-port", str(rpc_port)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    procs = [p]
    try:
        rest = None
        deadline = time.time() + 60
        while time.time() < deadline:
            line = p.stdout.readline()
            m = re.search(r"REST/UI on http://127.0.0.1:(\d+)/", line)
            if m:
                rest = int(m.group(1))
            if "scheduler RPC wire" in line:
                break
            assert p.poll() is None, line
        assert rest
        threading.Thread(target=lambda: [None for _ in p.stdout],
                         daemon=True).start()
        with urllib.request.urlopen(f"http://127.0.0.1:{rest}/api/state",
                                    timeout=30) as r:
            assert json.loads(r.read())["started"]
        url = f"http://127.0.0.1:{rpc_port}"
        procs.append(spawn_executor(url, "serve-ex"))
        client = SchedulerRpcClient(url, device="cpu")
        job = client.submit_sql("select count(*) n from nation",
                                {"kind": "tpch", "sf": SF})
        got = to_numpy(*client.wait_batch(job, timeout_s=120))
        assert list(got["n"][0]) == [25]
        p.send_signal(signal.SIGINT)
        assert p.wait(timeout=30) == 0
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait(timeout=30)
