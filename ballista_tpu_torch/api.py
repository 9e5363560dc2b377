"""REST introspection API (port of ballista_tpu/api.py, host only).

Reference parity: the scheduler's warp routes (`api/mod.rs:85-137`,
handlers `api/handlers.rs`): /api/state, /api/jobs, /api/job/{id},
/api/job/{id}/dot, /api/metrics — served by a stdlib ThreadingHTTPServer
over a StandaloneCluster (`scheduler/standalone.py`) or the scheduler's RPC
service (`scheduler/rpc.py`, whose executors are other processes). The dot
output renders with any graphviz viewer. `/api/file_metadata?path=...`
answers a parquet, csv or json file's schema and row count
(`client/context.py file_metadata`).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class ApiServer:
    """`cluster` is a StandaloneCluster or a SchedulerRpcService: both
    carry `scheduler`; the stage plans and per-operator metrics come from
    the cluster's job contexts, or from the service's plans and the
    metrics its executors ship in TaskStatus."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body, ctype="application/json"):
                data = (json.dumps(body).encode()
                        if ctype == "application/json" else body.encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    outer._route(self)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def do_PATCH(self):
                m = re.fullmatch(r"/api/job/([a-z0-9]+)", self.path)
                if m:
                    ok = outer.cancel_job(m.group(1))
                    self._send(200 if ok else 404,
                               {"cancelled": bool(ok), "job_id": m.group(1)})
                else:
                    self._send(404, {"error": "not found"})

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- routing --
    def _route(self, h):
        path = h.path
        sched = self.cluster.scheduler
        if path in ("/", "/index.html"):
            h._send(200, DASHBOARD_HTML, ctype="text/html")
            return
        if path == "/api/state":
            h._send(200, {
                "executors": [
                    {"id": e.meta.executor_id, "task_slots": e.meta.task_slots,
                     "free_slots": e.free_slots, "status": e.status.value}
                    for e in sched.executor_manager.executors.values()],
                "active_jobs": sum(
                    1 for g in sched.task_manager.jobs.values()
                    if g.state.value in ("running", "queued")),
                "started": True,
            })
            return
        if path == "/api/jobs":
            h._send(200, [g.status()
                          for g in sched.task_manager.jobs.values()])
            return
        m = re.fullmatch(r"/api/job/([a-z0-9]+)", path)
        if m:
            h._send(200, sched.job_status(m.group(1)))
            return
        if path == "/api/executors":
            # api/handlers.rs get_executors: metadata + heartbeat age +
            # 1/5/15-min load averages (metrics/load.rs)
            import time as _t
            now = _t.time()
            for e in sched.executor_manager.executors.values():
                e.sample_load()
            h._send(200, [
                {"id": e.meta.executor_id, "host": e.meta.host,
                 "port": e.meta.port, "task_slots": e.meta.task_slots,
                 "free_slots": e.free_slots, "status": e.status.value,
                 "last_seen_s": round(now - e.last_heartbeat, 1),
                 "load_avg": [round(x, 3) for x in e.load_avg]}
                for e in sched.executor_manager.executors.values()])
            return
        m = re.fullmatch(r"/api/job/([a-z0-9]+)/dot(_svg)?", path)
        if m:
            dplan = self._dplan(m.group(1))
            if dplan is None:
                h._send(404, {"error": "not found"})
                return
            from .utils.dot import distributed_plan_dot
            dot = distributed_plan_dot(dplan)
            if m.group(2):  # /dot_svg (api/handlers.rs get_query_dot_svg)
                svg = _render_svg(dot)
                if svg is None:
                    h._send(501, {"error": "graphviz 'dot' not installed"})
                else:
                    h._send(200, svg, ctype="image/svg+xml")
                return
            h._send(200, dot, ctype="text/vnd.graphviz")
            return
        m = re.fullmatch(r"/api/job/([a-z0-9]+)/stages", path)
        if m:
            # api/handlers.rs get_query_stages: per-stage state + metrics
            status = sched.job_status(m.group(1))
            if status.get("state") == "not_found":
                h._send(404, {"error": "not found"})
                return
            op_metrics = self._op_metrics(m.group(1))
            stages = []
            for sid, st in status.get("stages", {}).items():
                row = dict(stage_id=sid, **st)
                if not row.get("metrics"):
                    # in-process launcher: metrics collected inline rather
                    # than shipped in TaskStatus
                    row["metrics"] = {"operator_rows": op_metrics.get(sid)}
                stages.append(row)
            h._send(200, {"job_id": m.group(1), "stages": stages})
            return
        m = re.fullmatch(r"/api/job/([a-z0-9]+)/stage/(\d+)/dot", path)
        if m:
            dplan = self._dplan(m.group(1))
            if dplan is None:
                h._send(404, {"error": "not found"})
                return
            from .utils.dot import stage_dot
            try:
                h._send(200, stage_dot(dplan, int(m.group(2))),
                        ctype="text/vnd.graphviz")
            except KeyError:
                h._send(404, {"error": "no such stage"})
            return
        # KEDA external-scaler surface (proto/keda.proto:25 — IsActive /
        # GetMetrics; served as HTTP JSON for KEDA's metrics-api scaler).
        if path == "/api/scaler/is_active":
            h._send(200, {"result": sched.is_active()})
            return
        if path == "/api/scaler/metrics":
            h._send(200, {"metricName": "pending_tasks",
                          "metricValue": sched.pending_task_count()})
            return
        if path == "/api/metrics":
            h._send(200, {
                "pending_tasks": sched.pending_task_count(),
                "active": sched.is_active(),
                "jobs_total": len(sched.task_manager.jobs),
                "jobs_successful": sum(
                    1 for g in sched.task_manager.jobs.values()
                    if g.state.value == "successful"),
                "jobs_failed": sum(
                    1 for g in sched.task_manager.jobs.values()
                    if g.state.value == "failed"),
                "stage_metrics": self._stage_metrics(),
                "scheduler": sched.metrics.as_dict(),
            })
            return
        if path == "/metrics":
            # Prometheus exposition format (metrics/prometheus.rs endpoint)
            h._send(200, sched.metrics.prometheus_text(
                pending_tasks=sched.pending_task_count()),
                ctype="text/plain; version=0.0.4")
            return
        if path.startswith("/api/file_metadata"):
            # GetFileMetadata RPC analog (grpc.rs:293): schema inference
            # for clients
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(path).query)
            fpath = (q.get("path") or [""])[0]
            try:
                from .client.context import file_metadata
                h._send(200, file_metadata(fpath))
            except Exception as e:  # noqa: BLE001 - the client's error
                h._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        h._send(404, {"error": "not found"})

    def _dplan(self, job_id: str):
        """The job's stage plan: its job context's (the standalone
        cluster), or the one the RPC service planned at submission."""
        launcher = getattr(self.cluster, "launcher", None)
        if launcher is not None:
            jc = launcher.jobs.get(job_id)
            return jc.dplan if jc is not None else None
        return self.cluster.plans.get(job_id)

    def _op_metrics(self, job_id: str) -> dict:
        """Output rows per operator of each stage, where the standalone
        cluster collected them inline (an RPC service's executors ship
        them in TaskStatus, and the job status carries them)."""
        launcher = getattr(self.cluster, "launcher", None)
        jc = launcher.jobs.get(job_id) if launcher is not None else None
        return jc.op_metrics if jc is not None else {}

    def _stage_metrics(self) -> dict:
        """The latest StageMetrics of each stage id over the cluster's
        jobs, as the reference's runtime keeps them (none over an RPC
        service, whose stages run in other processes)."""
        launcher = getattr(self.cluster, "launcher", None)
        if launcher is None:
            return {}
        out = {}
        for jc in list(launcher.jobs.values()):
            for sid, m in jc.stage_metrics.items():
                out[sid] = m.as_dict()
        return out

    def cancel_job(self, job_id: str) -> bool:  # noqa: D401
        return _cancel_job(self.cluster, job_id)

    # -- lifecycle --
    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()


def _render_svg(dot: str):
    import shutil
    import subprocess
    exe = shutil.which("dot")
    if exe is None:
        return None
    try:
        return subprocess.run([exe, "-Tsvg"], input=dot.encode(),
                              capture_output=True, timeout=10,
                              check=True).stdout.decode()
    except Exception:  # noqa: BLE001
        return None


def _cancel_job(cluster, job_id: str) -> bool:
    if cluster.scheduler.task_manager.jobs.get(job_id) is None:
        return False
    cluster.scheduler.cancel_job(job_id)
    return True


# Zero-build dashboard SPA over the same routes the reference's React UI
# consumes (`ui/src`: QueriesList, ExecutorsList, stage metrics, dot links).
# Hash routing: #/ cluster view, #/job/<id> job drill-down. Status colors
# are reserved semantics and always paired with the state text (never
# color-alone); the progress bar is a single sequential hue.
DASHBOARD_HTML = """<!doctype html>
<html><head><title>ballista_tpu_torch scheduler</title><meta charset="utf-8"><style>
:root{--bg:#15181d;--panel:#1d2127;--line:#2c323b;--ink:#e6e9ee;
 --ink2:#9aa3b0;--accent:#6fb3e0;--good:#69b076;--bad:#d07d7d;
 --run:#c9a55c;--fill:#3d6f96}
body{font:14px/1.5 ui-monospace,Menlo,Consolas,monospace;margin:0;
 background:var(--bg);color:var(--ink)}
header{padding:14px 24px;border-bottom:1px solid var(--line);
 display:flex;gap:16px;align-items:baseline}
header h1{font-size:16px;margin:0;color:var(--accent)}
header a{color:var(--ink2);text-decoration:none}
main{padding:18px 24px;max-width:1100px}
.tiles{display:flex;gap:12px;flex-wrap:wrap;margin-bottom:18px}
.tile{background:var(--panel);border:1px solid var(--line);border-radius:6px;
 padding:10px 18px;min-width:120px}
.tile .v{font-size:24px} .tile .k{color:var(--ink2);font-size:12px}
table{border-collapse:collapse;width:100%;margin:8px 0 22px}
th{color:var(--ink2);font-weight:normal;text-align:left}
td,th{border-bottom:1px solid var(--line);padding:6px 10px}
tr.row:hover{background:var(--panel);cursor:pointer}
h2{font-size:13px;color:var(--ink2);text-transform:uppercase;
 letter-spacing:.08em;margin:18px 0 4px}
.st{display:inline-flex;align-items:center;gap:6px}
.st::before{content:'';width:8px;height:8px;border-radius:2px;
 background:var(--ink2)}
.st.successful::before{background:var(--good)}
.st.failed::before,.st.cancelled::before{background:var(--bad)}
.st.running::before,.st.queued::before{background:var(--run)}
.bar{background:var(--line);border-radius:4px;height:8px;width:140px;
 display:inline-block;vertical-align:middle;overflow:hidden}
.bar i{display:block;height:100%;background:var(--fill);border-radius:4px}
a{color:var(--accent)} button{background:var(--panel);color:var(--ink);
 border:1px solid var(--line);border-radius:4px;padding:2px 10px;cursor:pointer}
pre{background:var(--panel);border:1px solid var(--line);border-radius:6px;
 padding:12px;overflow:auto}
#svg svg{max-width:100%;height:auto;background:#fff;border-radius:6px}
</style></head><body>
<header><h1>ballista_tpu_torch</h1><a href="#/">cluster</a>
<a href="/api/metrics">metrics</a><a href="/metrics">prometheus</a></header>
<main id="app"></main>
<script>
const $ = (h) => { document.getElementById('app').innerHTML = h; };
const esc = (s) => String(s).replace(/[&<>]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;'}[c]));
const st = (s) => `<span class="st ${esc(s)}">${esc(s)}</span>`;
const j = async (u) => (await fetch(u)).json();

async function cluster(){
  const [s, ex, jobs, met] = await Promise.all([
    j('/api/state'), j('/api/executors'), j('/api/jobs'), j('/api/metrics')]);
  const slots = ex.reduce((a,e)=>a+e.task_slots,0);
  const free = ex.reduce((a,e)=>a+e.free_slots,0);
  $(`
  <div class="tiles">
   <div class="tile"><div class="v">${ex.length}</div><div class="k">executors</div></div>
   <div class="tile"><div class="v">${slots-free}/${slots}</div><div class="k">slots in use</div></div>
   <div class="tile"><div class="v">${s.active_jobs}</div><div class="k">active jobs</div></div>
   <div class="tile"><div class="v">${met.pending_tasks}</div><div class="k">pending tasks</div></div>
   <div class="tile"><div class="v">${met.jobs_successful}/${met.jobs_total}</div><div class="k">jobs succeeded</div></div>
  </div>
  <h2>Executors</h2>
  <table><tr><th>id</th><th>host</th><th>slots</th><th>status</th>
   <th>last seen</th><th>load 1/5/15m</th></tr>
  ${ex.map(e=>`<tr><td>${esc(e.id)}</td><td>${esc(e.host)}:${e.port}</td>
   <td>${e.task_slots-e.free_slots}/${e.task_slots}</td><td>${st(e.status)}</td>
   <td>${e.last_seen_s}s</td><td>${e.load_avg.join(' / ')}</td></tr>`).join('')}
  </table>
  <h2>Jobs</h2>
  <table><tr><th>job</th><th>state</th><th>progress</th><th>stages</th><th></th></tr>
  ${jobs.map(q=>{
    const ss = Object.values(q.stages||{});
    const parts = ss.reduce((a,x)=>a+x.partitions,0);
    const done = ss.reduce((a,x)=>a+x.successful,0);
    const pct = parts? Math.round(100*done/parts) : 0;
    return `<tr class="row" onclick="location.hash='#/job/${q.job_id}'">
     <td>${esc(q.job_id)}</td><td>${st(q.state)}</td>
     <td><span class="bar"><i style="width:${pct}%"></i></span> ${pct}%</td>
     <td>${ss.length}</td>
     <td>${q.state==='running'||q.state==='queued'
        ?`<button onclick="event.stopPropagation();cancel('${q.job_id}')">cancel</button>`:''}</td>
    </tr>`;}).join('')}
  </table>`);
}

async function job(id){
  const [detail, stages] = await Promise.all([
    j('/api/job/'+id), j('/api/job/'+id+'/stages').catch(()=>null)]);
  if (detail.state === 'not_found') { $(`<p>job ${esc(id)} not found</p>`); return; }
  let rows = '';
  for (const sg of (stages && stages.stages) || []){
    const m = sg.metrics && sg.metrics.operator_rows;
    rows += `<tr><td>${sg.stage_id}</td><td>${st(sg.state)}</td>
     <td>${sg.successful}/${sg.partitions}</td>
     <td>${m?Object.entries(m).map(([k,v])=>`${esc(k)}: ${v}`).join('<br>'):''}</td>
     <td><a href="/api/job/${esc(id)}/stage/${sg.stage_id}/dot">dot</a></td></tr>`;
  }
  $(`
  <p><a href="#/">&larr; cluster</a></p>
  <div class="tiles">
   <div class="tile"><div class="v">${st(detail.state)}</div><div class="k">job ${esc(id)}</div></div>
  </div>
  ${detail.error?`<pre>${esc(detail.error)}</pre>`:''}
  ${(detail.warnings&&detail.warnings.length)?`<pre>warnings:\\n${detail.warnings.map(esc).join('\\n')}</pre>`:''}
  <h2>Stages</h2>
  <table><tr><th>stage</th><th>state</th><th>partitions</th>
   <th>operator rows</th><th>plan</th></tr>${rows}</table>
  <h2>Stage DAG</h2>
  <div id="svg"><p class="k"><a href="/api/job/${esc(id)}/dot">dot source</a></p></div>`);
  try {
    const r = await fetch('/api/job/'+id+'/dot_svg');
    if (r.ok) document.getElementById('svg').innerHTML = await r.text();
  } catch (e) {}
}

async function cancel(id){
  await fetch('/api/job/'+id, {method:'PATCH'}); route();
}

function route(){
  const m = location.hash.match(/^#\\/job\\/([a-z0-9]+)/);
  (m ? job(m[1]) : cluster()).catch(e => $(`<pre>${esc(e)}</pre>`));
}
window.addEventListener('hashchange', route);
route(); setInterval(route, 2500);
</script></body></html>"""
