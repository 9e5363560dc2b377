"""Scheduler metrics collection (the port's copy of
ballista_tpu/scheduler/metrics.py).

Reference parity: `SchedulerMetricsCollector` trait + Prometheus impl
(scheduler/src/metrics/{mod,prometheus}.rs): job queued->submitted and
queued->completed latency histograms, failed/cancelled counters, per-event
processing-time histograms, pending-task gauge — exposed at /api/metrics
and, in Prometheus text format, at /metrics.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class Histogram:
    """Fixed-bucket latency histogram (seconds)."""

    BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

    def __init__(self):
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float):
        self.sum += v
        self.n += 1
        for i, b in enumerate(self.BOUNDS):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def as_dict(self) -> dict:
        return {"count": self.n, "sum_s": round(self.sum, 6),
                "mean_s": round(self.sum / self.n, 6) if self.n else None,
                "buckets": {f"le_{b}": c for b, c in
                            zip(list(self.BOUNDS) + ["inf"], self.counts)}}


class SchedulerMetricsCollector:
    """Trait surface (metrics/mod.rs:27). The default impl below records
    in-memory; subclass to ship elsewhere."""

    def record_submitted(self, job_id: str, queued_at: float,
                         submitted_at: float): ...

    def record_completed(self, job_id: str, queued_at: float,
                         completed_at: float): ...

    def record_failed(self, job_id: str): ...

    def record_cancelled(self, job_id: str): ...

    def record_event(self, event_type: str, processing_s: float): ...


class InMemoryMetricsCollector(SchedulerMetricsCollector):
    def __init__(self):
        self._lock = threading.Lock()
        self.submitted_latency = Histogram()
        self.completed_latency = Histogram()
        self.event_processing: Dict[str, Histogram] = {}
        self.jobs_failed = 0
        self.jobs_cancelled = 0

    def record_submitted(self, job_id, queued_at, submitted_at):
        with self._lock:
            self.submitted_latency.observe(max(submitted_at - queued_at, 0.0))

    def record_completed(self, job_id, queued_at, completed_at):
        with self._lock:
            self.completed_latency.observe(max(completed_at - queued_at, 0.0))

    def record_failed(self, job_id):
        with self._lock:
            self.jobs_failed += 1

    def record_cancelled(self, job_id):
        with self._lock:
            self.jobs_cancelled += 1

    def record_event(self, event_type, processing_s):
        with self._lock:
            self.event_processing.setdefault(event_type,
                                             Histogram()).observe(processing_s)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "job_submitted_latency": self.submitted_latency.as_dict(),
                "job_completed_latency": self.completed_latency.as_dict(),
                "jobs_failed": self.jobs_failed,
                "jobs_cancelled": self.jobs_cancelled,
                "event_processing": {k: h.as_dict() for k, h in
                                     self.event_processing.items()},
            }

    def prometheus_text(self, pending_tasks: Optional[int] = None) -> str:
        """Prometheus exposition format (metrics/prometheus.rs surface)."""
        with self._lock:
            lines: List[str] = []

            def hist(name: str, h: Histogram, labels: str = ""):
                cum = 0
                for b, c in zip(list(Histogram.BOUNDS) + ["+Inf"], h.counts):
                    cum += c
                    lab = f'le="{b}"' if not labels else f'{labels},le="{b}"'
                    lines.append(f"{name}_bucket{{{lab}}} {cum}")
                lab = f"{{{labels}}}" if labels else ""
                lines.append(f"{name}_sum{lab} {h.sum}")
                lines.append(f"{name}_count{lab} {h.n}")

            lines.append("# TYPE scheduler_job_submitted_latency_seconds "
                         "histogram")
            hist("scheduler_job_submitted_latency_seconds",
                 self.submitted_latency)
            lines.append("# TYPE scheduler_job_completed_latency_seconds "
                         "histogram")
            hist("scheduler_job_completed_latency_seconds",
                 self.completed_latency)
            lines.append("# TYPE scheduler_jobs_failed_total counter")
            lines.append(f"scheduler_jobs_failed_total {self.jobs_failed}")
            lines.append("# TYPE scheduler_jobs_cancelled_total counter")
            lines.append(
                f"scheduler_jobs_cancelled_total {self.jobs_cancelled}")
            lines.append("# TYPE scheduler_event_processing_seconds histogram")
            for k, h in self.event_processing.items():
                hist("scheduler_event_processing_seconds", h,
                     labels=f'event="{k}"')
            if pending_tasks is not None:
                lines.append("# TYPE scheduler_pending_tasks gauge")
                lines.append(f"scheduler_pending_tasks {pending_tasks}")
            return "\n".join(lines) + "\n"
