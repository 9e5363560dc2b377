"""Stage planning, the partitioned and serial runtimes, and the
scheduler's control plane (port of ballista_tpu/scheduler)."""
