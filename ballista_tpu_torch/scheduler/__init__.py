"""Stage planning and the serial (out-of-core) runtime (port of
ballista_tpu/scheduler)."""
