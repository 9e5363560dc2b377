"""The partition mesh, partitioned batches and the shuffle (port of
ballista_tpu/parallel)."""
