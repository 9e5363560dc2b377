"""Repartitioning of batches by key hash (port of ballista_tpu/parallel)."""
