"""The partition mesh, partitioned batches, the shuffle and multi-process
execution on torch.distributed (port of ballista_tpu/parallel)."""
