"""Host utilities: the object-store registry and graphviz renderings of
plans (port of ballista_tpu/utils)."""
