"""Sharded search and build over a grid of devices (port of vecgo_tpu/parallel)."""
