"""Shard meshes, the point-partitioned Schur backend and the
multi-process start-up (counterpart of dbat_tpu/parallel)."""
