"""Network geometry: initial values (resection, forward intersection,
the pose graph), relative orientation, alignment and quality metrics
(counterpart of dbat_tpu/geometry; numpy)."""
