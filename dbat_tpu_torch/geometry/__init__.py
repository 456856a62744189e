"""Network geometry: initial values and quality metrics (counterpart of
dbat_tpu/geometry; numpy)."""
