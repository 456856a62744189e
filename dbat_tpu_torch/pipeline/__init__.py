"""Network generators (counterpart of dbat_tpu/pipeline)."""
