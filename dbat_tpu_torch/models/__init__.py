"""Camera models and per-observation residuals (counterpart of
dbat_tpu/models)."""
