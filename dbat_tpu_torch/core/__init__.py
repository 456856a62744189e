"""Data model, x-vector layout and project comparison (counterpart of
dbat_tpu/core)."""
