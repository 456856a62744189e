"""Data model and x-vector layout (counterpart of dbat_tpu/core)."""
