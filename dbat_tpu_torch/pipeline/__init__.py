"""Network generators, camera specifications, the project built from
tables and the DBAT script runner (counterpart of dbat_tpu/pipeline)."""
