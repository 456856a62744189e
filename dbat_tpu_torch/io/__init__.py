"""Input tables and result files (counterpart of dbat_tpu/io): the
control-point, image and EO table loaders, the DBAT report, the EO,
residual and statistics files, and the report comparison."""
