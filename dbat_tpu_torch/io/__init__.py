"""Input tables and result files (counterpart of dbat_tpu/io): the
control-point, image and EO table loaders, the PhotoModeler export,
tables and report, the PhotoScan .psz and lens .lnz projects, PLY, the
DBAT report, the EO, residual and statistics files, the report
comparison, the host's native helpers, and a PNG reader."""
