"""Result files (counterpart of dbat_tpu/io): the DBAT report."""
