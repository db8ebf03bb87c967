"""File-format codecs: the port's own copies of bifrost_tpu/io's
numpy-only modules (sigproc, guppi_raw, header_standard)."""
