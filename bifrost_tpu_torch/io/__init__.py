"""File-format codecs and the DADA IPC protocol: the port's own copies
of bifrost_tpu/io's modules (sigproc, guppi_raw, header_standard,
dada_ipc)."""
