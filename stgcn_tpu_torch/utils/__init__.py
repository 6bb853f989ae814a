"""Logging and profiling of the port (``stgcn_tpu/utils``)."""
