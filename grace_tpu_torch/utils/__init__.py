"""Timing and profiling helpers (PyTorch counterpart of ``grace_tpu.utils``)."""
