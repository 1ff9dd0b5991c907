"""Profiling helpers (PyTorch counterpart of ``grace_tpu.utils.profiling``):
``torch.profiler`` traces exported in the Chrome trace format, and named
regions inside them."""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block (the CPU, and the card when there is one) and write
    ``log_dir/trace.json`` (default log_dir: ``grace_tpu_torch_trace`` in
    the temporary directory), viewable in chrome://tracing or Perfetto::

        with grace_tpu_torch.utils.profiling.trace("tr"):
            img, _ = pallas_trace_sph(...)
            torch.cuda.synchronize()
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "grace_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
