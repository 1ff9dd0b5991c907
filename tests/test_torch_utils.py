"""grace_tpu_torch timers and profiling on the CPU: ``Timer`` splits and
elapsed times, synchronizing only on CUDA tensors (none here), and
``profiling.trace`` writing a Chrome trace with its named regions."""

import dataclasses
import json
import os

import pytest
import torch

from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.utils import profiling, timers
from grace_tpu_torch.utils.timers import Timer


def test_timer_splits_without_synchronizing_cpu_tensors(monkeypatch):
    def no_sync(*_):
        raise AssertionError("synchronized on CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t = Timer().start()
    x = torch.ones(64, 64).sum()
    dt1 = t.split(sync_on=x)
    dt2 = t.split(sync_on={"a": [x, (x, None)], "b": 3})
    assert dt1 >= 0 and dt2 >= 0
    assert t.elapsed() >= dt1 + dt2
    assert t.elapsed(sync_on=Rays(x[None], x[None], x[None])) >= dt1


def test_timer_finds_the_cuda_devices_of_nested_tensors():
    @dataclasses.dataclass
    class Pair:
        a: object
        b: object

    cpu = torch.zeros(2)
    assert timers._cuda_devices(Pair([cpu], {"k": (cpu,)}), set()) == set()
    assert timers._cuda_devices(None, set()) == set()
    if torch.cuda.is_available():
        cuda = torch.zeros(2, device="cuda")
        assert timers._cuda_devices(Pair(cpu, {"k": [cuda]}), set()) == {cuda.device}


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr")
    with profiling.trace(log_dir) as d:
        with profiling.annotate("grace_region"):
            (torch.randn(128, 128) @ torch.randn(128, 128)).sum()
    assert d == log_dir
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "grace_region" for e in events)


def test_profiling_trace_default_dir_is_temporary(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.trace() as d:
        torch.ones(4).sum()
    assert d.startswith(str(tmp_path))
    assert os.path.exists(os.path.join(d, profiling.TRACE_FILE))
