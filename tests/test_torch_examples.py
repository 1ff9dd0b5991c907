"""The torch examples (``grace_tpu_torch/examples``) run on ``--device cpu``
at small sizes: the scenes they build are the JAX examples' (the same
numpy draws, the same synthetic snapshot bytes and torus), their outputs
are written and well formed."""

import importlib.util
import pathlib

import numpy as np
import pytest

from grace_tpu_torch.examples import hitcount_stats, project_gadget, render_triangle
from grace_tpu_torch.examples import split_device, train_splat
from tests.helper.torch_parity import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bmp_size(path):
    raw = pathlib.Path(path).read_bytes()
    assert raw[:2] == b"BM" and int.from_bytes(raw[2:6], "little") == len(raw)
    return int.from_bytes(raw[18:22], "little"), int.from_bytes(raw[22:26], "little")


def test_split_device():
    assert split_device(["3"]) == ("cuda", ["3"])
    assert split_device(["--device", "cpu", "3"]) == ("cpu", ["3"])
    assert split_device(["a", "--device=cuda:1", "b"]) == ("cuda:1", ["a", "b"])


def test_hitcount_stats(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    counts = hitcount_stats.main(["2000", "4", "16", "save", "--device", "cpu"])
    out = capsys.readouterr().out
    assert counts.shape == (128,) and counts.sum() > 0
    assert f"Total hits: {counts.sum()}" in out and f"Max hits:   {counts.max()}" in out
    assert np.loadtxt("outdata_spheres.txt").shape == (2000, 4)
    rays = np.loadtxt("outdata_rays.txt")
    assert rays.shape == (128, 7) and np.allclose(rays[:, :3], 0.5) and np.all(rays[:, 6] == 2)
    np.testing.assert_allclose(np.linalg.norm(rays[:, 3:6], axis=1), 1.0, atol=1e-6)
    assert np.array_equal(np.loadtxt("outdata_hitcounts.txt", dtype=np.int64), counts)


def test_project_gadget(tmp_path, monkeypatch):
    snap = str(tmp_path / "snap.gdt")
    project_gadget.synthetic_snapshot(snap, n=3000, seed=2)
    theirs = str(tmp_path / "ref.gdt")
    jax_example("project_gadget").synthetic_snapshot(theirs, n=3000, seed=2)
    assert pathlib.Path(snap).read_bytes() == pathlib.Path(theirs).read_bytes()
    monkeypatch.chdir(tmp_path)
    img = project_gadget.main([snap, "32", "--device", "cpu"])
    assert img.shape == (32, 32) and np.isfinite(img).all() and img.max() > 0
    assert bmp_size("density.bmp") == (32, 32)


def test_render_triangle_torus_and_ply(tmp_path, monkeypatch):
    assert np.array_equal(render_triangle.torus_mesh(), jax_example("render_triangle").torus_mesh())
    monkeypatch.chdir(tmp_path)
    img = render_triangle.main(["24", "--device", "cpu"])
    assert img.shape == (24, 24) and 0 <= img.min() and img.max() <= 1 and (img > 0).sum() > 50
    assert bmp_size("render.bmp") == (24, 24)
    tris = render_triangle.torus_mesh(8, 6)          # 96 triangles, one face each
    ply = tmp_path / "torus.ply"
    ply.write_text("ply\nformat ascii 1.0\n"
                   f"element vertex {3 * len(tris)}\nproperty float x\nproperty float y\n"
                   f"property float z\nelement face {len(tris)}\n"
                   "property list uchar int vertex_indices\nend_header\n"
                   + "".join(f"{x!r} {y!r} {z!r}\n" for x, y, z in tris.reshape(-1, 3).tolist())
                   + "".join(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n" for i in range(len(tris))))
    img = render_triangle.main([str(ply), "16", "--device", "cpu"])
    assert img.shape == (16, 16) and (img > 0).sum() > 10
    assert bmp_size("render.bmp") == (16, 16)


def test_train_splat_reduces_the_loss(capsys):
    loss0, loss = train_splat.main(["3", "--device", "cpu"])
    assert np.isfinite(loss0) and loss < loss0
    assert "loss reduced" in capsys.readouterr().out


def test_examples_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        hitcount_stats.main(["100", "1"])
