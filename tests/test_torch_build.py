"""grace_tpu_torch build (Morton sort, deltas, LBVH) against grace_tpu.

Keys, sort permutation, sorted spheres and every Tree field must be
bit-exact; invalid sizes must raise GraceError in both packages.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.build.deltas as jd
import grace_tpu.build.sph as jb
import grace_tpu_torch.build.deltas as td
import grace_tpu_torch.build.sph as tb
from grace_tpu.core.errors import GraceError as JGraceError
from grace_tpu_torch import convert
from grace_tpu_torch.core.errors import GraceError as TGraceError

TREE_FIELDS = ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves")


def _spheres(rng, n):
    return np.concatenate([rng.random((n, 3)), 0.01 + 0.05 * rng.random((n, 1))],
                          axis=1).astype(np.float32)


def _assert_same_build(s, mpl, delta_kind="euclidean", bits=30):
    j = jax.jit(jb.build_sph_tree, static_argnums=(1, 2, 3))(s, mpl, delta_kind, bits)
    t = tb.build_sph_tree(torch.from_numpy(s), mpl, delta_kind, bits)
    assert np.array_equal(np.asarray(j[0]), t[0].numpy())          # sorted spheres
    assert np.array_equal(np.asarray(j[2]), t[2].numpy())          # permutation
    want = convert.tree_from_numpy(*(np.asarray(getattr(j[1], f)) for f in TREE_FIELDS),
                                   j[1].max_per_leaf, device="cpu")
    for f in TREE_FIELDS:
        a, b = getattr(want, f), getattr(t[1], f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert want.max_per_leaf == t[1].max_per_leaf


@pytest.mark.parametrize("n", [1, 2, 17, 3000])
@pytest.mark.parametrize("mpl", [1, 16, 32])
def test_build_sph_tree_exact(n, mpl):
    s = _spheres(np.random.default_rng(n * 100 + mpl), n)
    if n < 2 or mpl >= n:
        with pytest.raises(JGraceError):
            jb.build_sph_tree(s, mpl)
        with pytest.raises(TGraceError):
            tb.build_sph_tree(torch.from_numpy(s), mpl)
        return
    _assert_same_build(s, mpl)


def test_all_identical_points():
    s = np.tile(np.array([[0.3, 0.6, 0.2, 0.05]], np.float32), (64, 1))
    _assert_same_build(s, 4)


@pytest.mark.parametrize("delta_kind", ["xor", "surface_area"])
@pytest.mark.parametrize("bits", [30, 63])
def test_delta_kinds_exact(delta_kind, bits):
    s = _spheres(np.random.default_rng(7), 1500)
    s[100:140] = s[99]                        # equal keys and zero deltas
    _assert_same_build(s, 8, delta_kind, bits)


@pytest.mark.parametrize("bits", [30, 63])
def test_sort_and_deltas_exact(bits):
    s = _spheres(np.random.default_rng(8), 2000)
    jk, jss, jperm = jax.jit(jb.sort_by_morton, static_argnames="bits")(s, bits=bits)
    tk, tss, tperm = tb.sort_by_morton(torch.from_numpy(s), bits=bits)
    if bits == 63:
        jk = (np.asarray(jk[0]).astype(np.int64) << 32) | np.asarray(jk[1]).astype(np.int64)
        jx = jd.xor_deltas_63bit(*jax.jit(jb.sort_by_morton, static_argnames="bits")(
            s, bits=bits)[0])
    else:
        jx = jd.xor_deltas(jk)
    assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    assert np.array_equal(np.asarray(jperm), tperm.numpy())
    assert np.array_equal(np.asarray(jss), tss.numpy())
    assert np.array_equal(np.asarray(jx).astype(np.int64),
                          tb.xor_deltas_sph(tk, bits=bits).numpy())
    # Float deltas: XLA contracts some of their multiply-adds and not others
    # (it depends on how it vectorizes the fusion), so they agree to 2 ulp;
    # the trees built from them are compared exactly above.
    for jf, tf in ((jb.euclidean_deltas_sph, tb.euclidean_deltas_sph),
                   (jb.surface_area_deltas_sph, tb.surface_area_deltas_sph)):
        j, t = np.asarray(jax.jit(jf)(jss)), tf(tss).numpy()
        assert np.all(np.abs(j - t) <= 2 * np.spacing(np.abs(j)))


def test_delta_sentinels():
    assert td.delta_max_sentinel(torch.int64) == 0xFFFFFFFF
    assert td.delta_max_sentinel(torch.float32) == float("inf")
    with pytest.raises(TypeError):
        td.delta_max_sentinel(torch.int8)
