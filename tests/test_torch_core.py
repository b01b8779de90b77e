"""The port's topology primitives against the JAX reference, bitwise:
direction codes, MSS labels, pointer jumping, gathers and the
segmentation accuracy (``repro_torch.core.grid``/``labels`` against
``repro.core.grid``/``labels`` and the brute-force ``repro.core.ref``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jgrid, labels as jlabels
from repro.core.ref import mss_labels_ref, steepest_dirs_ref
from repro.data import synthetic_field as j_synthetic_field
from _torch_threads import one_thread  # noqa: F401
from repro_torch.core import grid as tgrid, labels as tlabels
from repro_torch.data import synthetic_field as t_synthetic_field

SHAPES = [(5, 6, 7), (4, 9, 5), (9, 11), (7, 13)]
KINDS = ["noise", "ties", "constant"]


def make_field(shape, kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape)
    if kind == "ties":
        f = np.round(f * 2) / 2
    elif kind == "constant":
        f = np.full(shape, 1.5)
    return f.astype(dtype)


def ref_side(dtype):
    """x64 for f64 fields, as the reference needs for f64 arithmetic."""
    return jax.enable_x64(dtype == np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_steepest_dirs_and_labels_match_reference(shape, kind, dtype):
    f = make_field(shape, kind, dtype)
    with ref_side(dtype):
        up, dn = jgrid.steepest_dirs(jnp.asarray(f))
        M, m = jlabels.mss_labels(jnp.asarray(f))
        up, dn, M, m = map(np.asarray, (up, dn, M, m))
    tup, tdn = tgrid.steepest_dirs(torch.from_numpy(f))
    tM, tm = tlabels.mss_labels(torch.from_numpy(f))
    assert np.array_equal(tup.numpy(), up) and np.array_equal(tdn.numpy(), dn)
    assert np.array_equal(tM.numpy(), M) and np.array_equal(tm.numpy(), m)
    rup, rdn = steepest_dirs_ref(f)
    rM, rm = mss_labels_ref(f)
    assert np.array_equal(tup.numpy(), rup) and np.array_equal(tdn.numpy(), rdn)
    assert np.array_equal(tM.numpy(), rM) and np.array_equal(tm.numpy(), rm)


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("shape", [(7, 5, 6), (11, 9)])
def test_steepest_dirs_chunked_is_unchunked(shape, chunk):
    f = torch.from_numpy(make_field(shape, "ties", np.float32, seed=3))
    whole = tgrid.steepest_dirs(f)
    parts = tgrid.steepest_dirs(f, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_dir_shift_and_pointers_match(shape):
    f = make_field(shape, "noise", np.float32, seed=1)
    x = np.random.default_rng(2).integers(-50, 50, size=shape).astype(np.int32)
    up, _ = jgrid.steepest_dirs(jnp.asarray(f))
    tup = torch.from_numpy(np.asarray(up))
    got = tgrid.gather_dir(torch.from_numpy(x), tup).numpy()
    assert np.array_equal(got, np.asarray(jgrid.gather_dir(jnp.asarray(x), up)))
    assert np.array_equal(tgrid.dir_to_pointer(tup).numpy(),
                          np.asarray(jgrid.dir_to_pointer(up)))
    for off in tgrid.offsets_for(len(shape)):
        want = np.asarray(jgrid.shift(jnp.asarray(x), off, jnp.int32(-7)))
        assert np.array_equal(tgrid.shift(torch.from_numpy(x), off, -7).numpy(),
                              want)


@pytest.mark.parametrize("shape", SHAPES)
def test_is_extremum_matches(shape):
    f = make_field(shape, "noise", np.float32, seed=3)
    for codes in jgrid.steepest_dirs(jnp.asarray(f)):
        got = tgrid.is_extremum(torch.from_numpy(np.asarray(codes))).numpy()
        want = np.asarray(jgrid.is_extremum(codes))
        assert got.dtype == np.bool_ and np.array_equal(got, want)
        assert 0 < got.sum() < got.size


@pytest.mark.parametrize("max_iters", [None, 0, 1, 2, 3])
def test_pointer_jump_bound_and_early_exit(max_iters):
    # one integral line snaking through every vertex: needs log2(V) sweeps
    n = 37
    nxt = np.concatenate([np.arange(1, n), [n - 1]]).astype(np.int32)
    want = np.asarray(jlabels.pointer_jump(jnp.asarray(nxt), max_iters))
    got = tlabels.pointer_jump(torch.from_numpy(nxt), max_iters).numpy()
    assert np.array_equal(got, want)
    for v in (1, 2, 1000, 2 ** 20 + 1):
        assert tlabels.default_pointer_iters(v) == \
            jlabels.default_pointer_iters(v)


@pytest.mark.parametrize("shape", [(6, 7, 5), (12, 10)])
def test_segmentation_accuracy_matches(shape):
    f = make_field(shape, "noise", np.float32, seed=4)
    g = (f + np.random.default_rng(5).uniform(-0.3, 0.3, size=shape)
         ).astype(np.float32)
    want = np.asarray(jlabels.segmentation_accuracy(jnp.asarray(f),
                                                    jnp.asarray(g)))
    got = tlabels.segmentation_accuracy(torch.from_numpy(f),
                                        torch.from_numpy(g)).numpy()
    assert got.dtype == want.dtype and got == want


def test_stencil_constants_match():
    assert tgrid.OFFSETS_2D == jgrid.OFFSETS_2D
    assert tgrid.OFFSETS_3D == jgrid.OFFSETS_3D
    for nd in (2, 3):
        assert tgrid.self_code(nd) == jgrid.self_code(nd)
        assert tgrid.n_neighbors(nd) == len(jgrid.offsets_for(nd))
    assert tgrid.self_code(2) == 6 and tgrid.self_code(3) == 14


@pytest.mark.parametrize("name,shape", [("nyx", (6, 8, 10)),
                                        ("climate", (12, 20)),
                                        ("molecular", (8, 6, 5))])
def test_synthetic_fields_are_identical(name, shape):
    assert np.array_equal(t_synthetic_field(name, shape),
                          j_synthetic_field(name, shape))
