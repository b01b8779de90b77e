"""The port's dirty-slab worklist and slab tiles against ``repro``'s.

``fused_fix_worklist`` on ``cuda_worklist`` (on the CPU each kernel's
plain version runs at the spans' slab origins) against the reference's
``fused_fix_worklist`` on ``pallas_worklist`` (interpret mode): the same
g, iteration count, convergence flag and ``skipped_slabs``. ``fused_fix``
on the ``cuda`` family, tiled or through the worklist, is bitwise the
dense loop, and takes the worklist where the reference's ``pallas``
backend does."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixes as jfixes
from repro.core.backend import PallasBackend
from _torch_threads import one_thread  # noqa: F401
from repro_torch.core import backend as tbackend, fixes as tfixes
from repro_torch.core.backend import CudaBackend, get_backend


def localized_pair(shape=(40, 6, 7), xi=0.25):
    """Violations confined to a few interior slabs (the reference's
    ``_localized_pair`` of tests/test_fixloop.py)."""
    rng = np.random.default_rng(5)
    f = np.linspace(0, 1, int(np.prod(shape)), dtype=np.float32) \
        .reshape(shape)
    fh = f.copy()
    lo, hi = shape[0] // 2 - 3, shape[0] // 2 + 3
    fh[lo:hi] += (0.9 * xi * rng.uniform(-1, 1, (hi - lo,) + shape[1:])) \
        .astype(np.float32)
    return f, fh, xi


def dense_noise(shape=(24, 6, 7), xi=0.3):
    """Noise everywhere (the reference's dense-noise worklist case)."""
    f = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    fh = (f + np.random.default_rng(10).uniform(-xi, xi, shape) * 0.999) \
        .astype(np.float32)
    return f, fh, xi


CASES = {"localized": localized_pair, "dense-noise": dense_noise}


def reference_worklist(f, fh, xi):
    topo = jfixes.field_topology(jnp.asarray(f), xi)
    g, it, ok, skipped = jfixes.fused_fix_worklist(jnp.asarray(fh), topo)
    return np.asarray(g), int(it), bool(ok), int(skipped)


def reference_dense(f, fh, xi, max_iters=512):
    topo = jfixes.field_topology(jnp.asarray(f), xi)
    g, it, ok = jfixes.fused_fix(jnp.asarray(fh), topo, max_iters=max_iters,
                                 backend="reference")
    return np.asarray(g), int(it), bool(ok)


def port_topo(f, xi):
    return tfixes.field_topology(torch.from_numpy(f), xi)


@pytest.mark.parametrize("case", sorted(CASES))
def test_worklist_matches_reference(case):
    f, fh, xi = CASES[case]()
    g, it, ok, skipped = reference_worklist(f, fh, xi)
    spans0 = tbackend.worklist_spans
    tg, tit, tok, tskipped = tfixes.fused_fix_worklist(
        torch.from_numpy(fh), port_topo(f, xi))
    assert np.array_equal(tg.numpy(), g)
    assert (tit, tok, tskipped) == (it, ok, skipped)
    assert ok and tbackend.worklist_spans - spans0 >= tit
    if case == "localized":
        assert tskipped > 0           # the worklist really skipped groups
    # the dense loop gives the same g and iterations
    dg, dit, dok = tfixes.fused_fix(torch.from_numpy(fh), port_topo(f, xi),
                                    backend="reference")
    assert torch.equal(dg, tg) and (dit, dok) == (tit, tok)


@pytest.mark.parametrize("shape", [(40, 9), (40, 6, 7)])
def test_worklist_equals_the_reference_dense_loop(shape):
    """2D slabs are rows; a run cut at ``max_iters`` stops where the
    dense loop stops, unconverged."""
    f, fh, xi = localized_pair(shape, 0.25)
    g, it, ok = reference_dense(f, fh, xi)
    tg, tit, tok, tskipped = tfixes.fused_fix_worklist(
        torch.from_numpy(fh), port_topo(f, xi))
    assert np.array_equal(tg.numpy(), g) and (tit, tok) == (it, ok)
    assert ok and tskipped > 0
    cap = it - 1
    g, it, ok = reference_dense(f, fh, xi, max_iters=cap)
    tg, tit, tok, tskipped_cut = tfixes.fused_fix_worklist(
        torch.from_numpy(fh), port_topo(f, xi), max_iters=cap)
    assert np.array_equal(tg.numpy(), g)
    assert (tit, tok) == (it, ok) == (cap, False)
    assert 0 < tskipped_cut <= tskipped


STRATEGIES = [
    "cuda", "cuda_tiled", "cuda_worklist",
    CudaBackend(worklist=True), CudaBackend(worklist=False),
    CudaBackend(worklist=True, worklist_group=1),
    CudaBackend(z_tile=1), CudaBackend(z_tile=3),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(70, 5, 6), (80, 9), (13, 4, 5)])
def test_fused_fix_strategies_equal_the_dense_loop(shape, dtype):
    rng = np.random.default_rng(3)
    f = rng.normal(size=shape).astype(dtype)
    xi = 0.3
    fh = (f + rng.uniform(-xi, xi, shape) * 0.999).astype(dtype)
    topo = port_topo(f, xi)
    want = tfixes.fused_fix(torch.from_numpy(fh), topo, backend="reference")
    # the reference's dense loop agrees (f32 only: x64 is not needed here)
    if dtype == np.float32:
        jg, jit, jok = jfixes.fused_fix(
            jnp.asarray(fh), jfixes.field_topology(jnp.asarray(f), xi),
            backend="reference")
        assert np.array_equal(np.asarray(jg), want[0].numpy())
        assert (int(jit), bool(jok)) == want[1:]
    for be in STRATEGIES:
        g, it, ok = tfixes.fused_fix(torch.from_numpy(fh), topo, backend=be)
        assert torch.equal(g, want[0]), be
        assert (it, ok) == want[1:], be


def test_auto_takes_the_worklist_where_the_reference_does():
    f, fh, xi = localized_pair((64, 5, 6))
    be = get_backend("cuda")
    assert be.use_worklist(f.shape) == PallasBackend().use_worklist(f.shape)
    spans0 = tbackend.worklist_spans
    g, it, ok = tfixes.fused_fix(torch.from_numpy(fh), port_topo(f, xi),
                                 backend="cuda")
    assert tbackend.worklist_spans > spans0      # the worklist ran
    spans1 = tbackend.worklist_spans
    dense = dataclasses.replace(be, worklist=False)
    dg, dit, dok = tfixes.fused_fix(torch.from_numpy(fh), port_topo(f, xi),
                                    backend=dense)
    assert tbackend.worklist_spans == spans1     # the dense loop did not
    assert torch.equal(g, dg) and (it, ok) == (dit, dok)


@pytest.mark.parametrize("make", [PallasBackend, CudaBackend])
def test_use_worklist_policy(make):
    be_auto = make()
    assert not be_auto.use_worklist((8, 8, 8))          # under the floor
    assert be_auto.use_worklist((be_auto.worklist_min_slabs, 8, 8))
    assert be_auto.use_worklist((be_auto.worklist_min_slabs, 8))
    assert not be_auto.use_worklist((be_auto.worklist_min_slabs,))
    be_on = make(worklist=True)
    assert be_on.use_worklist((4, 8, 8))
    assert not be_on.use_worklist((1, 8, 8))            # degenerate depth
    be_off = make(worklist=False)
    assert not be_off.use_worklist((256, 8, 8))
    assert (make().worklist_group, make().worklist_min_slabs) == (8, 64)


def test_registered_variants_match_the_reference():
    assert get_backend("cuda_tiled").z_tile == 8
    wl = get_backend("cuda_worklist")
    assert (wl.worklist, wl.worklist_group) == (True, 4)
    assert not hasattr(get_backend("reference"), "worklist_loop")


def test_fused_fix_worklist_rejects_plain_backends():
    f, fh, xi = localized_pair((12, 6, 7))
    with pytest.raises(ValueError, match="worklist"):
        tfixes.fused_fix_worklist(torch.from_numpy(fh), port_topo(f, xi),
                                  backend="reference")
