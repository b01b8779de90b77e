"""The port's fused fix loop against ``repro.core.fixes.fused_fix``
(backend="reference"), bitwise: the corrected field g, the iteration
count and the convergence flag, for both port backends (on the CPU the
``cuda`` backend runs each kernel's plain version), including a run cut
off at ``max_iters``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixes as jfixes
from _torch_threads import one_thread  # noqa: F401
from repro_torch.convert import topo_from_numpy
from repro_torch.core import driver as tdriver, fixes as tfixes


def make_case(shape, kind, dtype, seed=0):
    """(f, f_hat, xi): f_hat is f perturbed inside the bound."""
    rng = np.random.default_rng(seed)
    if kind == "constant":
        f = np.full(shape, 2.0)
    elif kind == "single":
        f = np.zeros(shape)
        f[tuple(s // 2 for s in shape)] = 1.0
    else:
        f = rng.normal(size=shape)
        if kind == "ties":
            f = np.round(f * 2) / 2
    xi = 0.4 if kind == "noise" else 0.2
    f_hat = f + rng.uniform(-xi, xi, size=shape)
    return f.astype(dtype), f_hat.astype(dtype), xi


def run_reference(f, f_hat, xi, max_iters):
    with jax.enable_x64(f.dtype == np.float64):
        topo = jfixes.field_topology(jnp.asarray(f), xi)
        g, iters, ok = jfixes.fused_fix(jnp.asarray(f_hat), topo,
                                        max_iters=max_iters,
                                        backend="reference")
        topo_np = {k: np.asarray(v) for k, v in topo._asdict().items()}
        return np.asarray(g), int(iters), bool(ok), topo_np


CASES = [((6, 5, 7), "noise", np.float32), ((5, 7, 4), "ties", np.float64),
         ((4, 4, 4), "constant", np.float32), ((5, 5, 5), "single", np.float64),
         ((13, 9), "noise", np.float64), ((11, 14), "ties", np.float32)]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("shape,kind,dtype", CASES)
def test_fused_fix_matches_reference(shape, kind, dtype, backend):
    f, f_hat, xi = make_case(shape, kind, dtype)
    g, iters, ok, topo_np = run_reference(f, f_hat, xi, 512)
    topo = tfixes.field_topology(torch.from_numpy(f), xi)
    for name, want in topo_np.items():
        assert np.array_equal(getattr(topo, name).numpy(), want), name
    tg, titers, tok = tfixes.fused_fix(torch.from_numpy(f_hat), topo,
                                       backend=backend)
    assert np.array_equal(tg.numpy(), g)
    assert (titers, tok) == (iters, ok)
    # identical topology handed across gives the identical trajectory
    tg2, titers2, _ = tfixes.fused_fix(torch.from_numpy(f_hat),
                                       topo_from_numpy(topo_np, "cpu"),
                                       backend=backend)
    assert torch.equal(tg2, tg) and titers2 == titers


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_max_iters_exhaustion_matches(max_iters):
    f, f_hat, xi = make_case((7, 6, 8), "noise", np.float32, seed=3)
    g, iters, ok, _ = run_reference(f, f_hat, xi, max_iters)
    assert not ok and iters == max_iters      # the cut actually happens
    topo = tfixes.field_topology(torch.from_numpy(f), xi)
    for backend in ("reference", "cuda"):
        tg, titers, tok = tfixes.fused_fix(torch.from_numpy(f_hat), topo,
                                           max_iters=max_iters,
                                           backend=backend)
        assert np.array_equal(tg.numpy(), g)
        assert (titers, tok) == (iters, ok)


def test_derive_edits_matches_reference():
    from repro.core import derive_edits as j_derive_edits
    f, f_hat, xi = make_case((6, 7, 5), "noise", np.float32, seed=4)
    want = j_derive_edits(f, f_hat, xi, backend="reference")
    got = tdriver.derive_edits(f, f_hat, xi, device="cpu")
    assert np.array_equal(got.g, want.g)
    assert np.array_equal(got.edits_idx, want.edits_idx)
    assert np.array_equal(got.edits_val, want.edits_val)
    assert (got.iters, got.converged, got.edit_ratio, got.max_abs_err) == \
        (want.iters, want.converged, want.edit_ratio, want.max_abs_err)
    # paper mode is served too, bitwise the reference's
    want_p = j_derive_edits(f, f_hat, xi, mode="paper", backend="reference")
    got_p = tdriver.derive_edits(f, f_hat, xi, mode="paper", device="cpu")
    assert np.array_equal(got_p.g, want_p.g)
    assert np.array_equal(got_p.edits_idx, want_p.edits_idx)
    assert (got_p.iters, got_p.converged, got_p.backend) == \
        (want_p.iters, want_p.converged, want_p.backend)


def test_extract_and_apply_edits_match():
    from repro.core.driver import apply_edits_device as j_apply_dev
    from repro.core.driver import extract_edits as j_extract
    rng = np.random.default_rng(5)
    f_hat = rng.normal(size=(5, 6, 7)).astype(np.float32)
    g = f_hat.copy()
    g.reshape(-1)[[3, 17, 18, 100, 209]] -= 0.125
    idx, val = tdriver.extract_edits(torch.from_numpy(f_hat),
                                     torch.from_numpy(g))
    jidx, jval = j_extract(jnp.asarray(f_hat), jnp.asarray(g))
    assert idx.dtype == torch.int32
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(val.numpy(), np.asarray(jval))
    # padding one past the end (and beyond) drops, never wraps
    pad_idx = np.concatenate([idx.numpy(), [f_hat.size, f_hat.size + 5]])
    pad_val = np.concatenate([val.numpy(), [7.0, 9.0]]).astype(np.float32)
    got = tdriver.apply_edits_device(torch.from_numpy(f_hat),
                                     torch.from_numpy(pad_idx),
                                     torch.from_numpy(pad_val))
    want = np.asarray(j_apply_dev(jnp.asarray(f_hat),
                                  pad_idx.astype(np.int32), pad_val))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), g)
    # the host apply accumulates duplicates as np.add.at does
    dup = tdriver.apply_edits(f_hat, np.array([4, 4, 2]),
                              np.array([1.0, 2.0, 3.0], np.float32))
    ref = f_hat.copy()
    np.add.at(ref.reshape(-1), np.array([4, 4, 2]),
              np.array([1.0, 2.0, 3.0], np.float32))
    assert np.array_equal(dup, ref)
