"""The port's paper-mode fix loop against ``repro.core.fixes.paper_fix``,
bitwise: the corrected field g, the outer iteration count and the
convergence flag, in 2D/3D, f32/f64 (the reference under x64), on
fields whose FPmin sub-loop runs (the fpmin deviation from Eq. 3), with
a run cut off at ``max_iters``; and ``derive_edits(mode="paper")`` and
``compress_preserving_mss(mode="paper")`` against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import pipeline as jpipe
from repro.core import driver as jdriver, fixes as jfixes
from repro.data import synthetic_field
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import pipeline as tpipe
from repro_torch.core import driver as tdriver, fixes as tfixes

KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic", "version")


def make_case(shape, kind, dtype, seed):
    """(f, f_hat, xi): f_hat is f perturbed inside the bound."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape)
    if kind == "ties":
        f = np.round(f * 2) / 2
    xi = 0.4
    f_hat = f + rng.uniform(-xi, xi, size=shape)
    return f.astype(dtype), f_hat.astype(dtype), xi


CASES = [((6, 7, 5), "noise", np.float32, 0),
         ((6, 7, 5), "ties", np.float32, 2),
         ((9, 11), "ties", np.float32, 1),
         ((16, 18), "noise", np.float32, 0),
         ((5, 6, 7), "ties", np.float64, 1),
         ((16, 18), "ties", np.float64, 0),
         ((9, 11), "noise", np.float64, 1)]


@pytest.mark.parametrize("shape,kind,dtype,seed", CASES)
def test_paper_fix_is_bitwise_the_reference(shape, kind, dtype, seed,
                                            monkeypatch):
    f, f_hat, xi = make_case(shape, kind, dtype, seed)
    with jax.enable_x64(dtype == np.float64):
        jtopo = jfixes.field_topology(jnp.asarray(f), xi)
        g_r, it_r, ok_r = jfixes.paper_fix(jnp.asarray(f_hat), jtopo)
        g_r, it_r, ok_r = np.asarray(g_r), int(it_r), bool(ok_r)
    steps = []
    sub = tfixes._subloop

    def recording(g, topo, which, max_iters):
        g2, it = sub(g, topo, which, max_iters)
        steps.append((which, it))
        return g2, it

    monkeypatch.setattr(tfixes, "_subloop", recording)
    ttopo = tfixes.field_topology(torch.from_numpy(f), xi)
    g, it, ok = tfixes.paper_fix(torch.from_numpy(f_hat), ttopo)
    assert g.dtype == (torch.float64 if dtype == np.float64
                       else torch.float32)
    assert np.array_equal(g.numpy(), g_r)
    assert (it, ok) == (it_r, ok_r) and ok
    # the FPmin sub-loop (the deviation from Eq. 3) took steps
    assert sum(n for which, n in steps if which == "fpmin") > 0


@pytest.mark.parametrize("max_iters", [1, 2])
def test_paper_fix_cut_off_at_max_iters(max_iters):
    f, f_hat, xi = make_case((6, 7, 5), "ties", np.float32, 2)
    jtopo = jfixes.field_topology(jnp.asarray(f), xi)
    g_r, it_r, ok_r = jfixes.paper_fix(jnp.asarray(f_hat), jtopo,
                                       max_iters=max_iters)
    ttopo = tfixes.field_topology(torch.from_numpy(f), xi)
    g, it, ok = tfixes.paper_fix(torch.from_numpy(f_hat), ttopo,
                                 max_iters=max_iters)
    assert np.array_equal(g.numpy(), np.asarray(g_r))
    assert (it, ok) == (int(it_r), bool(ok_r))
    assert it == max_iters and not ok


@pytest.mark.parametrize("shape,kind,dtype,seed", CASES[:4])
def test_derive_edits_paper_is_the_references(shape, kind, dtype, seed):
    f, f_hat, xi = make_case(shape, kind, dtype, seed)
    want = jdriver.derive_edits(f, f_hat, xi, mode="paper")
    got = tdriver.derive_edits(f, f_hat, xi, mode="paper", device="cpu")
    assert np.array_equal(got.g, want.g)
    assert np.array_equal(got.edits_idx, want.edits_idx)
    assert np.array_equal(got.edits_val, want.edits_val)
    assert (got.iters, got.converged, got.edit_ratio, got.max_abs_err,
            got.backend) == (want.iters, want.converged, want.edit_ratio,
                             want.max_abs_err, want.backend)
    with pytest.raises(ValueError, match="unknown mode"):
        tdriver.derive_edits(f, f_hat, xi, mode="eager", device="cpu")


@pytest.mark.parametrize("codec", ["szlike", "zfplike"])
@pytest.mark.parametrize("shape,dtype", [((12, 14, 10), np.float32),
                                         ((24, 30), np.float64)])
def test_compress_paper_mode_is_the_references(codec, shape, dtype):
    name = "nyx" if len(shape) == 3 else "climate"
    f = synthetic_field(name, shape).astype(dtype)
    xi = 1e-3 * float(np.ptp(f))
    with jax.enable_x64(dtype == np.float64):
        ref = jpipe.compress_preserving_mss(f, xi, codec=codec, mode="paper")
        g_ref = jpipe.decompress_preserving_mss(ref)
    art = tpipe.compress_preserving_mss(f, xi, codec=codec, mode="paper",
                                        device="cpu")
    assert art.path == "host" and art.backend == "reference"
    for k in KEYS:
        assert getattr(art, k) == getattr(ref, k), k
    assert np.array_equal(tpipe.decompress_preserving_mss(art, device="cpu"),
                          g_ref)
    with pytest.raises(ValueError) as want:
        jpipe.compress_preserving_mss(f, xi, codec=codec, mode="paper",
                                      device_path=True)
    with pytest.raises(ValueError) as got:
        tpipe.compress_preserving_mss(f, xi, codec=codec, mode="paper",
                                      device_path=True, device="cpu")
    assert str(got.value) == str(want.value)
