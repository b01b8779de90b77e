"""The port's three kernel modules against the Pallas kernels they
replace, bitwise, one block per kernel.

On the CPU each wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it), against the port's ``ReferenceBackend``, and on a tile of a
larger field placed at a non-zero origin; the fix pass also on dense
adversarial inputs (every pull direction busy). The CUDA kernel itself
is held against its plain version by the tests that need a GPU (skipped
without one) and by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mss_labels, self_code, steepest_dirs
from repro.kernels.extrema import extrema_masks_pallas
from repro.kernels.fixpass import fix_pass_pallas
from repro.kernels.lorenzo import lorenzo_quant_pallas
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import szlike
from repro_torch.convert import topo_from_numpy
from repro_torch.core import backend as tbackend
from repro_torch.core import fixes as tfixes
from repro_torch.kernels import _build
from repro_torch.kernels import extrema as kx, fixpass as kf, lorenzo as kl

CASES = [((5, 6, 7), np.float32), ((6, 4, 9), np.float64),
         ((9, 11), np.float32), ((7, 12), np.float64)]


def setup(shape, dtype, seed=0, xi=0.3, ties=False):
    """f, g and the original field's topology as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape)
    if ties:
        f = np.round(f * 2) / 2
    f = f.astype(dtype)
    g = (f + rng.uniform(-xi, xi, size=shape)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        up, dn = steepest_dirs(jnp.asarray(f))
        M, m = mss_labels(jnp.asarray(f))
        sc = self_code(len(shape))
        topo = dict(up_c=np.asarray(up), dn_c=np.asarray(dn),
                    is_max=np.asarray(up) == sc, is_min=np.asarray(dn) == sc,
                    M=np.asarray(M), m=np.asarray(m),
                    lower=(f - np.asarray(xi, dtype)).astype(dtype))
    return f, g, topo


def t(x):
    return torch.from_numpy(np.array(x))


def pallas_extrema(g, topo):
    with jax.enable_x64(g.dtype == np.float64):
        out = extrema_masks_pallas(
            jnp.asarray(g), jnp.asarray(topo["M"]), jnp.asarray(topo["m"]),
            jnp.asarray(topo["is_max"].astype(np.int32)),
            jnp.asarray(topo["is_min"].astype(np.int32)), interpret=True)
        return [np.asarray(o) for o in out]


def pallas_fixpass(g, topo, masks):
    with jax.enable_x64(g.dtype == np.float64):
        out = fix_pass_pallas(
            jnp.asarray(g), jnp.asarray(topo["lower"]),
            *[jnp.asarray(x) for x in (masks[2], masks[3], masks[4],
                                       masks[0], topo["dn_c"])],
            interpret=True)
        return [np.asarray(o) for o in out]


# --- extrema ---------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_extrema_plain_matches_pallas_and_reference(shape, dtype, ties):
    f, g, topo = setup(shape, dtype, ties=ties)
    want = pallas_extrema(g, topo)
    got = kx.extrema_masks(t(g), t(topo["M"]), t(topo["m"]),
                           t(topo["is_max"]), t(topo["is_min"]))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    # int32 masks, as the Pallas kernel takes them, give the same bits
    got32 = kx.extrema_masks(t(g), t(topo["M"]), t(topo["m"]),
                             t(topo["is_max"].astype(np.int32)),
                             t(topo["is_min"].astype(np.int32)))
    assert all(torch.equal(a, b) for a, b in zip(got, got32))
    ref = tbackend.ReferenceBackend().extrema_masks(
        t(g), topo_from_numpy(topo, "cpu"))
    for a, b in zip(ref[:5], got):
        assert torch.equal(a.to(torch.int32), b)


@pytest.mark.parametrize("shape,tile", [
    ((8, 9, 10), (2, 7, 1, 8, 2, 9)),
    ((12, 15), (3, 10, 0, 0, 4, 13)),
])
def test_extrema_tile_origin_matches_untiled(shape, tile):
    f, g, topo = setup(shape, np.float32, seed=5, ties=True)
    want = pallas_extrema(g, topo)
    z0, z1, y0, y1, x0, x1 = tile
    if len(shape) == 3:
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        kw = dict(slab_lo=z0, row_lo=y0, col_lo=x0, n_slabs_total=shape[0],
                  n_rows_total=shape[1], n_cols_total=shape[2])
        inner = (slice(1, -1),) * 3
    else:
        sl = (slice(z0, z1), slice(x0, x1))
        kw = dict(slab_lo=z0, col_lo=x0, n_slabs_total=shape[0],
                  n_cols_total=shape[1])
        inner = (slice(1, -1),) * 2
    got = kx.extrema_masks(*[t(a[sl]) for a in (
        g, topo["M"], topo["m"], topo["is_max"], topo["is_min"])], **kw)
    for a, b in zip(got, want):
        # vertices whose stencil lies inside the tile are exact
        assert np.array_equal(a.numpy()[inner], b[sl][inner])


# --- fix pass --------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,dtype", CASES)
def test_fixpass_plain_matches_pallas_and_reference(shape, dtype, ties):
    f, g, topo = setup(shape, dtype, seed=1, ties=ties)
    masks = pallas_extrema(g, topo)
    want = pallas_fixpass(g, topo, masks)
    got = kf.fix_pass(t(g), t(topo["lower"]),
                      *[t(x) for x in (masks[2], masks[3], masks[4],
                                       masks[0], topo["dn_c"])])
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(b).dtype
        assert np.array_equal(a.numpy(), b)
    tt = topo_from_numpy(topo, "cpu")
    be = tbackend.ReferenceBackend()
    g_ref, viol_ref = be.fix_pass(t(g), tt, be.extrema_masks(t(g), tt))
    assert torch.equal(g_ref, got[0])
    assert int(viol_ref) == int(got[1].sum())


def test_fixpass_tile_origin_matches_untiled():
    shape = (9, 8, 11)
    f, g, topo = setup(shape, np.float32, seed=2)
    masks = pallas_extrema(g, topo)
    want = pallas_fixpass(g, topo, masks)
    sl = (slice(2, 8), slice(1, 7), slice(3, 10))
    ins = [x[sl] for x in (g, topo["lower"], masks[2], masks[3], masks[4],
                           masks[0], topo["dn_c"])]
    g2, viol, tgt = kf.fix_pass(*[t(x) for x in ins], slab_lo=2, row_lo=1,
                                col_lo=3, n_slabs_total=9, n_rows_total=8,
                                n_cols_total=11)
    inner = (slice(1, -1),) * 3
    assert np.array_equal(g2.numpy()[inner], want[0][sl][inner])


#: dense fix-pass cases: f32 and f64, 3D and 2D, degenerate planes
DENSE_CASES = [((5, 6, 7), np.float32), ((6, 4, 9), np.float64),
               ((3, 1, 5), np.float32), ((2, 2, 2), np.float64),
               ((9, 11), np.float32), ((7, 12), np.float64),
               ((1, 7), np.float32)]


def dense_fix_inputs(shape, dtype, seed):
    """Fix-pass inputs with every pull direction busy: self_edit,
    demote_src and promote_src 0/1 at 50 %, codes uniform in [-1, K),
    lower above g at about a sixth of the vertices."""
    rng = np.random.default_rng(seed)
    n_dirs = 14 if len(shape) == 3 else 6
    g = rng.normal(size=shape).astype(dtype)
    lower = (g + rng.uniform(-1.0, 0.2, size=shape)).astype(dtype)
    masks = [(rng.random(shape) < 0.5).astype(np.int32) for _ in range(3)]
    codes = [rng.integers(-1, n_dirs, size=shape).astype(np.int32)
             for _ in range(2)]
    return [g, lower, *masks, *codes]


def pallas_fixpass_on(ins, **kw):
    with jax.enable_x64(ins[0].dtype == np.float64):
        out = fix_pass_pallas(*[jnp.asarray(x) for x in ins],
                              interpret=True, **kw)
        return [np.asarray(o) for o in out]


@pytest.mark.parametrize("shape,dtype", DENSE_CASES)
def test_fixpass_plain_matches_pallas_on_dense_inputs(shape, dtype):
    ins = dense_fix_inputs(shape, dtype, seed=sum(shape))
    want = pallas_fixpass_on(ins)
    got = kf.fix_pass(*[t(x) for x in ins])
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(b).dtype
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape,tile", [
    ((9, 8, 11), (2, 8, 1, 7, 3, 10)),
    ((12, 15), (3, 10, 0, 0, 4, 13)),
])
def test_fixpass_dense_tile_origin_matches_pallas(shape, tile):
    ins = dense_fix_inputs(shape, np.float32, seed=7)
    z0, z1, y0, y1, x0, x1 = tile
    if len(shape) == 3:
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        kw = dict(slab_lo=z0, row_lo=y0, col_lo=x0, n_slabs_total=shape[0],
                  n_rows_total=shape[1], n_cols_total=shape[2])
    else:
        sl = (slice(z0, z1), slice(x0, x1))
        kw = dict(slab_lo=z0, col_lo=x0, n_slabs_total=shape[0],
                  n_cols_total=shape[1])
    sub = [np.ascontiguousarray(x[sl]) for x in ins]
    want = pallas_fixpass_on(sub, **kw)
    g2, viol, tgt = (x.numpy() for x in kf.fix_pass(*[t(x) for x in sub],
                                                       **kw))
    # the Pallas kernel fills the halo slab of a tile's first and last slab
    # from the tile itself (ghost data its caller supplies); the port pulls
    # nothing from outside the tile. Every other slab, row and column edge
    # included, is the same bit for bit, and so are all source counts.
    assert np.array_equal(g2[1:-1], want[0][1:-1])
    assert np.array_equal(tgt[1:-1], want[2][1:-1])
    assert np.array_equal(viol, want[1])


# --- Lorenzo ---------------------------------------------------------------

#: the degenerate shapes of the dense fix-pass cases, beside CASES
LORENZO_DEGENERATE = [((3, 1, 5), np.float32), ((2, 2, 2), np.float64),
                      ((1, 7), np.float32), ((5, 4), np.float64),
                      ((9, 1, 64), np.float32)]


@pytest.mark.parametrize("shape,dtype", CASES + LORENZO_DEGENERATE)
def test_lorenzo_plain_matches_pallas(shape, dtype):
    f, _, _ = setup(shape, dtype, seed=3)
    f = (f * 50).astype(dtype)
    f.reshape(-1)[:4] = np.array([0.5, 1.5, -2.5, 2.5], dtype)   # exact ties
    step = np.asarray(1.0, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(lorenzo_quant_pallas(jnp.asarray(f), step,
                                               interpret=True))
    got = kl.lorenzo_quant(t(f), t(step))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    ref = tbackend.ReferenceBackend().transform(t(f), t(step))
    assert torch.equal(ref, got)


@pytest.mark.parametrize("shape", [(9, 5, 6), (10, 7)])
def test_lorenzo_tile_origin(shape):
    f, _, _ = setup(shape, np.float32, seed=4)
    step = np.asarray(0.05, np.float32)
    full = np.asarray(lorenzo_quant_pallas(jnp.asarray(f), step,
                                           interpret=True))
    tile = np.asarray(lorenzo_quant_pallas(jnp.asarray(f[3:]), step,
                                           interpret=True, slab_lo=3))
    got = kl.lorenzo_quant(t(f[3:]), t(step), slab_lo=3).numpy()
    # slab 0 of a tile needs the slab before it; the rest is exact
    assert np.array_equal(got[1:], full[4:])
    assert np.array_equal(got[1:], tile[1:])
    # at the true domain edge (slab_lo=0 on the first slab) it is exact too
    assert np.array_equal(kl.lorenzo_quant(t(f), t(step)).numpy(), full)


@pytest.mark.parametrize("shape", [(6, 5, 7), (9, 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lorenzo_at_range_limit_matches_pallas(shape, dtype):
    """max|f| / xi just under ``check_int32_range``'s limit (2^21 in f32,
    2^28 in f64), at the step the compressor uses: the quotients reach
    2^20 / 2^27 and the residuals several times that, bitwise."""
    rng = np.random.default_rng(len(shape))
    xi = 0.75
    amax = 0.999 * szlike.device_range_limit(dtype) * xi
    f = rng.uniform(-amax, amax, size=shape).astype(dtype)
    f.reshape(-1)[0] = -amax
    szlike.check_int32_range(f, xi)
    step = np.asarray(szlike.effective_step(f, xi), dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(lorenzo_quant_pallas(jnp.asarray(f), step,
                                               interpret=True))
    got = kl.lorenzo_quant(t(f), t(step)).numpy()
    assert np.array_equal(got, want)
    assert np.abs(got).max() > 0.4 * amax / float(step)


def test_lorenzo_rejects_python_float_step():
    with pytest.raises(TypeError, match="scalar tensor"):
        kl.lorenzo_quant(t(np.ones((3, 4), np.float32)),
                         torch.tensor(1.0, dtype=torch.float64))


# --- the kernels themselves (need a GPU) -----------------------------------

def test_wrappers_count_no_launch_on_cpu():
    before = (kx.launches, kf.launches, kl.launches)
    f, g, topo = setup((4, 5, 6), np.float32)
    kx.extrema_masks(t(g), t(topo["M"]), t(topo["m"]), t(topo["is_max"]),
                     t(topo["is_min"]))
    kl.lorenzo_quant(t(f), torch.tensor(0.1))
    assert (kx.launches, kf.launches, kl.launches) == before


def test_build_flags_keep_ieee_arithmetic():
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SOURCES)


@pytest.mark.parametrize("shape,dtype", [((37, 45, 61), np.float32),
                                         ((37, 45, 61), np.float64),
                                         ((123, 257), np.float32)])
def test_cuda_kernels_match_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    f, g, topo = setup(shape, dtype, seed=6, ties=True)
    tt = topo_from_numpy(topo, "cuda")
    gt = t(g).cuda()
    geo = kx.geometry(shape)
    ext = (gt, tt.M, tt.m, tt.is_max, tt.is_min)
    got = kx.extrema_masks(*ext)
    assert all(torch.equal(a, b) for a, b in
               zip(got, kx.extrema_masks_plain(*ext, geo)))
    fix = (gt, tt.lower, got[2], got[3], got[4], got[0], tt.dn_c)
    assert all(torch.equal(a, b) for a, b in
               zip(kf.fix_pass(*fix), kf.fix_pass_plain(*fix, geo)))
    step = torch.tensor(0.01, dtype=gt.dtype, device="cuda")
    assert torch.equal(kl.lorenzo_quant(gt, step),
                       kl.lorenzo_quant_plain(gt, step, geo))
    g1, it1, ok1 = tfixes.fused_fix(gt, tt, backend="cuda")
    g2, it2, ok2 = tfixes.fused_fix(gt, tt, backend="reference")
    assert torch.equal(g1, g2) and (it1, ok1) == (it2, ok2)
