"""The port's zfplike codec against ``repro.compress.zfplike``, byte for
byte: ZFJ2 blobs and their decodes in 2D/3D, f32/f64, shapes off the
4-block grid, the empty field and ``xi = 0``; the refusals; and whole
``codec="zfplike"`` artifacts (solo and batch, f64 under x64) against
the reference's pipeline, with the arguments zfplike does not take."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.compress import pipeline as jpipe, zfplike as jzfp
from repro.data import synthetic_field
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import pipeline as tpipe, zfplike as tzfp
from repro_torch.convert import artifact_from_dict

KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic", "version")

BLOB_CASES = [
    ((16, 20), np.float32, 1e-3),
    ((13, 22), np.float32, 1e-2),
    ((8, 12, 16), np.float32, 1e-3),
    ((7, 9, 10), np.float32, 1e-4),
    ((13, 22), np.float64, 1e-3),
    ((7, 9, 10), np.float64, 1e-6),
    ((5, 6), np.float64, 0.0),
    ((6, 5, 7), np.float32, 0.0),
    ((1, 3), np.float32, 1e-2),
]


def _field(shape, dtype, seed=0):
    name = "nyx" if len(shape) == 3 else "climate"
    return synthetic_field(name, shape, seed=seed).astype(dtype)


@pytest.mark.parametrize("shape,dtype,rel", BLOB_CASES)
def test_blob_and_decode_are_the_references(shape, dtype, rel):
    f = _field(shape, dtype)
    xi = rel * float(np.ptp(f))
    blob = tzfp.zfp_compress(f, xi)
    assert blob == jzfp.zfp_compress(f, xi)
    assert blob[:4] == b"ZFJ2"
    got, want = tzfp.zfp_decompress(blob), jzfp.zfp_decompress(blob)
    assert got.dtype == want.dtype == dtype
    assert np.array_equal(got, want)
    g2, n = tzfp.zfp_roundtrip(f, xi)
    assert n == len(blob) and np.array_equal(g2, got)
    if xi > 0:
        assert float(np.max(np.abs(f.astype(np.float64) - got))) <= xi


@pytest.mark.parametrize("shape,dtype", [((0, 5), np.float32),
                                         ((3, 0, 4), np.float64)])
def test_empty_field(shape, dtype):
    f = np.zeros(shape, dtype)
    blob = tzfp.zfp_compress(f, 1e-3)
    assert blob == jzfp.zfp_compress(f, 1e-3)
    out = tzfp.zfp_decompress(blob)
    assert out.shape == shape and out.dtype == dtype


@pytest.mark.parametrize("ndim", [2, 3])
def test_transform_constants_are_the_references(ndim):
    assert tzfp._inverse_gain(ndim) == jzfp._inverse_gain(ndim)
    assert tzfp._lift_slack(ndim) == jzfp._lift_slack(ndim)
    rng = np.random.default_rng(ndim)
    x = rng.integers(-(1 << 20), 1 << 20, size=(4,) * ndim).astype(np.int64)
    for ax in range(ndim):
        assert np.array_equal(tzfp._fwd_lift_np(x, ax),
                              jzfp._fwd_lift_np(x, ax))
        assert np.array_equal(tzfp._inv_lift_np(x, ax),
                              jzfp._inv_lift_np(x, ax))
    f = _field((5, 7, 9)[:ndim], np.float64)
    bt, pt = tzfp._blockify(f)
    bj, pj = jzfp._blockify(f)
    assert pt == pj and np.array_equal(bt, bj)


def test_refusals_raise_what_the_reference_raises():
    f = _field((8, 8), np.float32)
    for mod in (tzfp, jzfp):
        with pytest.raises(ValueError, match="non-negative"):
            mod.zfp_compress(f, -1.0)
        with pytest.raises(ValueError, match="2D/3D"):
            mod.zfp_compress(np.zeros(8, np.float32), 0.1)
        with pytest.raises(TypeError, match="float field"):
            mod.zfp_compress(np.zeros((4, 4), np.int32), 0.1)
    blob = tzfp.zfp_compress(f, 1e-2)
    for bad, err in ((b"ZFJ1" + blob[4:], "refusing retired 'ZFJ1'"),
                     (b"XXXX" + blob[4:], "not a ZFP-like blob")):
        with pytest.raises(ValueError) as want:
            jzfp.zfp_decompress(bad)
        with pytest.raises(ValueError, match=err) as got:
            tzfp.zfp_decompress(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,dtype", [((12, 14, 10), np.float32),
                                         ((24, 30), np.float32),
                                         ((10, 12, 9), np.float64),
                                         ((20, 26), np.float64)])
def test_artifact_is_the_references(shape, dtype):
    f = _field(shape, dtype)
    xi = 1e-3 * float(np.ptp(f))
    with jax.enable_x64(dtype == np.float64):
        ref = jpipe.compress_preserving_mss(f, xi, codec="zfplike",
                                            backend="reference")
        g_ref = jpipe.decompress_preserving_mss(ref)
    arts = [tpipe.compress_preserving_mss(f, xi, device="cpu", backend=be,
                                          codec="zfplike")
            for be in ("reference", "cuda")]
    for art in arts:
        assert art.path == "host" and art.base == "zfplike"
        for k in KEYS:
            assert getattr(art, k) == getattr(ref, k), k
    g = tpipe.decompress_preserving_mss(arts[0], device="cpu")
    assert g.dtype == dtype and np.array_equal(g, g_ref)
    assert np.array_equal(tpipe.decompress_artifact(arts[0]), g_ref)
    # the reference's artifact decodes in the port to the same g
    g_x = tpipe.decompress_preserving_mss(
        artifact_from_dict(dataclasses.asdict(ref)), device="cpu")
    assert np.array_equal(g_x, g_ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batch_is_the_references(dtype):
    fields = [_field((10, 11, 12), dtype, seed=s) for s in range(3)]
    xis = [c * float(np.ptp(f)) for c, f in zip((1e-2, 1e-3, 3e-3), fields)]
    with jax.enable_x64(dtype == np.float64):
        refs = jpipe.compress_preserving_mss_batch(
            fields, xis, codec="zfplike", backend="reference")
    arts = tpipe.compress_preserving_mss_batch(fields, xis, codec="zfplike",
                                               device="cpu")
    solo = [tpipe.compress_preserving_mss(f, x, codec="zfplike",
                                          device="cpu")
            for f, x in zip(fields, xis)]
    for a, r, s_ in zip(arts, refs, solo):
        for k in KEYS:
            assert getattr(a, k) == getattr(r, k) == getattr(s_, k), k
    gs = tpipe.decompress_artifact_batch(arts, device="cpu")
    for g, a in zip(gs, arts):
        assert np.array_equal(g, tpipe.decompress_artifact(a))
    with pytest.raises(ValueError, match="device_path=True"):
        tpipe.decompress_artifact_batch(arts, device_path=True,
                                        device="cpu")


def test_xi_zero_and_negative_follow_the_reference():
    # xi = 0 is accepted: a field the block transform round-trips
    # exactly compresses; any other breaks the bound before editing
    exact = np.zeros((12, 16), np.float32)
    exact[3:9, 4:12] = 2.0
    ref = jpipe.compress_preserving_mss(exact, 0.0, codec="zfplike",
                                        backend="reference")
    art = tpipe.compress_preserving_mss(exact, 0.0, codec="zfplike",
                                        device="cpu")
    for k in KEYS:
        assert getattr(art, k) == getattr(ref, k), k
    f = _field((12, 16), np.float32)
    for xi in (0.0, -1.0):
        with pytest.raises(ValueError) as want:
            jpipe.compress_preserving_mss(f, xi, codec="zfplike",
                                          backend="reference")
        with pytest.raises(ValueError) as got:
            tpipe.compress_preserving_mss(f, xi, codec="zfplike",
                                          device="cpu")
        assert str(got.value) == str(want.value)


def test_unserved_combinations_raise_the_references_errors():
    f = _field((8, 10), np.float32)
    for kw in (dict(entropy="device-pack"), dict(device_path=True)):
        with pytest.raises(ValueError) as want:
            jpipe.compress_preserving_mss(f, 1e-2, codec="zfplike", **kw)
        with pytest.raises(ValueError) as got:
            tpipe.compress_preserving_mss(f, 1e-2, codec="zfplike",
                                          device="cpu", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="szlike base only"):
        tpipe.compress_preserving_mss_batch([f, f], 1e-2, codec="zfplike",
                                            entropy="device-pack",
                                            device="cpu")
    art = tpipe.compress_preserving_mss(f, 1e-2, codec="zfplike",
                                        device="cpu")
    with pytest.raises(ValueError, match="device_path=True but device "
                                         "decode serves the szlike"):
        tpipe.decompress_preserving_mss(art, device_path=True, device="cpu")
