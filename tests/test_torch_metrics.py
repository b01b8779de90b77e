"""The paper's metric helpers of ``repro_torch.compress`` against
``repro.compress``'s on the same seeded fields: ``sz_roundtrip`` (f_hat
bitwise, the same byte count), the lossless baselines ``gzip_like``,
``zstd_like`` and ``lossless_bytes`` (equal byte counts),
``overall_bit_rate`` of each package's artifact, and ``psnr`` (equal
values, +-inf in the same cases)."""
import jax
import numpy as np
import pytest

import repro.compress as jc
from _torch_threads import one_thread  # noqa: F401
import repro_torch.compress as tc
from repro.data import synthetic_field

FIELDS = [("nyx", (12, 16, 20), np.float32),
          ("climate", (24, 32), np.float32),
          ("fingering", (10, 12, 14), np.float64)]


def _field(name, shape, dtype):
    return synthetic_field(name, shape).astype(dtype)


def _xi(f):
    return 1e-3 * float(np.ptp(f))


def test_the_helpers_are_exported_as_in_the_reference():
    names = ("sz_roundtrip", "gzip_like", "zstd_like", "lossless_bytes",
             "overall_bit_rate", "psnr")
    for name in names:
        assert name in tc.__all__ and name in jc.__all__
        assert callable(getattr(tc, name))


@pytest.mark.parametrize("name,shape,dtype", FIELDS)
def test_sz_roundtrip_is_bitwise_the_reference(name, shape, dtype):
    f = _field(name, shape, dtype)
    with jax.enable_x64(dtype == np.float64):
        want, want_n = jc.sz_roundtrip(f, _xi(f))
    got, got_n = tc.sz_roundtrip(f, _xi(f))
    assert got_n == want_n
    assert got.dtype == want.dtype == dtype and got.shape == f.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert np.abs(got.astype(np.float64) - f).max() <= _xi(f)


@pytest.mark.parametrize("codec", ["gzip", "zstd"])
@pytest.mark.parametrize("name,shape,dtype", FIELDS)
def test_lossless_baselines_match_the_reference(name, shape, dtype, codec):
    f = _field(name, shape, dtype)
    assert tc.lossless_bytes(f, codec) == jc.lossless_bytes(f, codec)
    assert tc.gzip_like(f) == jc.gzip_like(f)
    assert tc.zstd_like(f) == jc.zstd_like(f)
    assert tc.lossless_bytes(f) == tc.gzip_like(f)


@pytest.mark.parametrize("name,shape,dtype", FIELDS[:2])
def test_overall_bit_rate_matches_the_reference(name, shape, dtype):
    f = _field(name, shape, dtype)
    ref = jc.compress_preserving_mss(f, _xi(f), backend="reference")
    art = tc.compress_preserving_mss(f, _xi(f), device="cpu")
    assert art.nbytes == ref.nbytes
    assert tc.overall_bit_rate(f, art) == jc.overall_bit_rate(f, ref)
    assert tc.overall_bit_rate(f, art) == art.nbytes * 8.0 / f.size


@pytest.mark.parametrize("name,shape,dtype", FIELDS)
def test_psnr_matches_the_reference(name, shape, dtype):
    f = _field(name, shape, dtype)
    g, _ = tc.sz_roundtrip(f, _xi(f))
    got = tc.psnr(f, g)
    assert np.isfinite(got) and got == jc.psnr(f, g)
    # shifting the field shifts nothing: the range, not max|f|, normalizes
    f64, g64 = f.astype(np.float64), g.astype(np.float64)
    assert tc.psnr(f64 + 1000, g64 + 1000) == pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("case,want", [("exact", np.inf),
                                       ("constant", -np.inf)])
def test_psnr_infinities_match_the_reference(case, want):
    f = _field("climate", (8, 9), np.float32)
    if case == "exact":
        g = f.copy()
    else:
        f = np.full_like(f, 3.0)
        g = f + np.float32(0.5)
    assert tc.psnr(f, g) == jc.psnr(f, g) == want
