"""The port's MSS-preserving round trip against ``repro``'s, bitwise:
payload and edit bytes, artifact metadata, cross-decoding in both
directions, f64 under x64, the byte codecs, refusals and hard errors,
zfplike and paper mode against the reference, and ``mesh=`` on a CPU
device mesh against the reference's bytes and g."""
import dataclasses
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.compress import codec as jcodec
from repro.compress import pipeline as jpipe, szlike as jsz
from repro.data import synthetic_field
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import codec as tcodec
from repro_torch.compress import pipeline as tpipe, szlike as tsz
from repro_torch.convert import artifact_from_dict, artifact_to_dict
from repro_torch.launch.mesh import make_block_mesh, make_data_mesh

#: artifact fields that must agree (timings and backend differ by design)
KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic", "version")

FIELDS = [("nyx", (12, 16, 20), np.float32, "auto"),
          ("climate", (24, 32), np.float32, "auto"),
          ("fingering", (10, 12, 14), np.float64, "auto"),
          ("climate", (20, 28), np.float64, "auto"),
          ("nyx", (10, 12, 9), np.float32, "bf16")]


def _field(name, shape, dtype):
    return synthetic_field(name, shape).astype(dtype)


@pytest.mark.parametrize("name,shape,dtype,evd", FIELDS)
def test_round_trip_is_bitwise_the_reference(name, shape, dtype, evd):
    f = _field(name, shape, dtype)
    xi = 1e-3 * float(np.ptp(f))
    with jax.enable_x64(dtype == np.float64):
        ref = jpipe.compress_preserving_mss(f, xi, backend="reference",
                                            edit_value_dtype=evd)
    arts = [tpipe.compress_preserving_mss(f, xi, device="cpu", backend=be,
                                          edit_value_dtype=evd)
            for be in ("reference", "cuda")]
    assert ref.path == "device"
    for art in arts:
        for k in KEYS:
            assert getattr(art, k) == getattr(ref, k), k
    # each side decodes the other's artifact to the other's g
    with jax.enable_x64(dtype == np.float64):
        g_ref = jpipe.decompress_preserving_mss(ref, backend="reference")
        g_cross = jpipe.decompress_preserving_mss(
            jpipe.CompressedArtifact(**artifact_to_dict(arts[0])),
            backend="reference")
    g_port = tpipe.decompress_preserving_mss(
        artifact_from_dict(dataclasses.asdict(ref)), device="cpu")
    assert g_port.dtype == g_ref.dtype == dtype
    assert np.array_equal(g_port, g_ref) and np.array_equal(g_cross, g_ref)
    assert np.array_equal(tpipe.decompress_artifact(arts[0]), g_ref)


def test_noise_field_needing_many_iterations():
    rng = np.random.default_rng(7)
    f = rng.normal(size=(8, 9, 10)).astype(np.float32)
    xi = 0.6
    ref = jpipe.compress_preserving_mss(f, xi, backend="reference")
    art = tpipe.compress_preserving_mss(f, xi, device="cpu")
    assert ref.fix_iters >= 5
    for k in KEYS:
        assert getattr(art, k) == getattr(ref, k), k


def test_transform_and_inverse_match_reference():
    f = _field("nyx", (7, 9, 11), np.float32)
    xi = 1e-3 * float(np.ptp(f))
    step = jsz.effective_step(f, xi)
    assert tsz.effective_step(f, xi) == step
    assert tsz.device_range_limit(np.float32) == jsz.device_range_limit(
        np.float32)
    r_ref = np.asarray(jsz.sz_transform(f, np.float32(step)))
    step_t = torch.tensor(step, dtype=torch.float32)
    r = tsz.sz_transform(torch.from_numpy(f), step_t)
    assert np.array_equal(r.numpy(), r_ref)
    assert np.array_equal(tsz.sz_inverse(r, step_t).numpy(),
                          np.asarray(jsz.sz_inverse(r_ref, np.float32(step))))
    assert tsz.int32_cumsum(r, 0).dtype == torch.int32
    assert tsz.sz_compress(f, xi) == jsz.sz_compress(f, xi)
    assert np.array_equal(tsz.sz_decompress(jsz.sz_compress(f, xi)),
                          jsz.sz_decompress(jsz.sz_compress(f, xi)))
    for bad_xi in (1e-12, -1.0):
        with pytest.raises(ValueError):
            jsz.check_int32_range(f, bad_xi)
        with pytest.raises(ValueError):
            tsz.check_int32_range(f, bad_xi)


@pytest.mark.parametrize("evd", ["f4", "f8", "bf16"])
def test_edit_codec_bytes_identical(evd):
    rng = np.random.default_rng(1)
    idx = np.unique(rng.integers(0, 10 ** 6, size=500))
    val = rng.normal(size=idx.size).astype(np.float32)
    # bf16 rounding corner cases: ties to even, NaN payloads, infinities
    val[:6] = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, np.inf,
                        -np.inf, np.nan, -0.0], np.float32)
    blob = tcodec.encode_edits(idx, val, evd)
    assert blob == jcodec.encode_edits(idx, val, evd)
    ti, tv = tcodec.decode_edits(blob)
    ji, jv = jcodec.decode_edits(blob)
    assert np.array_equal(ti, ji) and np.array_equal(tv, jv, equal_nan=True)
    deltas = np.diff(idx, prepend=0)
    assert tcodec._varint_encode(deltas) == jcodec._varint_encode(deltas)
    assert np.array_equal(tcodec._f32_to_bf16(val), jcodec._f32_to_bf16(val))


def test_truncated_and_overlong_blobs_raise():
    f = _field("climate", (16, 20), np.float32)
    art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu")
    blob = art.edit_payload
    for bad in (blob[:10], blob[:-1], blob + b"\0"):
        with pytest.raises(ValueError):
            tcodec.decode_edits(bad)
    with pytest.raises(ValueError, match="truncated"):
        tcodec._varint_decode(b"\x80\x80", 1)
    with pytest.raises(ValueError, match="over-long"):
        tcodec._varint_decode(b"\x01\x02", 1)
    with pytest.raises(ValueError, match="truncated"):
        tsz.sz_decode_residuals(art.base_payload[:12])
    for cut in (40, 60, len(art.base_payload) - 1):
        with pytest.raises(ValueError, match="truncated"):
            tsz.sz_decode_residuals(art.base_payload[:cut])
    with pytest.raises(ValueError, match="duplicate"):
        tcodec.encode_edits(np.array([3, 3]), np.zeros(2, np.float32))


def test_retired_and_unported_payloads():
    f = _field("climate", (16, 20), np.float32)
    art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu")
    szj1 = dataclasses.replace(art, base_payload=b"SZJ1" + art.base_payload[4:])
    with pytest.raises(ValueError, match="refusing retired 'SZJ1'"):
        tpipe.decompress_preserving_mss(szj1, device="cpu")
    with pytest.raises(ValueError):       # the reference refuses it too
        jpipe.decompress_preserving_mss(
            jpipe.CompressedArtifact(**artifact_to_dict(szj1)))
    zfp = jpipe.compress_preserving_mss(f, 1e-2, codec="zfplike",
                                        backend="reference")
    # the reference's zfplike artifact decodes in the port to its g
    g_port = tpipe.decompress_preserving_mss(
        artifact_from_dict(dataclasses.asdict(zfp)), device="cpu")
    assert np.array_equal(g_port, jpipe.decompress_preserving_mss(zfp))
    zfj1 = dataclasses.replace(
        artifact_from_dict(dataclasses.asdict(zfp)),
        base_payload=b"ZFJ1" + zfp.base_payload[4:])
    with pytest.raises(ValueError, match="refusing retired 'ZFJ1'"):
        tpipe.decompress_preserving_mss(zfj1, device="cpu")
    with pytest.raises(ValueError, match="unknown base payload magic"):
        tpipe.decompress_preserving_mss(
            dataclasses.replace(art, base_payload=b"XXXX" + b"\0" * 40),
            device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(codec="zfplike"), dict(base="zfplike"), dict(mode="paper"),
    dict(mesh=(2, 2)),
])
def test_once_refused_arguments_are_served_byte_for_byte(kwargs):
    """Arguments the port once refused are served, byte for byte the
    reference's: zfplike, paper mode, and ``mesh=`` (a (2, 2) block
    mesh of CPU blocks, its g the reference's decode); a mesh that is
    no mesh raises what the reference raises."""
    f = _field("climate", (8, 10), np.float32)
    if "mesh" in kwargs:
        mesh = make_block_mesh(kwargs["mesh"], devices=["cpu"] * 4)
        ref = jpipe.compress_preserving_mss(f, 1e-2, backend="reference")
        art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu", mesh=mesh)
        assert art.backend == "sharded" and art.path == ref.path == "device"
        for k in KEYS:
            assert getattr(art, k) == getattr(ref, k), k
        assert np.array_equal(
            tpipe.decompress_preserving_mss(art, device="cpu", mesh=mesh),
            jpipe.decompress_preserving_mss(ref, backend="reference"))
        with pytest.raises(AttributeError, match="axis_names"):
            jpipe.compress_preserving_mss(f, 1e-2, mesh=object())
        with pytest.raises(AttributeError, match="axis_names"):
            tpipe.compress_preserving_mss(f, 1e-2, device="cpu",
                                          mesh=object())
        return
    ref = jpipe.compress_preserving_mss(f, 1e-2, backend="reference",
                                        **kwargs)
    art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu", **kwargs)
    assert art.path == ref.path == "host"
    for k in KEYS:
        assert getattr(art, k) == getattr(ref, k), k


def test_batch_and_decode_entry_points_serve_mesh_byte_for_byte():
    """The batch and decode entry points serve ``mesh=`` (a CPU slab
    chain here) with the reference's bytes and g, and raise what the
    reference raises for a mesh that is no mesh."""
    f = _field("climate", (8, 10), np.float32)
    art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu")
    mesh = make_data_mesh(2, devices=["cpu", "cpu"])
    g_ref = jpipe.decompress_preserving_mss(
        jpipe.compress_preserving_mss(f, 1e-2, backend="reference"),
        backend="reference")
    assert np.array_equal(
        tpipe.decompress_preserving_mss(art, mesh=mesh, device="cpu"), g_ref)
    for bad in (tpipe, jpipe):
        with pytest.raises(AttributeError, match="axis_names"):
            kw = dict(device="cpu") if bad is tpipe else {}
            bad.decompress_preserving_mss(art if bad is tpipe else
                                          jpipe.CompressedArtifact(
                                              **artifact_to_dict(art)),
                                          mesh=object(), **kw)
    refs2 = jpipe.compress_preserving_mss_batch([f, f * 2], 1e-2,
                                                backend="reference")
    arts2 = tpipe.compress_preserving_mss_batch([f, f * 2], 1e-2,
                                                device="cpu", mesh=mesh)
    for a, r in zip(arts2, refs2):
        for k in KEYS:
            assert getattr(a, k) == getattr(r, k), k
    # a zfplike batch is served, each artifact the reference's
    refs = jpipe.compress_preserving_mss_batch([f, f * 2], 1e-2,
                                               codec="zfplike",
                                               backend="reference")
    arts = tpipe.compress_preserving_mss_batch([f, f * 2], 1e-2,
                                               codec="zfplike", device="cpu")
    for a, r in zip(arts, refs):
        for k in KEYS:
            assert getattr(a, k) == getattr(r, k), k
    gs = tpipe.decompress_artifact_batch(arts2, mesh=mesh, device="cpu")
    for g, r in zip(gs, refs2):
        assert np.array_equal(
            g, jpipe.decompress_preserving_mss(r, backend="reference"))
    # device_path=True refuses a bound too tight for the int32 device path
    with pytest.raises(ValueError, match="device_path=True"):
        tpipe.compress_preserving_mss(f * 1e6, 1e-3, device="cpu",
                                      device_path=True)


def test_truncated_szj2_stream_raises_what_the_reference_raises():
    f = _field("climate", (16, 20), np.float32)
    blob = tsz.sz_compress(f, 1e-2)
    assert blob == jsz.sz_compress(f, 1e-2)
    hdr = 4 + 1 + 1 + 8 + 8 + 8 * 2
    # a cut inside the first chunk length, and one inside the first chunk
    for cut, err in ((hdr + 4, struct.error), (hdr + 12, zlib.error)):
        with pytest.raises(err):
            jsz.sz_decode_residuals(blob[:cut])
        with pytest.raises(err) as info:
            tsz.sz_decode_residuals(blob[:cut])
        assert isinstance(info.value, ValueError)
        assert isinstance(info.value, tsz.TruncatedStreamError)


@pytest.mark.parametrize("device_path", ["auto", True])
@pytest.mark.parametrize("xi", [0.0, -1.0])
def test_invalid_xi_raises_what_the_reference_raises(xi, device_path):
    f = _field("climate", (8, 10), np.float32)
    with pytest.raises(Exception) as ref:
        jpipe.compress_preserving_mss(f, xi, device_path=device_path)
    with pytest.raises(Exception) as port:
        tpipe.compress_preserving_mss(f, xi, device_path=device_path,
                                      device="cpu")
    assert type(port.value) is type(ref.value) is ValueError
    # the reference prefixes its device-path refusal with "device_path=True
    # but"; both messages then start with the codec's own words
    start = "error bound must be positive"
    assert str(port.value).startswith(start)
    assert str(ref.value).split("device_path=True but ")[-1].startswith(start)
    if device_path == "auto":
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("entropy", ["deflate", "device-pack"])
def test_compress_timings_split_the_entropy_stage(entropy):
    f = _field("nyx", (8, 9, 10), np.float32)
    timings = {}
    art = tpipe.compress_preserving_mss(f, 1e-2, device="cpu",
                                        entropy=entropy, timings=timings)
    assert art.entropy == entropy
    assert list(timings) == ["transform", "topology", "fix_loop",
                             "extraction", "entropy_residual",
                             "entropy_edits"]
    assert all(v >= 0.0 for v in timings.values())
