"""The port's batched entry points and host path against ``repro``'s,
bitwise: ``fused_fix_batch`` under every batching, ``derive_edits_batch``
with one bound a member, ``verify_preservation_batch``,
``decode_edits_batch``, ``compress_preserving_mss_batch`` /
``decompress_artifact_batch`` (both residual codecs, f32 and f64, mixed
shapes, codes beyond the int32 range), and the host path
(``device_path=False`` and the "auto" fallback)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import codec as jcodec, pipeline as jpipe
from repro.core import driver as jdriver, fixes as jfixes
from repro.data import synthetic_field
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import codec as tcodec, pipeline as tpipe
from repro_torch.compress import szlike as tsz
from repro_torch.convert import artifact_from_dict
from repro_torch.core import driver as tdriver, fixes as tfixes

#: artifact fields that must agree (timings and backend differ by design)
KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic", "version")


def mixed_members(shape=(6, 7, 8), xi=0.3):
    """A mixed-convergence batch (the reference's ``_mixed_members`` of
    tests/test_fixloop.py): an already-converged member, a constant
    field, a light and a heavy perturbation, and a zero field."""
    rng = np.random.default_rng(11)
    smooth = np.add.outer(np.add.outer(np.linspace(0, 1, shape[0]),
                                       np.linspace(0, .5, shape[1])),
                          np.linspace(0, .25, shape[2])).astype(np.float32)
    members = [smooth, np.full(shape, 3.25, np.float32),
               rng.normal(size=shape).astype(np.float32),
               rng.normal(size=shape).astype(np.float32),
               np.zeros(shape, np.float32)]
    fs, fhs = [], []
    for i, f in enumerate(members):
        if i in (0, 1):
            fh = f.copy()
        else:
            amp = 0.2 if i == 2 else 0.999
            fh = (f + rng.uniform(-xi, xi, shape) * amp).astype(np.float32)
        fs.append(f)
        fhs.append(fh)
    return np.stack(fs), np.stack(fhs), xi


def reference_batch(f_b, fh_b, xi, **kw):
    topos = [jfixes.field_topology(jnp.asarray(f), xi) for f in f_b]
    topo_b = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *topos)
    g, it, ok = jfixes.fused_fix_batch(jnp.asarray(fh_b), topo_b,
                                       backend="reference", **kw)
    return np.asarray(g), np.asarray(it), np.asarray(ok)


def port_batch(f_b, fh_b, xi, backend="reference", **kw):
    topos = [tfixes.field_topology(torch.from_numpy(f), xi) for f in f_b]
    topo_b = tfixes.FieldTopo(*(torch.stack(ls) for ls in zip(*topos)))
    return tfixes.fused_fix_batch(torch.from_numpy(fh_b), topo_b,
                                  backend=backend, **kw)


BATCHINGS = [dict(batching="compact", compact_every=1),
             dict(batching="compact", compact_every=2),
             dict(batching="compact", compact_every=3),
             dict(batching="fused"), dict()]


@pytest.mark.parametrize("kw", BATCHINGS)
def test_fused_fix_batch_matches_reference(kw):
    f_b, fh_b, xi = mixed_members()
    g, it, ok = reference_batch(f_b, fh_b, xi, batching="fused")
    assert it[0] == it[1] == 1 and it.max() > 1       # mixed convergence
    for backend in ("reference", "cuda"):
        tg, tit, tok = port_batch(f_b, fh_b, xi, backend=backend, **kw)
        assert np.array_equal(tg.numpy(), g)
        assert np.array_equal(tit.numpy(), it)
        assert np.array_equal(tok.numpy(), ok)
    # each member is its solo loop
    for i in range(len(f_b)):
        sg, sit, sok = tfixes.fused_fix(
            torch.from_numpy(fh_b[i]),
            tfixes.field_topology(torch.from_numpy(f_b[i]), xi))
        assert np.array_equal(sg.numpy(), g[i]) and (sit, sok) == (it[i], ok[i])


@pytest.mark.parametrize("kw", [dict(batching="compact", compact_every=3),
                                dict(batching="fused")])
def test_fused_fix_batch_max_iters_stragglers(kw):
    f_b, fh_b, xi = mixed_members()
    _, it_full, _ = reference_batch(f_b, fh_b, xi)
    cap = int(it_full.max()) - 1
    g, it, ok = reference_batch(f_b, fh_b, xi, max_iters=cap, **kw)
    tg, tit, tok = port_batch(f_b, fh_b, xi, max_iters=cap, **kw)
    assert not ok.all() and ok.any()
    assert np.array_equal(tok.numpy(), ok)
    assert np.array_equal(tit.numpy(), it)
    assert np.array_equal(tg.numpy(), g)
    assert (tit.numpy()[~ok] == cap).all()


def test_fused_fix_batch_argument_errors():
    f_b, fh_b, xi = mixed_members()
    with pytest.raises(ValueError, match="batching"):
        port_batch(f_b, fh_b, xi, batching="eager")
    with pytest.raises(ValueError, match="compact_every"):
        port_batch(f_b, fh_b, xi, compact_every=0)


def test_derive_edits_batch_per_member_xi():
    f_b, fh_b, _ = mixed_members()
    xis = [0.3, 0.3, 0.35, 0.4, 0.3]
    ref = jdriver.derive_edits_batch(f_b, fh_b, xis, backend="reference",
                                     batching="compact", compact_every=2)
    got = tdriver.derive_edits_batch(f_b, fh_b, xis, batching="compact",
                                     compact_every=2, device="cpu")
    for i, (r, t) in enumerate(zip(ref, got)):
        solo = tdriver.derive_edits(f_b[i], fh_b[i], xis[i], device="cpu")
        for other in (r, solo):
            assert np.array_equal(t.g, other.g)
            assert np.array_equal(t.edits_idx, other.edits_idx)
            assert np.array_equal(t.edits_val, other.edits_val)
            assert (t.iters, t.converged, t.edit_ratio, t.max_abs_err) == (
                other.iters, other.converged, other.edit_ratio,
                other.max_abs_err)
    with pytest.raises(ValueError, match="expects"):
        tdriver.derive_edits_batch(f_b[0, 0], fh_b[0, 0], 0.3, device="cpu")
    with pytest.raises(ValueError, match="violates the error bound"):
        tdriver.derive_edits_batch(f_b, fh_b + 1, 0.3, device="cpu")


def test_verify_preservation_batch_matches_reference():
    f_b, fh_b, xi = mixed_members()
    res = tdriver.derive_edits_batch(f_b, fh_b, xi, device="cpu")
    g_b = np.stack([r.g for r in res])
    for g in (g_b, fh_b):          # corrected, and the raw perturbation
        want = jdriver.verify_preservation_batch(f_b, g, xi)
        got = tdriver.verify_preservation_batch(f_b, g, xi, device="cpu")
        assert got == want
    assert all(v["mss_preserved"] and v["bound_ok"]
               for v in tdriver.verify_preservation_batch(f_b, g_b, xi,
                                                          device="cpu"))
    with pytest.raises(ValueError, match="stack"):
        tdriver.verify_preservation_batch(f_b[0, 0], g_b[0, 0], xi)
    with pytest.raises(ValueError, match="disagree"):
        tdriver.verify_preservation_batch(f_b, g_b[:2], xi)


def test_decode_edits_batch_matches_reference():
    rng = np.random.default_rng(4)
    blobs = []
    for n, evd in ((5, "f4"), (0, "f4"), (9, "bf16"), (3, "f8")):
        idx = np.sort(rng.choice(100, n, replace=False))
        blobs.append(jcodec.encode_edits(idx, rng.normal(size=n), evd))
    for subset in (blobs[:3], blobs):          # f32 only, then f8-promoted
        for fill in (None, 100):
            want = jcodec.decode_edits_batch(subset, fill_idx=fill)
            got = tcodec.decode_edits_batch(subset, fill_idx=fill)
            if fill is None:
                assert len(got) == len(want)
                pairs = zip(got, want)
            else:
                pairs = [(got, want)]
            for gs, ws in pairs:
                for g, w in zip(gs, ws):
                    assert g.dtype == w.dtype and np.array_equal(g, w)
    assert tcodec.decode_edits_batch(blobs, 100)[1].dtype == np.float64
    assert tcodec.decode_edits_batch([], 100)[0].shape == (0, 0)


def check_artifacts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            assert getattr(g, k) == getattr(w, k), k


def timesteps(shape, dtype, n=3):
    return [synthetic_field("climate" if len(shape) == 2 else "nyx", shape,
                            seed=s).astype(dtype) for s in range(3, 3 + n)]


@pytest.mark.parametrize("entropy", ["deflate", "device-pack"])
@pytest.mark.parametrize("shape,dtype", [((20, 24), np.float32),
                                         ((8, 10, 12), np.float32),
                                         ((9, 8, 10), np.float64)])
def test_batch_round_trip_is_bitwise_the_reference(shape, dtype, entropy):
    fields = timesteps(shape, dtype)
    xi = [float(s) * float(np.ptp(f)) for s, f in
          zip((1e-2, 3e-3, 1e-3), fields)]
    with jax.enable_x64(dtype == np.float64):
        ref = jpipe.compress_preserving_mss_batch(fields, xi,
                                                  backend="reference",
                                                  entropy=entropy)
        g_ref = jpipe.decompress_artifact_batch(ref, backend="reference")
    arts = tpipe.compress_preserving_mss_batch(fields, xi, entropy=entropy,
                                               backend="cuda", device="cpu")
    check_artifacts(arts, ref)
    assert all(a.path == "device" for a in arts)
    solo = [tpipe.compress_preserving_mss(f, x, entropy=entropy,
                                          device="cpu")
            for f, x in zip(fields, xi)]
    check_artifacts(arts, solo)
    g = tpipe.decompress_artifact_batch(arts, backend="cuda", device="cpu")
    for gi, gr, a, f, x in zip(g, g_ref, arts, fields, xi):
        assert gi.dtype == dtype and np.array_equal(gi, gr)
        assert np.array_equal(
            gi, tpipe.decompress_preserving_mss(a, device="cpu"))
    verdicts = tdriver.verify_preservation_batch(np.stack(fields),
                                                 np.stack(g), xi,
                                                 device="cpu")
    assert all(v["mss_preserved"] and v["bound_ok"] for v in verdicts)


def test_decompress_batch_of_mixed_shapes_and_reference_artifacts():
    a = tpipe.compress_preserving_mss_batch(timesteps((12, 14), np.float32),
                                            1e-2, device="cpu")
    b = jpipe.compress_preserving_mss(timesteps((6, 7, 8), np.float32)[0],
                                      1e-2, backend="reference",
                                      entropy="device-pack")
    mixed = [a[0], artifact_from_dict(dataclasses.asdict(b)), a[1]]
    got = tpipe.decompress_artifact_batch(mixed, device="cpu")
    want = jpipe.decompress_artifact_batch(
        [jpipe.CompressedArtifact(**dataclasses.asdict(m)) for m in mixed],
        backend="reference")
    assert [x.shape for x in got] == [(12, 14), (6, 7, 8), (12, 14)]
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    assert tpipe.decompress_artifact_batch([], device="cpu") == []
    assert tpipe.compress_preserving_mss_batch([], 1e-2, device="cpu") == []
    with pytest.raises(ValueError, match="share one shape"):
        tpipe.compress_preserving_mss_batch(
            [np.zeros((4, 5), np.float32), np.zeros((5, 4), np.float32)],
            1e-2, device="cpu")


def test_host_path_artifacts_whose_codes_overflow_int32():
    """f * 1e7 with xi = 1e-3 is outside the int32 device range: "auto"
    takes the host path, solo and batched, and since the codes' cumsums
    overflow int32 the read side falls back to the host decode. (In f32
    the bound is below the field's own resolution there, and both
    packages refuse it.)"""
    fields = [f * 1e7 for f in timesteps((8, 10), np.float64, n=2)]
    with jax.enable_x64(True):
        ref = [jpipe.compress_preserving_mss(f, 1e-3, backend="reference")
               for f in fields]
        g_ref = jpipe.decompress_artifact_batch(ref, backend="reference")
    solo = [tpipe.compress_preserving_mss(f, 1e-3, device="cpu")
            for f in fields]
    batch = tpipe.compress_preserving_mss_batch(fields, 1e-3, device="cpu")
    assert all(a.path == "host" for a in ref)
    assert not any(tsz.codes_fit_int32(tsz.sz_decode_residuals(
        a.base_payload)[0]) for a in ref)
    check_artifacts(solo, ref)
    check_artifacts(batch, ref)
    g = tpipe.decompress_artifact_batch(batch, device="cpu")
    for f, x, y, a in zip(fields, g, g_ref, batch):
        assert np.array_equal(x, y)
        assert np.array_equal(x, tpipe.decompress_preserving_mss(
            a, device="cpu"))
        v = tdriver.verify_preservation(f, x, 1e-3, device="cpu")
        assert v["mss_preserved"] and v["bound_ok"]
    with pytest.raises(ValueError, match="device_path=True"):
        tpipe.decompress_artifact_batch(batch, device_path=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="device_path=True"):
        tpipe.compress_preserving_mss_batch(fields, 1e-3, device_path=True,
                                            device="cpu")
    f32 = fields[0].astype(np.float32)
    with pytest.raises(ValueError, match="violates the error bound"):
        jpipe.compress_preserving_mss(f32, 1e-3, backend="reference")
    with pytest.raises(ValueError, match="violates the error bound"):
        tpipe.compress_preserving_mss(f32, 1e-3, device="cpu")


HOST_CASES = [((16, 20), np.float32, "deflate", "auto"),
              ((16, 20), np.float32, "device-pack", "auto"),
              ((7, 8, 9), np.float32, "deflate", "bf16"),
              ((7, 8, 9), np.float64, "deflate", "auto"),
              ((7, 8, 9), np.float64, "device-pack", "f4")]


@pytest.mark.parametrize("shape,dtype,entropy,evd", HOST_CASES)
def test_host_path_is_bitwise_the_reference(shape, dtype, entropy, evd):
    f = timesteps(shape, dtype, n=1)[0]
    xi = 1e-3 * float(np.ptp(f))
    kw = dict(entropy=entropy, edit_value_dtype=evd)
    with jax.enable_x64(dtype == np.float64):
        ref = jpipe.compress_preserving_mss(f, xi, backend="reference",
                                            device_path=False, **kw)
        dev = jpipe.compress_preserving_mss(f, xi, backend="reference",
                                            **kw)
    for backend in ("reference", "cuda"):
        art = tpipe.compress_preserving_mss(f, xi, device_path=False,
                                            backend=backend, device="cpu",
                                            **kw)
        check_artifacts([art], [ref])
        assert art.path == "host" and art.backend == backend
    # the host and device paths carry the same bytes
    assert (ref.base_payload, ref.edit_payload) == (dev.base_payload,
                                                    dev.edit_payload)
    batch = tpipe.compress_preserving_mss_batch([f, f], xi,
                                                device_path=False,
                                                device="cpu", **kw)
    check_artifacts(batch, [ref, ref])
    g = tpipe.decompress_preserving_mss(art, device="cpu")
    assert np.array_equal(g, tpipe.decompress_artifact(art))


@pytest.mark.parametrize("f,err", [
    (np.zeros(12, np.float32), ValueError),          # not 2D/3D
    (np.zeros((4, 5), np.float16), TypeError),       # unsupported dtype
])
def test_auto_falls_back_to_the_host_path_as_the_reference_does(f, err):
    f = f + np.arange(f.size, dtype=f.dtype).reshape(f.shape)
    with pytest.raises(err):
        jpipe.compress_preserving_mss(f, 0.5, backend="reference")
    with pytest.raises(err):
        tpipe.compress_preserving_mss(f, 0.5, device="cpu")
    with pytest.raises(ValueError, match="device_path=True"):
        tpipe.compress_preserving_mss(f, 0.5, device="cpu",
                                      device_path=True)
