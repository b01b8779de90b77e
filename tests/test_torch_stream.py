"""The port's stream scheduler and compression service against the
reference's one-shot pipeline (``repro.compress.stream``'s contract):
every artifact and decompressed field byte-identical, submission order
under out-of-order completion, backpressure, ``strict_uniform``, the
``SpecCache`` LRU, every ``fix_batching`` policy, device-pack batches
off the worker pool, the decompress stream, zfplike through the host
leg, the service's overload reject and its ``/stats`` and ``/healthz``
endpoints; calibration; the straggler watchdog; the thread-local
guards; and the launcher, with and without a mesh (the sharded cases
in full are in ``test_torch_shardfix.py``). Everything runs on the
CPU."""
import functools
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro.compress import pipeline as jpipe
from repro.data import synthetic_field
from repro.distributed.straggler import StepWatchdog as JWatchdog
from _torch_threads import one_thread  # noqa: F401
from repro_torch import device as tdevice
from repro_torch.compress import (CompressStream, DecompressStream,
                                  SpecCache, StreamBackpressure,
                                  StreamClosed, calibrate,
                                  compress_preserving_mss,
                                  decompress_preserving_mss)
from repro_torch.debug import guards
from repro_torch.distributed import StepWatchdog
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.serve import (CompressionService, ServiceConfig,
                               ServiceOverloaded, start_stats_server)

SHAPE_3D = (8, 8, 8)
SHAPE_2D = (12, 10)
CPU = dict(device="cpu")


def _traffic(shape, n, seed0=0, xi_rel=1e-3):
    fields = [synthetic_field("nyx", shape=shape, seed=seed0 + s)
              .astype(np.float32) for s in range(n)]
    return fields, [xi_rel * float(np.ptp(f)) for f in fields]


@functools.lru_cache(maxsize=None)
def _solo_artifacts(shape, n, base="szlike"):
    """The reference's one-shot artifacts (and the port's, which must
    equal them)."""
    fields, xis = _traffic(shape, n)
    refs = [jpipe.compress_preserving_mss(f, xi, base=base,
                                          backend="reference")
            for f, xi in zip(fields, xis)]
    ports = [compress_preserving_mss(f, xi, base=base, **CPU)
             for f, xi in zip(fields, xis)]
    _assert_identical(ports, refs)
    return fields, xis, refs


def _assert_identical(arts, refs):
    assert len(arts) == len(refs)
    for a, r in zip(arts, refs):
        assert a.base_payload == r.base_payload
        assert a.edit_payload == r.edit_payload
        assert a.fix_iters == r.fix_iters
        assert tuple(a.shape) == tuple(r.shape) and a.dtype == r.dtype


def _record_pool(stream):
    """Wrap the stream's worker-pool submit to record the jobs (by
    function name) the scheduler handed off."""
    jobs = []
    orig = stream._pool.submit

    def recording_submit(fn, *args, **kw):
        jobs.append(getattr(fn, "__name__", str(fn)))
        return orig(fn, *args, **kw)

    stream._pool.submit = recording_submit
    return jobs


# ---------------------------------------------------------------------------
# byte-identity + ordering
# ---------------------------------------------------------------------------

def test_stream_matches_one_shot():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 6)
    with CompressStream(window=4, max_batch=4, **CPU) as cs:
        arts = cs.map(fields, xis)
        st = cs.stats()
    _assert_identical(arts, refs)
    assert st["completed"] == 6 and st["failed"] == 0
    assert st["in_flight"] == 0 and st["batches"] >= 2
    assert 0.0 < st["batch_occupancy"] <= 1.0
    assert st["nbytes_h2d"] > 0 and st["nbytes_d2h"] > 0
    assert st["shard"] == dict(halo_bytes_by_axis={}, halo_bytes_total=0,
                               fix_iters=0, last=None)


def test_ordering_under_out_of_order_completion():
    f3, xi3, ref3 = _solo_artifacts(SHAPE_3D, 3)
    f2, xi2, ref2 = _solo_artifacts(SHAPE_2D, 3)
    fields = [x for pair in zip(f3, f2) for x in pair]
    xis = [x for pair in zip(xi3, xi2) for x in pair]
    refs = [x for pair in zip(ref3, ref2) for x in pair]
    with CompressStream(window=6, max_batch=4, **CPU) as cs:
        arts = cs.map(fields, xis)
        st = cs.stats()
    _assert_identical(arts, refs)
    assert st["batches"] >= 2


def test_mixed_bounds_ride_along_in_one_batch():
    fields, xis, _ = _solo_artifacts(SHAPE_3D, 4)
    xis = [xi * (0.5 if i % 2 else 1.0) for i, xi in enumerate(xis)]
    refs = [jpipe.compress_preserving_mss(f, xi, backend="reference")
            for f, xi in zip(fields, xis)]
    with CompressStream(window=4, max_batch=4, linger_ms=50, **CPU) as cs:
        arts = cs.map(fields, xis)
    _assert_identical(arts, refs)


def test_strict_uniform_rejects_mixed_specs():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 2)
    other = synthetic_field("nyx", shape=SHAPE_2D).astype(np.float32)
    with CompressStream(window=4, strict_uniform=True, **CPU) as cs:
        fut = cs.submit(fields[0], xis[0])
        with pytest.raises(ValueError, match="strict_uniform"):
            cs.submit(other, 1e-3)
        _assert_identical([fut.result()], [refs[0]])


def test_error_propagates_to_the_request_future():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 2)
    with CompressStream(window=4, device_path=True, **CPU) as cs:
        bad = cs.submit(fields[0], xis[0], base="zfplike")
        good = cs.submit(fields[1], xis[1])
        with pytest.raises(ValueError, match="szlike"):
            bad.result()
        _assert_identical([good.result()], [refs[1]])
        st = cs.stats()
    assert st["failed"] == 1 and st["completed"] == 1


def test_submit_after_close_raises_and_mesh_is_not_ported():
    """A closed stream refuses submits; a stream over a mesh (a CPU slab
    chain) serves the solo bytes both ways."""
    cs = CompressStream(window=2, **CPU)
    cs.close()
    with pytest.raises(StreamClosed):
        cs.submit(np.zeros(SHAPE_3D, np.float32), 1e-3)
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 2)
    mesh = make_data_mesh(2, devices=["cpu", "cpu"])
    with CompressStream(window=2, mesh=mesh, **CPU) as cs:
        arts = [cs.submit(f, xi).result() for f, xi in zip(fields, xis)]
    _assert_identical(arts, refs)
    with DecompressStream(window=2, mesh=mesh, **CPU) as ds:
        gs = [ds.submit(a).result() for a in arts]
    for g, r in zip(gs, refs):
        assert np.array_equal(g, jpipe.decompress_preserving_mss(
            r, backend="reference"))


def test_close_drains_a_never_started_stream():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 2)
    cs = CompressStream(window=4, start=False, **CPU)
    futs = [cs.submit(f, xi) for f, xi in zip(fields, xis)]
    cs.close()
    _assert_identical([f.result(timeout=60) for f in futs], refs)


def test_cancelled_future_does_not_kill_the_scheduler():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 3)
    cs = CompressStream(window=3, max_batch=2, start=False, **CPU)
    futs = [cs.submit(f, xi) for f, xi in zip(fields, xis)]
    assert futs[1].cancel()
    cs.start()
    _assert_identical([futs[0].result(timeout=60),
                       futs[2].result(timeout=60)], [refs[0], refs[2]])
    cs.flush()
    st = cs.stats()
    cs.close()
    assert st["completed"] == 2 and st["failed"] == 1
    assert st["in_flight"] == 0


# ---------------------------------------------------------------------------
# backpressure and the spec cache
# ---------------------------------------------------------------------------

def test_backpressure_window_bound_honored():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 4)
    cs = CompressStream(window=3, max_batch=2, start=False, **CPU)
    futs = [cs.submit(fields[i], xis[i], block=False) for i in range(3)]
    with pytest.raises(StreamBackpressure):
        cs.submit(fields[3], xis[3], block=False)
    with pytest.raises(StreamBackpressure):
        cs.submit(fields[3], xis[3], timeout=0.05)
    cs.start()
    futs.append(cs.submit(fields[3], xis[3]))
    arts = [f.result(timeout=60) for f in futs]
    st = cs.stats()
    cs.close()
    _assert_identical(arts, refs)
    assert st["max_in_flight"] <= 3


def test_spec_cache_lru_eviction():
    with pytest.raises(ValueError):
        SpecCache(maxsize=0)
    c = SpecCache(maxsize=2)
    assert c.get("a", lambda: 1) == 1
    assert c.get("b", lambda: 2) == 2
    assert c.get("a", lambda: -1) == 1
    c.get("c", lambda: 3)
    assert c.stats()["evictions"] == 1 and len(c) == 2
    assert c.get("b", lambda: 20) == 20
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 4 and s["size"] == 2


def test_spec_cache_build_race_single_winner():
    cache = SpecCache(8)
    n = 6
    barrier = threading.Barrier(n)
    built = []

    def build():
        barrier.wait(timeout=30)
        obj = object()
        built.append(obj)
        return obj

    results = [None] * n

    def worker(i):
        results[i] = cache.get("spec", build)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(built) == n
    assert len({id(r) for r in results}) == 1
    st = cache.stats()
    assert st["misses"] == 1 and st["hits"] == n - 1 and st["size"] == 1


def test_stream_cache_hits_and_eviction_counters():
    fields, xis, _ = _solo_artifacts(SHAPE_3D, 4)
    with CompressStream(window=4, max_batch=2, cache_size=1, **CPU) as cs:
        arts = cs.map(fields, [xis[0]] * 4)
        cache1 = cs.stats()["cache"]
        cs.map(fields[:2], [xis[0] * 0.5] * 2)
        cache2 = cs.stats()["cache"]
    refs0 = [jpipe.compress_preserving_mss(f, xis[0], backend="reference")
             for f in fields]
    _assert_identical(arts, refs0)
    assert cache1["misses"] >= 1 and cache1["hits"] >= 1
    assert cache2["evictions"] >= 1 and cache2["size"] == 1


# ---------------------------------------------------------------------------
# fix-batching policy and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "fused", "pipelined"])
def test_fix_batching_modes_all_byte_identical(mode):
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 3)
    with CompressStream(window=4, max_batch=4, linger_ms=50,
                        fix_batching=mode, **CPU) as cs:
        arts = cs.map(fields, xis)
        st = cs.stats()
    _assert_identical(arts, refs)
    # three members pad to four; the padding member never reaches an
    # artifact
    assert st["padded_members"] >= 1 and st["completed"] == 3
    if mode != "auto":
        assert set(st["fix_modes"]) == {mode}


def test_fix_batching_rejects_unknown_mode():
    with pytest.raises(ValueError, match="fix_batching"):
        CompressStream(fix_batching="eager", **CPU)


def test_calibration_measures_once_and_env_overrides(monkeypatch):
    monkeypatch.delenv(calibrate.ENV_VAR, raising=False)
    calibrate.clear_cache()
    n0 = calibrate.measure_count
    cal = calibrate.fused_fix_threshold("reference", np.float32, "cpu")
    assert cal.source == "measured"
    assert calibrate.CLAMP[0] <= cal.threshold_voxels <= calibrate.CLAMP[1]
    assert cal.overhead_s >= 0 and cal.solo_voxel_s >= 0
    again = calibrate.fused_fix_threshold("reference", np.float32, "cpu")
    assert again is cal and calibrate.measure_count == n0 + 1
    monkeypatch.setenv(calibrate.ENV_VAR, "1234")
    env = calibrate.fused_fix_threshold("reference", np.float32, "cpu")
    assert (env.threshold_voxels, env.source) == (1234, "env")
    monkeypatch.setenv(calibrate.ENV_VAR, "lots")
    with pytest.raises(ValueError, match=calibrate.ENV_VAR):
        calibrate.fused_fix_threshold("reference", np.float32, "cpu")
    # the stream's auto policy takes the override
    monkeypatch.setenv(calibrate.ENV_VAR, "1")
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 2)
    with CompressStream(window=2, max_batch=2, linger_ms=50, **CPU) as cs:
        _assert_identical(cs.map(fields, xis), refs)
        st = cs.stats()
    assert st["fused_fix_voxels"] == 1
    assert set(st["fix_modes"]) == {"pipelined"}


def test_calibration_is_guarded_against_builds(monkeypatch):
    calibrate.clear_cache()
    monkeypatch.delenv(calibrate.ENV_VAR, raising=False)
    calls = []

    def building_fix(*a, **kw):
        calls.append(1)
        if len(calls) > 1:          # a build inside the timed reps
            guards.note_compile("nvcc csrc/extrema.cu")

    from repro_torch.core import fixes
    monkeypatch.setattr(fixes, "fused_fix", building_fix)
    with pytest.raises(guards.RecompileError, match="calibrate"):
        calibrate.fused_fix_threshold("reference", np.float32, "cpu")
    calibrate.clear_cache()


# ---------------------------------------------------------------------------
# decompress stream, zfplike, device-pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", ["szlike", "zfplike"])
def test_decompress_stream_parity(base):
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 4, base=base)
    want = [jpipe.decompress_preserving_mss(a) for a in refs]
    arts = [compress_preserving_mss(f, xi, base=base, **CPU)
            for f, xi in zip(fields, xis)]
    with DecompressStream(window=4, max_batch=4, **CPU) as ds:
        gs = ds.map(arts)
        st = ds.stats()
    for g, w in zip(gs, want):
        np.testing.assert_array_equal(g, w)
    assert st["completed"] == 4 and st["failed"] == 0


def test_zfplike_takes_the_host_leg():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 3, base="zfplike")
    with CompressStream(window=4, max_batch=4, linger_ms=50, **CPU) as cs:
        jobs = _record_pool(cs)
        futs = [cs.submit(f, xi, base="zfplike")
                for f, xi in zip(fields, xis)]
        arts = [f.result(timeout=60) for f in futs]
        st = cs.stats()
    _assert_identical(arts, refs)
    assert set(jobs) == {"_host_batch"}
    assert set(st["fix_modes"]) == {"host"}
    assert all(a.base_magic == "ZFJ2" and a.path == "host" for a in arts)


def test_device_pack_compress_bypasses_worker_pool():
    fields, xis = _traffic(SHAPE_3D, 4)
    refs = [jpipe.compress_preserving_mss(f, xi, entropy="device-pack",
                                          backend="reference")
            for f, xi in zip(fields, xis)]
    with CompressStream(window=4, max_batch=4, linger_ms=50, **CPU) as cs:
        jobs = _record_pool(cs)
        futs = [cs.submit(f, xi, entropy="device-pack")
                for f, xi in zip(fields, xis)]
        arts = [f.result(timeout=60) for f in futs]
        st = cs.stats()
    assert jobs == [], f"worker pool saw {jobs} for device-pack traffic"
    _assert_identical(arts, refs)
    assert all(a.entropy == "device-pack" for a in arts)
    assert st["entropy_codecs"]["device-pack"]["count"] == 4
    assert st["entropy_codecs"]["device-pack"]["bytes"] == \
        sum(len(a.base_payload) for a in arts)


def test_device_pack_batches_sanitized_end_to_end(monkeypatch):
    """With ``MSZ_SANITIZERS=1`` the scheduler's device stage runs under
    ``no_transfers``; every tensor counts as a device tensor here, so an
    unaudited read or copy anywhere in the stage would fail the batch.
    The audited crossings: one batch-sized h2d, and nothing batch-sized
    back (the packed streams and the edits)."""
    fields, xis = _traffic(SHAPE_3D, 4)
    refs = [compress_preserving_mss(f, xi, entropy="device-pack", **CPU)
            for f, xi in zip(fields, xis)]
    monkeypatch.setenv("MSZ_SANITIZERS", "1")
    monkeypatch.setattr(guards, "_is_device",
                        lambda t: isinstance(t, torch.Tensor))
    log = []
    seam = guards.seam

    def counting(direction, nbytes):
        log.append((direction, nbytes))
        return seam(direction, nbytes)

    monkeypatch.setattr(tdevice, "seam", counting)
    with CompressStream(window=4, max_batch=4, linger_ms=50,
                        fix_batching="fused", **CPU) as cs:
        jobs = _record_pool(cs)
        futs = [cs.submit(f, xi, entropy="device-pack")
                for f, xi in zip(fields, xis)]
        arts = [f.result(timeout=60) for f in futs]
    assert jobs == []
    _assert_identical(arts, refs)
    batch_bytes = sum(f.nbytes for f in fields)
    assert sum(1 for d, n in log if d == "h2d" and n >= batch_bytes) == 1
    assert all(n < batch_bytes for d, n in log if d == "d2h"), log


def test_deflate_compress_still_uses_worker_pool():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 3)
    with CompressStream(window=3, max_batch=3, linger_ms=50, **CPU) as cs:
        jobs = _record_pool(cs)
        arts = cs.map(fields, xis)
        st = cs.stats()
    assert "_finish_compress" in jobs
    _assert_identical(arts, refs)
    assert st["entropy_codecs"]["deflate"]["count"] == 3


def test_entropy_is_part_of_the_coalescing_spec():
    fields, xis = _traffic(SHAPE_3D, 4)
    codecs = ["deflate", "device-pack"] * 2
    with CompressStream(window=4, max_batch=4, linger_ms=60, **CPU) as cs:
        futs = [cs.submit(f, xi, entropy=e)
                for f, xi, e in zip(fields, xis, codecs)]
        arts = [f.result(timeout=60) for f in futs]
        st = cs.stats()
    assert st["batches"] >= 2
    for f, xi, a, e in zip(fields, xis, arts, codecs):
        assert a.entropy == e
        ref = jpipe.compress_preserving_mss(f, xi, entropy=e,
                                            backend="reference")
        assert a.base_payload == ref.base_payload


def test_device_pack_decompress_runs_inline():
    fields, xis = _traffic(SHAPE_3D, 3)
    arts = [compress_preserving_mss(f, xi, entropy="device-pack", **CPU)
            for f, xi in zip(fields, xis)]
    want = [decompress_preserving_mss(a, **CPU) for a in arts]
    with DecompressStream(window=3, max_batch=3, linger_ms=50, **CPU) as ds:
        jobs = _record_pool(ds)
        gs = ds.map(arts)
        st = ds.stats()
    assert jobs == []
    for g, w in zip(gs, want):
        np.testing.assert_array_equal(g, w)
    assert st["entropy_codecs"]["device-pack"]["count"] == 3


def test_stream_submit_rejects_bad_entropy():
    f, xis = _traffic(SHAPE_3D, 1)
    with CompressStream(window=1, **CPU) as cs:
        with pytest.raises(ValueError, match="entropy"):
            cs.submit(f[0], xis[0], entropy="huffman")
        with pytest.raises(ValueError, match="szlike"):
            cs.submit(f[0], xis[0], base="zfplike", entropy="device-pack")


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def test_service_roundtrip_and_stats():
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 3)
    cfg = ServiceConfig(window=4, max_batch=2, **CPU)
    with CompressionService(cfg) as svc:
        futs = [svc.submit_compress(f, xi) for f, xi in zip(fields, xis)]
        arts = [f.result(timeout=60) for f in futs]
        _assert_identical(arts, refs)
        gs = [svc.decompress(a) for a in arts]
        for f, xi, g in zip(fields, xis, gs):
            assert float(np.max(np.abs(f - g))) <= xi * (1 + 1e-6)
        svc.flush()
        st = svc.stats()
        assert svc.shard_timings() is None
    assert st["compress"]["completed"] == 3
    assert st["decompress"]["completed"] == 3
    assert st["uptime_s"] > 0 and st["config"]["window"] == 4
    assert st["shard_timings"] is None


def test_service_overload_reject_maps_backpressure():
    with pytest.raises(ValueError):
        ServiceConfig(overload="nope")
    fields, xis, refs = _solo_artifacts(SHAPE_3D, 1)
    svc = CompressionService(ServiceConfig(window=1, overload="reject",
                                           **CPU))
    assert svc._compress._slots.acquire(blocking=False)
    with pytest.raises(ServiceOverloaded):
        svc.submit_compress(fields[0], xis[0])
    svc._compress._slots.release()
    _assert_identical([svc.compress(fields[0], xis[0])], [refs[0]])
    svc.close()


def test_service_stats_http_endpoint():
    fields, xis, _ = _solo_artifacts(SHAPE_3D, 1)
    with CompressionService(ServiceConfig(window=2, **CPU)) as svc:
        svc.compress(fields[0], xis[0])
        server = start_stats_server(svc, port=0)
        try:
            host, port = server.server_address[:2]
            with urllib.request.urlopen(
                    f"http://{host}:{port}/stats", timeout=5) as resp:
                doc = json.loads(resp.read())
            assert doc["compress"]["completed"] == 1
            assert "fields_per_sec" in doc["compress"]
            assert "cache" in doc["compress"]
            with urllib.request.urlopen(
                    f"http://{host}:{port}/healthz", timeout=5) as resp:
                assert resp.read().strip() == b"ok"
        finally:
            server.shutdown()
            server.server_close()


def test_service_forwards_codecs_and_reports_them():
    fields, xis = _traffic(SHAPE_3D, 3)
    ref_dp = jpipe.compress_preserving_mss(fields[0], xis[0],
                                           entropy="device-pack",
                                           backend="reference")
    ref_zfp = jpipe.compress_preserving_mss(fields[2], xis[2],
                                            codec="zfplike",
                                            backend="reference")
    with CompressionService(ServiceConfig(window=4, max_batch=2,
                                          **CPU)) as svc:
        a = svc.compress(fields[0], xis[0], entropy="device-pack")
        b = svc.compress(fields[1], xis[1])
        z = svc.compress(fields[2], xis[2], codec="zfplike")
        g = svc.decompress(a)
        gz = svc.decompress(z)
        st = svc.stats()
    _assert_identical([a, z], [ref_dp, ref_zfp])
    assert b.entropy == "deflate"
    np.testing.assert_array_equal(g, jpipe.decompress_preserving_mss(ref_dp))
    np.testing.assert_array_equal(gz,
                                  jpipe.decompress_preserving_mss(ref_zfp))
    assert st["compress"]["entropy_codecs"]["device-pack"]["count"] == 1
    assert st["compress"]["entropy_codecs"]["deflate"]["count"] == 2
    assert st["compress"]["fix_modes"]["host"] == 1


# ---------------------------------------------------------------------------
# watchdog, guards, launcher
# ---------------------------------------------------------------------------

def test_step_watchdog_verdicts_are_the_references():
    steps = [1.0, 1.1, 0.9, 5.0, 5.0, 5.0, 1.0, 4.0, 0.2, 3.5, 3.5, 3.5,
             3.5, 1.0]
    mine, ref = StepWatchdog(), JWatchdog()
    assert [mine.observe(t) for t in steps] == \
        [ref.observe(t) for t in steps]
    assert (mine.steps, mine.flagged_steps) == (ref.steps, ref.flagged_steps)
    eager = StepWatchdog(patience=1)
    assert [eager.observe(t) for t in (1.0, 9.0)] == ["ok", "rebalance"]
    with mine.timed() as timer:
        pass
    assert timer.verdict in ("ok", "slow", "rebalance")


def test_guards_are_thread_local(monkeypatch):
    monkeypatch.setattr(guards, "_is_device",
                        lambda t: isinstance(t, torch.Tensor))
    t = torch.arange(6.0)
    seen = {}

    def worker():
        try:
            seen["item"] = t.sum().item()        # unguarded thread
            seen["d2h"] = tdevice._d2h(t).sum()
            guards.note_compile("load libpack")
        except Exception as exc:                 # noqa: BLE001
            seen["error"] = exc

    with guards.no_recompiles(label="test") as compiled:
        with guards.no_transfers() as counts:
            with pytest.raises(guards.TransferError, match="item"):
                t.sum().item()
            with pytest.raises(guards.TransferError, match="cpu"):
                t.cpu()
            with pytest.raises(guards.TransferError):
                torch.equal(t, t)
            assert float(tdevice._d2h(t.sum())) == 15.0
            tdevice._h2d(np.zeros(4, np.float32), "cpu")
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        assert compiled == []
    assert "error" not in seen and seen["item"] == 15.0
    assert (counts.d2h, counts.h2d) == (1, 1)
    assert (counts.d2h_bytes, counts.h2d_bytes) == (4, 16)
    with pytest.raises(guards.RecompileError, match="nvcc"):
        with guards.no_recompiles(label="budget"):
            guards.note_compile("nvcc csrc/pack.cu")
    with guards.no_recompiles(max_compiles=1):
        guards.note_compile("load libpack")


def test_sanitizer_knob(monkeypatch):
    monkeypatch.setenv("MSZ_SANITIZERS", "1")
    assert guards.sanitizers_enabled()
    monkeypatch.setenv("MSZ_SANITIZERS", "off")
    assert not guards.sanitizers_enabled()
    monkeypatch.setenv("MSZ_SANITIZERS", "maybe")
    with pytest.raises(ValueError, match="MSZ_SANITIZERS"):
        guards.sanitizers_enabled()


def test_launcher_smoke(capsys):
    arts = tserve.main(["--smoke", "--mixed"], device="cpu")
    out = capsys.readouterr().out
    assert "verified: 8 artifacts" in out and out.strip().endswith("OK")
    assert len(arts) == 8
    # --devices 2 serves over a 2-block chain (on the CPU here) and
    # verifies every artifact against the one-shot pipeline
    arts2 = tserve.main(["--smoke", "--devices", "2"], device="cpu")
    out = capsys.readouterr().out
    assert "serving over 2 blocks" in out and "verified: 8 artifacts" in out
    assert all(a.backend == "sharded" for a in arts2)
