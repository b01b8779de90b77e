"""The port's block-sharded fix loop (``repro_torch.distributed.shardfix``)
against the reference, on the CPU with every block on ``"cpu"``:
block plans and halo accounting against the reference's own functions
called with the port's mesh object; the loop, ``fused_fix(mesh=)`` and
one sharded step bitwise the reference's solo loop (g, iterations) on
2D and 3D fields, chains and block meshes, overlap and worklist on and
off; the copied halo bytes against ``halo_plan``; the sharded transform,
reconstruction and scatter against the reference's single-device
functions; whole artifacts under both entropy codecs; the registry; the
stream and the service with a mesh; and, in a child process with four
emulated JAX devices, the reference's own sharded loop."""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import pipeline as jpipe
from repro.core import backend as jbackend
from repro.core import fixes as jfixes
from repro.data import synthetic_field
from repro.distributed import shardfix as jsf
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import szlike as tsz
from repro_torch.compress import (CompressStream, DecompressStream,
                                  compress_preserving_mss,
                                  compress_preserving_mss_batch,
                                  decompress_artifact_batch,
                                  decompress_preserving_mss)
from repro_torch.core import backend as tbackend
from repro_torch.core import derive_edits, derive_edits_batch
from repro_torch.core import fixes as tfixes
from repro_torch.debug import guards
from repro_torch.distributed import shardfix as tsf
from repro_torch.launch.mesh import (DeviceMesh, factor_block_shape,
                                     make_block_mesh, make_data_mesh)
from repro_torch.serve import CompressionService, ServiceConfig

ROOT = Path(__file__).resolve().parent.parent
CPU = dict(device="cpu")


def _cpu_mesh(shape):
    """A chain (int) or a block mesh (tuple) with every block on the
    CPU."""
    if isinstance(shape, int):
        return make_data_mesh(shape, devices=["cpu"] * shape)
    return make_block_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _pair(shape, seed=0, xi=0.3):
    """A noise field and a perturbation within ``xi`` (the reference's
    sharded tests' inputs): tie-free, many iterations."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    fh = (f + rng.uniform(-xi, xi, size=shape) * 0.999).astype(np.float32)
    return f, fh, xi


def _ties(shape, seed=0):
    """A tie-heavy field (values on a coarse grid) and a perturbation:
    SoS tie-breaks decide most directions, so a wrong corner ghost
    changes the result."""
    rng = np.random.default_rng(seed)
    f = (rng.integers(0, 4, size=shape) * 0.25).astype(np.float32)
    fh = (f + rng.uniform(-0.2, 0.2, size=shape)).astype(np.float32)
    return f, fh, 0.2


_SOLO = {}


def _solo(shape, kind="noise"):
    """The reference's solo loop (backend "reference"): (f, fh, xi,
    port topo, g, iters)."""
    key = (shape, kind)
    if key not in _SOLO:
        f, fh, xi = (_pair(shape, seed=sum(shape)) if kind == "noise"
                     else _ties(shape, seed=sum(shape)))
        topo = jfixes.field_topology(jnp.asarray(f), xi)
        g, it, ok = jfixes.fused_fix(jnp.asarray(fh), topo,
                                     backend="reference")
        assert bool(ok)
        ttopo = tfixes.field_topology(torch.from_numpy(f), xi)
        _SOLO[key] = (f, fh, xi, ttopo, np.asarray(g), int(it))
    return _SOLO[key]


# ---------------------------------------------------------------------------
# meshes, plans and halo accounting
# ---------------------------------------------------------------------------

def test_meshes_take_the_reference_axis_names_and_placements():
    m = make_data_mesh(4, devices=["cpu"] * 4)
    assert m.axis_names == ("data",) and m.shape == {"data": 4}
    assert m.devices.shape == (4,) and m.devices[2] == torch.device("cpu")
    b = make_block_mesh((2, 3), devices=["cpu"] * 6)
    assert b.axis_names == ("data_y", "data_z")
    assert b.shape == {"data_y": 2, "data_z": 3}
    c = make_block_mesh((2, 1, 2), devices=["cpu"] * 4)
    assert c.axis_names == ("data_x", "data_y", "data_z")
    assert make_block_mesh("auto", ndim=3, devices=["cpu"] * 8).shape == {
        "data_x": 2, "data_y": 2, "data_z": 2}
    from repro.launch.mesh import factor_block_shape as jfactor
    for n, nd in itertools.product((1, 2, 4, 6, 7, 8, 12), (1, 2, 3)):
        assert factor_block_shape(n, nd) == jfactor(n, nd)
    with pytest.raises(ValueError, match="placement"):
        make_data_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="1-3 positive"):
        make_block_mesh((2, 0), devices=["cpu"] * 2)


def test_more_blocks_than_cards_raises_without_devices():
    """Nothing moves to the CPU on its own: without ``devices=`` a mesh
    takes a visible card a block and raises when there are too few."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA device"):
        make_data_mesh(n)
    with pytest.raises(ValueError, match="CUDA device"):
        make_block_mesh((n, 1))


def test_with_mesh_is_the_active_mesh():
    m = _cpu_mesh((2, 2))
    assert tsf.active_data_mesh() is None
    with m:
        assert tsf.active_data_mesh() is m
        assert tsf.data_axis_size(tsf.active_data_mesh()) == 4
        with _cpu_mesh(2) as inner:
            assert tsf.active_data_mesh() is inner
        assert tsf.active_data_mesh("data") is None
    assert tsf.active_data_mesh() is None


MESHES = [2, 3, 4, 8, (2, 2), (2, 4), (2, 1, 2), (2, 2, 2), (1, 2), (1,)]
SHAPES = [(12, 10, 9), (13, 7, 11), (3, 5, 4), (20, 17), (9, 30)]


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_plans_and_halo_plans_equal_the_reference(mesh_shape):
    mesh = _cpu_mesh(mesh_shape)
    for shape in SHAPES:
        x3 = "data_x" in mesh.axis_names and mesh.shape["data_x"] > 1
        if len(shape) == 2 and x3:
            with pytest.raises(ValueError, match="2D fields shard"):
                tsf.plan_blocks(shape, mesh)
            with pytest.raises(ValueError, match="2D fields shard"):
                jsf.plan_blocks(shape, mesh)
            continue
        tp, jp = tsf.plan_blocks(shape, mesh), jsf.plan_blocks(shape, mesh)
        assert (tp.shape, tp.names, tp.legacy) == (jp.shape, jp.names,
                                                  jp.legacy)
        assert [tuple(a) for a in tp.sharded] == [tuple(a)
                                                  for a in jp.sharded]
        assert tp.block_shape() == jp.block_shape()
        assert tp.padded_shape() == jp.padded_shape()
        for ov, wl, dt in itertools.product((None, True, False),
                                            (None, False),
                                            (np.float32, np.float64)):
            assert tsf.halo_plan(shape, dt, mesh, overlap=ov, worklist=wl) \
                == jsf.halo_plan(shape, dt, mesh, overlap=ov, worklist=wl)
            assert tsf._resolve_modes(tp, ov, wl) == \
                jsf._resolve_modes(jp, ov, wl)


def test_plan_refusals_are_the_reference_errors():
    mixed = DeviceMesh(np.full((2, 2), torch.device("cpu"), dtype=object),
                       ("data", "data_y"))
    none = DeviceMesh(np.full((2,), torch.device("cpu"), dtype=object),
                      ("model",))
    for mesh in (mixed, none):
        with pytest.raises(ValueError) as ep:
            tsf.plan_blocks((8, 8, 8), mesh)
        with pytest.raises(ValueError) as er:
            jsf.plan_blocks((8, 8, 8), mesh)
        # the texts differ only where they print the mesh object
        assert str(ep.value).split(";")[0].split("(")[0] == \
            str(er.value).split(";")[0].split("(")[0]
    with pytest.raises(ValueError, match="2D/3D"):
        tsf.plan_blocks((4,), _cpu_mesh(2))
    with pytest.raises(ValueError, match="has no 'data_q' axis"):
        tsf.plan_blocks((8, 8), _cpu_mesh(2), axis_name="data_q")


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

LOOP_CASES = [((12, 10, 9), 4), ((12, 10, 9), (2, 2)),
              ((12, 10, 9), (2, 1, 2)), ((13, 11, 10), (2, 2, 2)),
              ((20, 17), (2, 2)), ((23, 19), 3), ((9, 7, 6), 8),
              ((3, 6, 5), 4)]


@pytest.mark.parametrize("shape,mesh_shape", LOOP_CASES)
def test_sharded_fix_is_bitwise_the_solo_loop(shape, mesh_shape):
    """Every (overlap, worklist) combination gives the reference solo
    loop's g and iteration count, and with the worklist off copies
    exactly ``halo_plan`` bytes an iteration. (3, 6, 5) over 4 blocks
    has more blocks than slabs: one slab a block, the last block all
    padding."""
    f, fh, xi, topo, g_ref, it_ref = _solo(shape)
    mesh = _cpu_mesh(mesh_shape)
    for ov, wl in itertools.product((None, False, True), (None, False, True)):
        tsf.reset_halo_bytes()
        g, it, ok = tsf.sharded_fix(torch.from_numpy(fh), topo, mesh,
                                    overlap=ov, worklist=wl)
        assert ok and it == it_ref, (ov, wl)
        assert np.array_equal(g.numpy(), g_ref), (ov, wl)
        plan = tsf.halo_plan(shape, np.float32, mesh, overlap=ov,
                             worklist=wl)
        assert tsf.halo_bytes == {k: v * it for k, v in plan.items()}


@pytest.mark.parametrize("shape,mesh_shape", [((10, 12, 11), (2, 2)),
                                              ((14, 13), (2, 2)),
                                              ((10, 9, 12), (2, 1, 2))])
def test_tie_heavy_fields_agree_at_block_corners(shape, mesh_shape):
    """The two-phase exchange's corner ghosts decide SoS ties on a field
    of quarter values; a wrong corner changes g only there."""
    f, fh, xi, topo, g_ref, it_ref = _solo(shape, kind="ties")
    for ov in (False, True):
        g, it, ok = tsf.sharded_fix(torch.from_numpy(fh), topo,
                                    _cpu_mesh(mesh_shape), overlap=ov)
        assert ok and it == it_ref
        assert np.array_equal(g.numpy(), g_ref)


def test_fused_fix_and_one_step_through_the_mesh():
    f, fh, xi, topo, g_ref, it_ref = _solo((12, 10, 9))
    mesh = _cpu_mesh((2, 2))
    g, it, ok = tfixes.fused_fix(torch.from_numpy(fh), topo, mesh=mesh)
    assert ok and it == it_ref and np.array_equal(g.numpy(), g_ref)
    with mesh:
        g, it, ok = tfixes.fused_fix(torch.from_numpy(fh), topo)
    assert it == it_ref and np.array_equal(g.numpy(), g_ref)
    jtopo = jfixes.field_topology(jnp.asarray(f), xi)
    jg, jv = jfixes.fused_pass(jnp.asarray(fh), jtopo, backend="reference")
    tg, tv = tfixes.fused_pass(torch.from_numpy(fh), topo,
                               backend=tsf.ShardedBackend(mesh=mesh))
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert int(tv) == int(jv) and tv.dtype == torch.int32


def test_halo_helpers_extend_blocks_with_neighbour_faces():
    """``with_halo`` (the 1-axis helper) is ``block_halo`` at depth 1;
    chain ends get zeros, inner faces the neighbours' slabs."""
    mesh = _cpu_mesh(3)
    x = torch.arange(6 * 2 * 2, dtype=torch.float32).reshape(6, 2, 2)
    lay = tsf._Layout(tsf.plan_blocks(x.shape, mesh), mesh)
    blocks = lay.split(x)
    ext = tsf.with_halo(blocks, lay)
    for bid, e in ext.items():
        assert torch.equal(e, tsf.block_halo(blocks, lay, 1)[bid])
    assert torch.equal(ext[(0,)][0], torch.zeros(2, 2))
    assert torch.equal(ext[(1,)], x[1:5]) and torch.equal(ext[(2,)][:3],
                                                          x[3:6])


def test_a_size_one_axis_copies_nothing():
    """A size-1 mesh axis moves no face: a (1, 2) mesh copies along
    data_z only, a one-block mesh nothing at all."""
    f, fh, xi, topo, g_ref, it_ref = _solo((12, 10, 9))
    for mesh_shape, axes in (((1, 2), {"data_z"}), ((1,), set()),
                             (1, set())):
        tsf.reset_halo_bytes()
        g, it, ok = tsf.sharded_fix(torch.from_numpy(fh), topo,
                                    _cpu_mesh(mesh_shape))
        assert it == it_ref and np.array_equal(g.numpy(), g_ref)
        assert set(tsf.halo_bytes) == axes


def test_the_worklist_skips_blocks_and_stays_exact(monkeypatch):
    """A field whose violations sit in one corner: with the worklist
    the far blocks stop running, and g and the iterations stay the
    dense loop's."""
    rng = np.random.default_rng(3)
    f = np.linspace(0, 1, 16 * 12 * 10, dtype=np.float32).reshape(16, 12, 10)
    fh = f.copy()
    fh[:3, :3, :3] += rng.uniform(-2e-3, 2e-3, (3, 3, 3)).astype(np.float32)
    topo = tfixes.field_topology(torch.from_numpy(f), 2e-3)
    ft = torch.from_numpy(fh)
    g_d, it_d, _ = tfixes.fused_fix(ft, topo, backend="reference")
    runs = []
    orig = tsf._BlockLoop.step_plain

    def counting(self, tally=None):
        runs.append(sum(self.run.values()))
        return orig(self, tally)

    monkeypatch.setattr(tsf._BlockLoop, "step_plain", counting)
    g, it, ok = tsf.sharded_fix(ft, topo, _cpu_mesh(4), worklist=True)
    assert it == it_d and torch.equal(g, g_d)
    assert it_d >= 2 and runs[0] == 4 and min(runs[1:]) < 4


# ---------------------------------------------------------------------------
# the transform, its inverse and the scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mesh_shape", [((12, 10, 9), 4),
                                              ((13, 10, 9), (2, 2)),
                                              ((9, 11, 7), (2, 1, 2)),
                                              ((30, 17), (2, 2)),
                                              ((5, 6, 7), 8)])
def test_transform_reconstruct_scatter_equal_the_reference(shape,
                                                           mesh_shape):
    f = synthetic_field("nyx" if len(shape) == 3 else "climate",
                        shape).astype(np.float32)
    step = 1e-3 * float(np.ptp(f))
    jref = jbackend.get_backend("reference")
    r_ref = np.asarray(jref.transform(jnp.asarray(f), step))
    fh_ref = np.asarray(jref.reconstruct(jnp.asarray(r_ref), step,
                                         jnp.float32))
    be = tsf.ShardedBackend(mesh=_cpu_mesh(mesh_shape))
    step_t = torch.tensor(step, dtype=torch.float32)
    r = be.transform(torch.from_numpy(f), step_t)
    assert r.dtype == torch.int32 and np.array_equal(r.numpy(), r_ref)
    fh = be.reconstruct(r, step_t, torch.float32)
    assert np.array_equal(fh.numpy(), fh_ref)
    # int32 wraparound: the prefix sums wrap as the global cumsum does
    big = np.full(shape, 2 ** 30, np.int32)
    assert np.array_equal(
        be.reconstruct(torch.from_numpy(big), step_t, torch.float32).numpy(),
        np.asarray(jref.reconstruct(jnp.asarray(big), step, jnp.float32)))
    rng = np.random.default_rng(1)
    n = f.size
    idx = np.sort(rng.choice(n, size=n // 5, replace=False)).astype(np.int32)
    val = rng.normal(size=idx.size).astype(np.float32)
    # one-past-the-end and later indices (a padded stream's) drop
    idx_p = np.concatenate([idx, [n, n + 7]]).astype(np.int32)
    val_p = np.concatenate([val, [1.0, 2.0]]).astype(np.float32)
    g_ref = np.asarray(jref.scatter_edits(jnp.asarray(fh_ref),
                                          jnp.asarray(idx_p),
                                          jnp.asarray(val_p)))
    g = be.scatter_edits(fh, torch.from_numpy(idx_p),
                         torch.from_numpy(val_p))
    assert np.array_equal(g.numpy(), g_ref)


# ---------------------------------------------------------------------------
# whole artifacts
# ---------------------------------------------------------------------------

KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic")


@pytest.mark.parametrize("entropy", ["deflate", "device-pack"])
@pytest.mark.parametrize("name,shape,mesh_shape", [
    ("nyx", (12, 16, 20), (2, 2)), ("climate", (24, 32), (2, 2)),
    ("nyx", (13, 10, 11), (2, 1, 2)), ("nyx", (10, 9, 8), 4)])
def test_artifacts_through_a_mesh_are_the_reference_bytes(name, shape,
                                                          mesh_shape,
                                                          entropy):
    f = synthetic_field(name, shape).astype(np.float32)
    xi = 1e-3 * float(np.ptp(f))
    ref = jpipe.compress_preserving_mss(f, xi, backend="reference",
                                        entropy=entropy)
    mesh = _cpu_mesh(mesh_shape)
    art = compress_preserving_mss(f, xi, mesh=mesh, entropy=entropy, **CPU)
    assert art.backend == "sharded" and art.path == "device"
    for k in KEYS:
        assert getattr(art, k) == getattr(ref, k), k
    g_ref = jpipe.decompress_preserving_mss(ref, backend="reference")
    g = decompress_preserving_mss(art, mesh=mesh, **CPU)
    assert np.array_equal(g, g_ref)
    gs = decompress_artifact_batch([art, art], mesh=mesh, **CPU)
    assert all(np.array_equal(x, g_ref) for x in gs)


def test_batches_and_derive_edits_through_a_mesh():
    fields = [synthetic_field("nyx", (10, 12, 9), seed=s).astype(np.float32)
              for s in range(3)]
    xis = [c * float(np.ptp(f)) for c, f in zip((1e-2, 3e-3, 1e-3), fields)]
    mesh = _cpu_mesh((2, 2))
    solo = [compress_preserving_mss(f, x, **CPU) for f, x in zip(fields,
                                                                 xis)]
    arts = compress_preserving_mss_batch(fields, xis, mesh=mesh, **CPU)
    for a, b in zip(arts, solo):
        for k in KEYS:
            assert getattr(a, k) == getattr(b, k), k
    host = compress_preserving_mss_batch(fields, xis, mesh=mesh,
                                         device_path=False, **CPU)
    for a, b in zip(host, solo):
        assert a.base_payload == b.base_payload
        assert a.edit_payload == b.edit_payload
    f_b = np.stack(fields)
    fh_b = np.stack([tsz.sz_decompress(tsz.sz_compress(f, x))
                     for f, x in zip(fields, xis)])
    res = derive_edits_batch(f_b, fh_b, xis, mesh=mesh, **CPU)
    for i, r in enumerate(res):
        one = derive_edits(fields[i], fh_b[i], xis[i], **CPU)
        assert r.backend == "sharded" and r.iters == one.iters
        assert np.array_equal(r.g, one.g)
        assert np.array_equal(r.edits_idx, one.edits_idx)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_and_auto_resolution():
    assert "sharded" in tbackend.available_backends()
    mesh = _cpu_mesh((2, 2))
    be = tbackend.resolve_backend("auto", (8, 8, 8), torch.float32, "cpu",
                                  mesh=mesh)
    assert be.name == "sharded" and be.mesh is mesh
    with mesh:
        be = tfixes._bind(tbackend.resolve_backend("auto", (8, 8, 8),
                                                   torch.float32, "cpu"))
        assert be.name == "sharded" and be.mesh is mesh
    # one block is no mesh to shard over: auto takes the solo backend
    assert tbackend.resolve_backend(
        "auto", (8, 8, 8), torch.float32, "cpu",
        mesh=_cpu_mesh(1)).name == "reference"
    assert tbackend.resolve_backend("auto", (8, 8, 8), torch.float32,
                                    "cpu").name == "reference"
    with pytest.raises(ValueError) as ep:
        tbackend.resolve_backend("sharded", (8, 8, 8), torch.float32, "cpu")
    with pytest.raises(ValueError) as er:
        jbackend.resolve_backend("sharded", (8, 8, 8), np.float32)
    assert str(ep.value) == str(er.value)
    assert "needs a mesh" in str(ep.value)
    with pytest.raises(ValueError) as ep:
        tbackend.resolve_backend("sharded", (8,), torch.float32, "cpu",
                                 mesh=mesh)
    with pytest.raises(ValueError) as er:
        jbackend.resolve_backend("sharded", (8,), np.float32, mesh=mesh)
    assert str(ep.value).replace("torch.float32", "float32") == \
        str(er.value).replace("<class 'numpy.float32'>", "float32")
    with pytest.raises(ValueError, match="no dirty-slab worklist"):
        tfixes.fused_fix_worklist(torch.zeros(4, 4, 4), None,
                                  backend="sharded", mesh=mesh)


# ---------------------------------------------------------------------------
# the stream and the service
# ---------------------------------------------------------------------------

def _traffic(shape, n):
    fields = [synthetic_field("nyx", shape=shape, seed=s).astype(np.float32)
              for s in range(n)]
    return fields, [1e-3 * float(np.ptp(f)) for f in fields]


def test_stream_with_a_mesh_serves_the_solo_bytes_and_counts_halos():
    fields, xis = _traffic((12, 10, 9), 3)
    mesh = _cpu_mesh((2, 2))
    solo = [compress_preserving_mss(f, x, **CPU) for f, x in zip(fields, xis)]
    with CompressStream(window=4, max_batch=4, linger_ms=50, mesh=mesh,
                        **CPU) as cs:
        arts = [fut.result(timeout=120)
                for fut in [cs.submit(f, x) for f, x in zip(fields, xis)]]
        st = cs.stats()
    for a, b in zip(arts, solo):
        for k in KEYS:
            assert getattr(a, k) == getattr(b, k), k
    plan = tsf.halo_plan((12, 10, 9), np.float32, mesh)
    iters = sum(a.fix_iters for a in arts)
    shard = st["shard"]
    assert shard["fix_iters"] == iters
    assert shard["halo_bytes_by_axis"] == {k: v * iters
                                           for k, v in plan.items()}
    assert shard["halo_bytes_total"] == sum(plan.values()) * iters
    assert shard["last"] == {"shape": (12, 10, 9), "dtype": "float32",
                             "backend": "sharded"}
    assert st["padded_members"] == 0 and st["fix_modes"] == {"fused": 1}
    with DecompressStream(window=4, mesh=mesh, **CPU) as ds:
        gs = [fut.result(timeout=60) for fut in [ds.submit(a) for a in arts]]
    for g, a in zip(gs, solo):
        assert np.array_equal(g, decompress_preserving_mss(a, **CPU))


def test_mesh_stream_sanitized_device_pack(monkeypatch):
    """Under ``MSZ_SANITIZERS=1`` (every tensor counted as a device
    tensor) the sharded device stage makes no unaudited read: one
    device->host read an iteration, through ``device._d2h``."""
    fields, xis = _traffic((10, 9, 8), 2)
    refs = [compress_preserving_mss(f, x, entropy="device-pack", **CPU)
            for f, x in zip(fields, xis)]
    monkeypatch.setenv("MSZ_SANITIZERS", "1")
    monkeypatch.setattr(guards, "_is_device",
                        lambda t: isinstance(t, torch.Tensor))
    with CompressStream(window=2, max_batch=2, linger_ms=50,
                        mesh=_cpu_mesh((2, 2)), **CPU) as cs:
        arts = [fut.result(timeout=120) for fut in
                [cs.submit(f, x, entropy="device-pack")
                 for f, x in zip(fields, xis)]]
        st = cs.stats()
    assert st["failed"] == 0
    for a, b in zip(arts, refs):
        assert a.base_payload == b.base_payload
        assert a.edit_payload == b.edit_payload


def test_service_with_a_mesh_and_its_shard_timings():
    fields, xis = _traffic((12, 10, 9), 2)
    mesh = _cpu_mesh((2, 2))
    solo = [compress_preserving_mss(f, x, **CPU) for f, x in zip(fields, xis)]
    with CompressionService(ServiceConfig(mesh=mesh, **CPU)) as svc:
        assert svc.shard_timings() is None      # nothing sharded yet
        arts = [svc.compress(f, x) for f, x in zip(fields, xis)]
        gs = [svc.decompress(a) for a in arts]
        st = svc.stats()
        assert st["shard_timings"] is None
        t = svc.shard_timings(refresh=True)
        assert svc.stats()["shard_timings"] == t
        assert svc.shard_timings() is t         # served from the cache
    for a, b, g in zip(arts, solo, gs):
        assert a.base_payload == b.base_payload
        assert a.edit_payload == b.edit_payload
        assert np.array_equal(g, decompress_preserving_mss(b, **CPU))
    iters = sum(a.fix_iters for a in arts)
    plan = tsf.halo_plan((12, 10, 9), np.float32, mesh)
    assert st["compress"]["shard"]["halo_bytes_by_axis"] == {
        k: v * iters for k, v in plan.items()}
    # the keys of the reference's probe on an overlapping block mesh
    assert set(t) == {"shape", "dtype", "t_interior_s", "t_exchange_s",
                      "t_full_s", "t_boundary_s", "overlap"}
    assert t["overlap"] is True and t["shape"] == [12, 10, 9]
    assert all(t[k] >= 0.0 for k in t if k.startswith("t_"))
    assert tsf.time_step_parts(
        torch.zeros(12, 10, 9),
        tfixes.field_topology(torch.zeros(12, 10, 9), 0.1),
        _cpu_mesh(8)).keys() == {"t_full_s", "overlap"}  # blocks of 2


# ---------------------------------------------------------------------------
# the reference's own sharded loop, on four emulated devices
# ---------------------------------------------------------------------------

_CHILD = r"""
import numpy as np, jax.numpy as jnp, torch
torch.set_num_threads(1)
from repro.core import fixes as jfixes
from repro.distributed import shardfix as jsf
from repro.launch import mesh as jmesh
from repro_torch.core import fixes as tfixes
from repro_torch.distributed import shardfix as tsf
from repro_torch.launch import mesh as tmesh
rng = np.random.default_rng(12 + 10 + 9)
f = rng.normal(size=(12, 10, 9)).astype(np.float32)
fh = (f + rng.uniform(-0.3, 0.3, size=f.shape) * 0.999).astype(np.float32)
jtopo = jfixes.field_topology(jnp.asarray(f), 0.3)
ttopo = tfixes.field_topology(torch.from_numpy(f), 0.3)
pairs = [(jmesh.make_data_mesh(4), tmesh.make_data_mesh(4, devices=["cpu"] * 4)),
         (jmesh.make_block_mesh((2, 2)),
          tmesh.make_block_mesh((2, 2), devices=["cpu"] * 4))]
for jm, tm in pairs:
    for ov in (False, True):
        jg, jit, jok = jsf.sharded_fix(jnp.asarray(fh), jtopo, jm, overlap=ov)
        tg, tit, tok = tsf.sharded_fix(torch.from_numpy(fh), ttopo, tm,
                                       overlap=ov)
        assert int(jit) == tit and bool(jok) == tok, (jit, tit)
        assert np.array_equal(np.asarray(jg), tg.numpy()), (jm, ov)
        print("same", dict(tm.shape), ov, tit)
print("OK")
"""


def test_the_reference_sharded_loop_on_emulated_devices():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "OK"
    assert proc.stdout.count("same") == 4
