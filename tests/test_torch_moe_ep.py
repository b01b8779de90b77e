"""The port's expert-parallel MoE (``layers.moe_ffn_ep``) against the
reference's.

The reference's EP engages only above 4096 tokens on an ambient mesh
with a ``model`` axis, so a child process with 8 emulated JAX devices
runs its ``moe_ffn_ep`` under ``use_mesh`` on (2, 4) and (1, 4) ``("data",
"model")`` meshes at 8192 tokens (E 8: an expert a shard pair; E 2: two
ff-sliced virtual experts an expert), capacity 1.25 and 8.0, and a hot
expert whose second dispatch drops copies; then its dense fallbacks and
``blocks.ffn_block`` under ``MOE_EP_MODE``. The port runs the same inputs
on CPU meshes of the same shapes: y within 1e-5 of max|y|, aux within
1e-6 relative; a fallback gives ``moe_ffn``'s bits.

The tokens and the router lie on a dyadic grid, so the router logits
are exact in both packages and both route alike (equal logits pick the
lower expert in both). With normal draws, at 8192 tokens two experts'
logits a few ulps apart (3.6113534 and 3.611353 in one draw) swap places
between XLA's and torch's softmax, which moves that token's output by
its small second gate: a rounding difference at the router's
discontinuity, in the dense ``moe_ffn`` as much as in EP.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import blocks, layers
from repro_torch.models.config import MoEConfig

ROOT = Path(__file__).resolve().parent.parent

#: (name, mesh shape, tokens (B, S), E, ff, capacity factor, hot expert)
CASES = (
    ("e8-2x4-cf1.25", (2, 4), (2, 4096), 8, 32, 1.25, False),
    ("e8-2x4-cf8", (2, 4), (2, 4096), 8, 32, 8.0, False),
    ("e2-2x4-cf1.25", (2, 4), (2, 4096), 2, 32, 1.25, False),
    ("e2-2x4-cf8", (2, 4), (2, 4096), 2, 32, 8.0, False),
    ("e8-1x4-cf1.25", (1, 4), (4, 2048), 8, 32, 1.25, False),
    ("e8-1x4-cf8", (1, 4), (4, 2048), 8, 32, 8.0, False),
    ("e2-1x4-cf1.25", (1, 4), (4, 2048), 2, 32, 1.25, False),
    ("e2-1x4-cf8", (1, 4), (4, 2048), 2, 32, 8.0, False),
    ("e8-1x4-hot", (1, 4), (4, 2048), 8, 32, 1.25, True),
)

#: the reference's dense fallbacks: (name, mesh shape, tokens, E, ff)
FALLBACKS = (
    ("at-4096-tokens", (2, 4), (1, 4096), 8, 32),
    ("ff-not-sliced", (2, 4), (2, 4096), 2, 33),
    ("tokens-not-split", (4, 2), (1, 4098), 8, 32),
)

_REF = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.models import layers
    from repro.models.sharding import use_mesh

    CASES, FALLBACKS, out = %(cases)r, %(fallbacks)r, sys.argv[1]
    d, K = 16, 2

    def grid(rng, shape, step):
        return np.clip(np.round(rng.normal(size=shape) / step) * step,
                       -2, 2).astype(np.float32)

    def inputs(seed, tokens, E, ff, hot):
        rng = np.random.default_rng(seed)
        x = grid(rng, tokens + (d,), 0.25)
        router = grid(rng, (d, E), 0.125)
        if hot:
            # expert 0 first for every token
            x[..., 0] = np.abs(x[..., 0]) + 1
            router[0, 0] = 4.0
        w = [(rng.normal(size=s) * 0.1).astype(np.float32)
             for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
        return x, dict(router=router, w_gate=w[0], w_up=w[1], w_down=w[2])

    def mesh_of(shape):
        devs = np.asarray(jax.devices()[:int(np.prod(shape))])
        return jax.sharding.Mesh(devs.reshape(shape), ("data", "model"))

    def ep(x, p, E, cf, shape):
        with use_mesh(mesh_of(shape)):
            r = jax.jit(lambda x, p: layers.moe_ffn_ep(x, p, E, K, cf))(x, p)
        return r

    res = {}
    for i, (name, shape, tokens, E, ff, cf, hot) in enumerate(CASES):
        x, p = inputs(i, tokens, E, ff, hot)
        r = ep(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
               E, cf, shape)
        # model shards of one data row hold their own y; the readback is
        # model shard 0's
        spread = max(float(np.abs(np.asarray(s.data)
                                  - np.asarray(r.y)[s.index]).max())
                     for s in r.y.addressable_shards)
        res.update({f"{name}/x": x, f"{name}/y": np.asarray(r.y),
                    f"{name}/aux": np.asarray(r.aux_loss),
                    f"{name}/replica_spread": np.asarray(spread),
                    **{f"{name}/p/{k}": v for k, v in p.items()}})
    for i, (name, shape, tokens, E, ff) in enumerate(FALLBACKS):
        x, p = inputs(100 + i, tokens, E, ff, False)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        r = ep(jnp.asarray(x), jp, E, 1.25, shape)
        dense = layers.moe_ffn(jnp.asarray(x), jp, E, K, 1.25)
        res[f"{name}/fell_back"] = np.asarray(
            bool(jnp.all(r.y == dense.y)) and float(r.aux_loss)
            == float(dense.aux_loss))
    np.savez(out, **res)
''') % {"cases": CASES, "fallbacks": FALLBACKS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def cpu_mesh(shape, names=("data", "model")):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [torch.device("cpu")] * arr.size
    return DeviceMesh(arr.reshape(shape), names)


def _params(ref, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_ep_matches_reference(ref, case):
    name, shape, tokens, E, ff, cf, hot = case
    x = torch.from_numpy(ref[f"{name}/x"])
    p = _params(ref, f"{name}/p/")
    with cpu_mesh(shape):
        out = layers.moe_ffn_ep(x, p, E, 2, cf)
    want_y, want_aux = ref[f"{name}/y"], float(ref[f"{name}/aux"])
    y = out.y.numpy()
    assert y.shape == want_y.shape and y.dtype == np.float32
    assert np.abs(y - want_y).max() <= 1e-5 * np.abs(want_y).max()
    assert abs(float(out.aux_loss) - want_aux) <= 1e-6 * abs(want_aux)
    # it is the EP path: over two data rows its aux is the mean of the
    # rows' losses, not the loss over all tokens (dense's)
    if shape[0] == 2 and E == 8:
        dense = float(layers.moe_ffn(x, p, E, 2, cf).aux_loss)
        assert abs(float(out.aux_loss) - dense) > 1e-5 * abs(dense)
    if hot:
        # the reference's model shards disagree here (the second dispatch
        # drops later copies of the hot expert); the readback is shard
        # 0's, which the port returns
        assert float(ref[f"{name}/replica_spread"]) > 0


@pytest.mark.parametrize("case", FALLBACKS, ids=[c[0] for c in FALLBACKS])
def test_dense_fallbacks_match_reference(ref, case, monkeypatch):
    name, shape, tokens, E, ff = case
    assert bool(ref[f"{name}/fell_back"])
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=tokens + (16,)).astype(np.float32))
    p = {"router": torch.from_numpy(rng.normal(size=(16, E))
                                    .astype(np.float32))}
    for k, s in (("w_gate", (E, 16, ff)), ("w_up", (E, 16, ff)),
                 ("w_down", (E, ff, 16))):
        p[k] = torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
    calls = []
    monkeypatch.setattr(layers, "_moe_ep_body",
                        lambda *a, **k: calls.append(1))
    with cpu_mesh(shape):
        out = layers.moe_ffn_ep(x, p, E, 2, 1.25)
    dense = layers.moe_ffn(x, p, E, 2, 1.25)
    assert not calls
    assert torch.equal(out.y, dense.y) and torch.equal(out.aux_loss,
                                                      dense.aux_loss)


@pytest.mark.parametrize("mesh", [None, ("data",), ("data_y", "data_z")])
def test_falls_back_without_a_sharded_mesh(mesh, monkeypatch):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 4096, 16)).astype(np.float32))
    p = {"router": torch.from_numpy(rng.normal(size=(16, 8))
                                    .astype(np.float32)),
         "w_gate": torch.ones((8, 16, 32)) * 0.01,
         "w_up": torch.ones((8, 16, 32)) * 0.02,
         "w_down": torch.ones((8, 32, 16)) * 0.03}
    monkeypatch.setattr(layers, "_moe_ep_body",
                        lambda *a, **k: pytest.fail("EP engaged"))
    ctx = cpu_mesh((1,) * len(mesh), mesh) if mesh else None
    if ctx is None:
        out = layers.moe_ffn_ep(x, p, 8, 2)
    else:
        with ctx:
            out = layers.moe_ffn_ep(x, p, 8, 2)
    assert torch.equal(out.y, layers.moe_ffn(x, p, 8, 2).y)


def test_ffn_block_dispatches_under_moe_ep_mode(ref, monkeypatch):
    """``blocks.ffn_block`` calls ``moe_ffn_ep`` under ``MOE_EP_MODE``
    (the reference's ``blocks.py:75``) and ``moe_ffn`` otherwise; its
    output is the residual plus that call's, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"),
                              d_model=16, d_ff=32, dtype="float32",
                              moe=MoEConfig(8, 2, 1.25))
    name = "e8-2x4-cf1.25"
    x = torch.from_numpy(ref[f"{name}/x"])
    p = _params(ref, f"{name}/p/")
    lp = {"ln2": torch.zeros(16), "router": p["router"],
          "moe_w_gate": p["w_gate"], "moe_w_up": p["w_up"],
          "moe_w_down": p["w_down"]}
    used = []
    for impl in ("moe_ffn", "moe_ffn_ep"):
        fn = getattr(layers, impl)
        monkeypatch.setattr(layers, impl, lambda *a, _f=fn, _n=impl, **k: (
            used.append(_n) or _f(*a, **k)))
    h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
    with cpu_mesh((2, 4)):
        blocks.ffn_block(cfg, lp, x)
        monkeypatch.setattr(layers, "MOE_EP_MODE", True)
        y, aux = blocks.ffn_block(cfg, lp, x)
        want = layers.moe_ffn_ep(h, p, 8, 2, 1.25)
    assert used == ["moe_ffn", "moe_ffn_ep", "moe_ffn_ep"]
    assert torch.equal(y, x + want.y) and torch.equal(aux, want.aux_loss)


def test_ep_runs_a_dispatch_and_an_expert_pass_a_shard(monkeypatch):
    """A (2, 4) mesh runs 8 dispatches and 8 expert passes, each on the
    device the mesh names for its shard (all "cpu" here; the card runs
    hold shards on cuda:0-3)."""
    seen = {"dispatch": [], "experts": []}
    dispatch, experts = layers._ep_dispatch, layers._ep_experts
    monkeypatch.setattr(layers, "_ep_dispatch", lambda xf, *a, **k: (
        seen["dispatch"].append(xf.device) or dispatch(xf, *a, **k)))
    monkeypatch.setattr(layers, "_ep_experts", lambda recv, *a, **k: (
        seen["experts"].append(recv.device) or experts(recv, *a, **k)))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 4096, 16)).astype(np.float32))
    p = {"router": torch.from_numpy(rng.normal(size=(16, 8))
                                    .astype(np.float32)),
         "w_gate": torch.ones((8, 16, 32)) * 0.01,
         "w_up": torch.ones((8, 16, 32)) * 0.02,
         "w_down": torch.ones((8, 32, 16)) * 0.03}
    with cpu_mesh((2, 4)):
        layers.moe_ffn_ep(x, p, 8, 2)
    assert seen["dispatch"] == seen["experts"] == [torch.device("cpu")] * 8
