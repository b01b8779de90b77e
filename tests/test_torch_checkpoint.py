"""The port's checkpoints against ``repro``'s (format version 3).

For one training state (a bf16 smoke model after one AdamW step: bf16
params, f32 moments, an int32 step) held by both packages:

* the leaf keys are the reference's (``_tensor_key`` of
  ``tree_flatten_with_path``), in its order;
* under ``raw``, ``zlib`` and ``sz`` (every 2-D/3-D f32 tensor, or only
  those a filter picks) both packages write the same tensor files, byte
  for byte, and manifests with equal ``tensors``;
* each package restores the other's checkpoint bit for bit (``sz``: the
  bytes the reference's own restore gives);
* the port's manager behaves as ``tests/test_train.py`` holds the
  reference's: a corrupted newest checkpoint falls back to the older
  one, retention keeps the newest ``keep``, orphaned temp dirs are
  collected, a restored state continues its step count, and a
  checkpoint restores onto the device asked for."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import models as jmodels
from repro import train as jtrain
from repro.checkpoint.manager import _tensor_key
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch import tree
from repro_torch.convert import train_state_from_numpy


def _f32(a):
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32)) if jnp.issubdtype(
        a.dtype, jnp.floating) else np.asarray(a)


@pytest.fixture(scope="module")
def states():
    """The reference's state after one step of the bf16 smollm smoke
    model, and the same state in the port."""
    jcfg = jconfigs.get_smoke_config("smollm-135m")
    tcfg = tconfigs.get_smoke_config("smollm-135m")
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    p = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    state = jtrain.TrainState(p, jtrain.adamw_init(p))
    step = jtrain.make_train_step(jcfg, jtrain.TrainStepConfig(remat=False),
                                  jtrain.AdamWConfig(lr_peak=1e-2,
                                                     warmup_steps=1))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 17))
    state, _ = step(state, {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                            "labels": jnp.asarray(toks[:, 1:], jnp.int32)})
    tstate = train_state_from_numpy(jax.tree.map(_f32, state), tcfg, "cpu")
    return state, tstate


def _raw_bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.uint16).tobytes() if a.dtype == jnp.bfloat16 \
        else a.tobytes()


def test_keys_and_order_are_the_references(states):
    jstate, tstate = states
    want = [_tensor_key(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]
    got = [k for k, _ in tree.flatten_with_path(tstate)]
    assert got == want
    assert ".params/blocks/wq" in got and ".opt/.step" in got
    assert ".opt/.m/embed" in got
    for (_, j), t in zip(jax.tree_util.tree_flatten_with_path(jstate)[0],
                         tree.leaves(tstate)):
        assert _raw_bits(t) == _raw_bits(j)


LOSSY = {"none": None, "moments": lambda key: ".opt/.v/" in key}


@pytest.mark.parametrize("compress,lossy", [("raw", "none"),
                                            ("zlib", "none"),
                                            ("sz", "none"),
                                            ("sz", "moments")])
def test_same_files_and_manifest_tensors(states, tmp_path, compress, lossy):
    jstate, tstate = states
    kw = dict(compress=compress, lossy_filter=LOSSY[lossy])
    pj = jckpt.save_checkpoint(tmp_path / "ref", 3, jstate, **kw)
    pt = tckpt.save_checkpoint(tmp_path / "port", 3, tstate, **kw)
    assert pj.name == pt.name == "step_0000000003"
    files = sorted(f.name for f in pj.iterdir())
    assert sorted(f.name for f in pt.iterdir()) == files
    for name in files:
        if name != "manifest.json":
            assert (pt / name).read_bytes() == (pj / name).read_bytes(), name
    mj = json.loads((pj / "manifest.json").read_text())
    mt = json.loads((pt / "manifest.json").read_text())
    assert mt["tensors"] == mj["tensors"]
    assert (mt["format"], mt["step"]) == (mj["format"], mj["step"]) == (3, 3)
    codecs = {m["codec"] for m in mt["tensors"].values()}
    assert codecs == ({"raw"} if compress == "raw" else
                      {"zlib"} if compress == "zlib" else {"zlib", "sz"})
    assert mt["tensors"][".params/embed"]["jax_dtype"] == "bfloat16"
    assert mt["tensors"][".opt/.step"]["dtype"] == "int32"


@pytest.mark.parametrize("compress", ["zlib", "sz"])
def test_each_package_restores_the_others(states, tmp_path, compress):
    jstate, tstate = states
    jckpt.save_checkpoint(tmp_path / "ref", 5, jstate, compress=compress)
    tckpt.save_checkpoint(tmp_path / "port", 5, tstate, compress=compress)
    jlike = jax.tree.map(jnp.zeros_like, jstate)
    tlike = tree.tree_map(torch.zeros_like, tstate)
    j_own, s1 = jckpt.restore_checkpoint(tmp_path / "ref", jlike)
    j_port, s2 = jckpt.restore_checkpoint(tmp_path / "port", jlike)
    t_ref, s3 = tckpt.restore_checkpoint(tmp_path / "ref", tlike,
                                         device="cpu")
    t_own, s4 = tckpt.restore_checkpoint(tmp_path / "port", tlike)
    assert s1 == s2 == s3 == s4 == 5
    assert isinstance(t_ref, ttrain.TrainState)
    assert isinstance(t_ref.opt, ttrain.AdamWState)
    for (key, a), b, c, d in zip(tree.flatten_with_path(t_own),
                                 tree.leaves(t_ref), jax.tree.leaves(j_own),
                                 jax.tree.leaves(j_port)):
        assert a.dtype == b.dtype, key
        assert str(c.dtype) == str(d.dtype) == str(a.dtype).split(".")[-1]
        assert _raw_bits(a) == _raw_bits(b) == _raw_bits(c) == \
            _raw_bits(d), key
    if compress == "zlib":              # lossless: the state itself
        for a, b in zip(tree.leaves(t_ref), tree.leaves(tstate)):
            assert _raw_bits(a) == _raw_bits(b)


def test_corruption_falls_back_to_the_older_checkpoint(states, tmp_path):
    _, tstate = states
    tckpt.save_checkpoint(tmp_path, 1, tstate)
    p2 = tckpt.save_checkpoint(tmp_path, 2, tstate)
    next(p2.glob("t*.bin")).write_bytes(b"garbage")
    restored, step = tckpt.restore_checkpoint(
        tmp_path, tree.tree_map(torch.zeros_like, tstate))
    assert step == 1
    with pytest.raises(FileNotFoundError, match="checksum mismatch"):
        tckpt.restore_checkpoint(tmp_path, tstate, step=2)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path / "empty", tstate)


def test_manager_retention_and_orphan_collection(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, save_every=2, keep=2)
    orphan = tmp_path / ".tmp_ckpt_crashed"
    orphan.mkdir()
    (orphan / "t00000.bin").write_bytes(b"x")
    saved = [mgr.maybe_save(s, {"x": torch.ones(2) * s}) for s in range(1, 9)]
    assert [p is not None for p in saved] == [False, True] * 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_0000000006", "step_0000000008"]
    assert not orphan.exists()
    tree_, step = mgr.restore_latest({"x": torch.zeros(2)})
    assert step == 8 and torch.equal(tree_["x"], torch.full((2,), 8.0))
    # a checkpoint without its manifest is never loaded
    (tmp_path / "step_0000000008" / "manifest.json").unlink()
    assert mgr.restore_latest({"x": torch.zeros(2)})[1] == 6


def test_resume_continues_step_count(tmp_path):
    cfg = tconfigs.get_smoke_config("smollm-135m")
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    fn = ttrain.make_train_step(cfg, ttrain.TrainStepConfig(remat=False),
                                ttrain.AdamWConfig(lr_peak=1e-3,
                                                   warmup_steps=1,
                                                   decay_steps=10))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state, _ = fn(state, batch)
    tckpt.save_checkpoint(tmp_path, 1, state)
    restored, s = tckpt.restore_checkpoint(
        tmp_path, tree.tree_map(torch.zeros_like, state))
    assert int(restored.opt.step) == 1 and s == 1
    assert restored.opt.step.dtype == torch.int32
    assert restored.params["embed"].dtype == torch.bfloat16
    restored, _ = fn(restored, batch)
    assert int(restored.opt.step) == 2


def test_restore_places_on_the_device_asked_for(tmp_path, monkeypatch):
    """``device=`` decides where each tensor lands (here the CPU, named
    as the card would be); without it each lands where its ``like`` leaf
    lies."""
    seen = []
    from repro_torch.checkpoint import manager
    real = manager._h2d

    def h2d(x, dev):
        seen.append(str(dev))
        return real(x, "cpu")
    monkeypatch.setattr(manager, "_h2d", h2d)
    tckpt.save_checkpoint(tmp_path, 4, {"a": torch.ones(3),
                                        "b": torch.zeros(2, 2)})
    like = {"a": torch.zeros(3), "b": torch.zeros(2, 2)}
    tckpt.restore_checkpoint(tmp_path, like, device="cuda:1")
    assert seen == ["cuda:1", "cuda:1"]
    seen.clear()
    tckpt.restore_checkpoint(tmp_path, like)
    assert seen == ["cpu", "cpu"]
