"""The recurrent families split over the model axis, on the CPU: xLSTM's
mLSTM and sLSTM blocks and hymba's block on model shards
(``placement.ModelShards`` on single-process (1, tp) CPU meshes) against
the same block on whole weights, and against the reference's block.

* the mLSTM split by Dh (wv3, w_z3 and w_down3, the reference's layout)
  at 2 and 4 shards over two scan chunks; the sLSTM split by columns at
  2, 4 and 8 shards, at 8 with each shard's 8 columns half of one of
  its 4 heads; hymba's SSM, fused projection and MLP split by columns at
  2 and 4 shards, on the smoke config's 4/2 heads of 16 and on hymba's
  25/5 heads at d_head 8, whose 100 or 50 columns a shard cut heads:
  each shard scans the 13 or 7 heads its columns span, and attends with
  its whole query heads (``tests/test_torch_attention_tp.py``);
* the residual and the gradient of every weight and of x within
  ``test_torch_tensor_parallel``'s RTOL 1e-5 and ATOL 1e-5 of the
  unsplit tensor's largest value; the split forward within 1e-5 of the
  reference's ``repro.models.recurrent`` block on the same numpy weights;
* a block whose split weights are not all model-sharded raises;
* the unsplit ``mlstm_scan`` and ``ssm_scan`` bitwise the versions
  before the model axis split them (kept here as the reference), in f32
  and bf16, over one and several chunks.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from _torch_threads import one_thread  # noqa: F401
from repro_torch.distributed import placement as PL
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, recurrent

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm import _configs, _np, _weights  # noqa: E402
from test_torch_tensor_parallel import close, grads_match  # noqa: E402

#: the split forward against the reference's block (f32)
REF = dict(rtol=1e-5, atol=1e-5)
#: split weights -> the dim each splits along
MLSTM = {"wv3": 1, "w_z3": 1, "w_down3": 0}
SLSTM = {"w_zi": 1, "w_zf": 1, "w_zz": 1, "w_zo": 1, "w_down": 0}
HYMBA = {"wq": 1, "wk": 1, "wv": 1, "ssm_in": 1, "wo": 0, "w_gate": 1,
         "w_up": 1, "w_down": 0}


def layer_np(tree, group: str, index, seed: int) -> dict:
    """One layer's numpy weights of a stacked group, its norm weights
    (zeros at init) drawn normal * 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree[group].items():
        a = np.array(v[index], dtype=np.float32)
        if a.ndim == 1:
            a = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        out[k] = a
    return out


def leaves(lnp: dict) -> dict:
    return {k: torch.from_numpy(v.copy()).requires_grad_(True)
            for k, v in lnp.items()}


def split(lp: dict, dims: dict, tp: int) -> dict:
    """``lp`` with the weights of ``dims`` split over a (1, tp) mesh's
    model shards, each part a leaf that wants a gradient."""
    mesh = make_mesh((1, tp), ("data", "model"), devices=["cpu"] * tp)
    return {k: PL.ModelShards([p.detach().clone().requires_grad_(True)
                               for p in v.chunk(tp, dims[k])], dims[k],
                              mesh, 0, torch.device("cpu"))
            if k in dims else v for k, v in lp.items()}


def x_of(seed: int, B: int, S: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def check_split(got, want, sp, lp, x):
    close(got, want)
    names = sorted(lp)
    grads_match(got, want, [x] + [sp[k] for k in names],
                [x] + [lp[k] for k in names])


@pytest.fixture
def scan_shapes(monkeypatch):
    """The (x or v) shape of every ``mlstm_scan`` and ``ssm_scan`` call."""
    calls = []
    for name, arg in (("mlstm_scan", 2), ("ssm_scan", 0)):
        real = getattr(layers, name)

        def spy(*a, _real=real, _arg=arg, **kw):
            calls.append(tuple(a[_arg].shape))
            return _real(*a, **kw)
        monkeypatch.setattr(layers, name, spy)
    return calls


# --- xLSTM -------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_mlstm_splits_by_dh(tp, scan_shapes):
    """d 64, 2 heads of 32 over 320 positions (two chunks of 160): each
    shard's scan runs every head on its Dh / tp columns of v."""
    jcfg, cfg = _configs("xlstm-1.3b", dtype="float32")
    _, _, tree = _weights(jcfg, cfg)
    lnp = layer_np(tree, "mlstm", (0, 0), 1)
    xn = x_of(2, 2, 320, cfg.d_model)
    x = torch.from_numpy(xn).requires_grad_(True)
    lp = leaves(lnp)
    want = recurrent.mlstm_block(cfg, lp, x)
    scan_shapes.clear()
    sp = split(lp, MLSTM, tp)
    got = recurrent.mlstm_block(cfg, sp, x)
    assert scan_shapes == [(2, 320, 2, 32 // tp)] * tp
    check_split(got, want, sp, lp, x)
    # the reference over one chunk (over two, the frameworks' sums of
    # 160 decayed terms part by more than REF, split or not)
    np.testing.assert_allclose(
        _np(recurrent.mlstm_block(cfg, sp, x[:, :24]).detach()),
        _np(jrec.mlstm_block(jcfg, {k: jnp.asarray(v) for k, v in
                                    lnp.items()}, jnp.asarray(xn[:, :24]))),
        **REF)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_slstm_splits_by_columns(tp):
    """d 64 as 4 heads of 16: at 8 shards each shard's 8 columns are half
    a head; the scan is elementwise, so a cut head is still exact."""
    jcfg, cfg = _configs("xlstm-1.3b", dtype="float32", n_heads=4,
                         n_kv_heads=4)
    _, _, tree = _weights(jcfg, cfg)
    lnp = layer_np(tree, "slstm", 1, 3)
    xn = x_of(4, 2, 24, cfg.d_model)
    x = torch.from_numpy(xn).requires_grad_(True)
    lp = leaves(lnp)
    want = recurrent.slstm_block(cfg, lp, x)
    sp = split(lp, SLSTM, tp)
    got = recurrent.slstm_block(cfg, sp, x)
    check_split(got, want, sp, lp, x)
    np.testing.assert_allclose(
        _np(got.detach()), _np(jrec.slstm_block(
            jcfg, {k: jnp.asarray(v) for k, v in lnp.items()},
            jnp.asarray(xn))), **REF)


def test_a_split_without_every_weight_sharded_raises():
    jcfg, cfg = _configs("xlstm-1.3b", dtype="float32")
    _, _, tree = _weights(jcfg, cfg)
    lp = leaves(layer_np(tree, "mlstm", (0, 0), 1))
    sp = split(lp, {"wv3": 1, "w_z3": 1}, 2)
    with pytest.raises(ValueError, match="some weights"):
        recurrent.mlstm_block(cfg, sp, torch.randn(1, 4, cfg.d_model))


# --- hymba -------------------------------------------------------------------

#: (heads, KV heads, d_head): the smoke config's, and hymba's 25/5 heads
HYMBA_HEADS = {"4/2 of 16": (4, 2, 16), "25/5 of 8": (25, 5, 8)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("heads", list(HYMBA_HEADS))
def test_hymba_splits_its_ssm_fused_projection_and_mlp(heads, tp,
                                                       scan_shapes):
    """The sliding layer (window 8 over 16 positions): each shard scans
    the heads its columns of ``ssm_in`` span, [c0 // Dh, ceil(c1 / Dh)),
    the norm of each branch sums over the whole width, the attention
    splits by query heads; the block and every gradient (A_log, the
    replicated dt/B/C projections and norms included) match the unsplit
    block."""
    H, Hk, Dh = HYMBA_HEADS[heads]
    jcfg, cfg = _configs("hymba-1.5b", dtype="float32", n_heads=H,
                         n_kv_heads=Hk, d_head=Dh)
    _, _, tree = _weights(jcfg, cfg)
    lnp = layer_np(tree, "blocks", 1, 5)
    S = 16
    xn = x_of(6, 2, S, cfg.d_model)
    x = torch.from_numpy(xn).requires_grad_(True)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    positions = torch.from_numpy(pos.copy())
    lp = leaves(lnp)
    want, _, _ = recurrent.hymba_block(cfg, lp, x, positions, window=8)
    scan_shapes.clear()
    sp = split(lp, HYMBA, tp)
    got, _, _ = recurrent.hymba_block(cfg, sp, x, positions, window=8)
    n = H * Dh // tp
    spans = [-(-(c0 + n) // Dh) - c0 // Dh for c0 in range(0, H * Dh, n)]
    if heads == "25/5 of 8":
        assert spans == ([13] * 2 if tp == 2 else [7] * 4)
    assert scan_shapes == [(2, S, s, Dh) for s in spans]
    check_split(got, want, sp, lp, x)
    yj, _, _ = jrec.hymba_block(
        jcfg, {k: jnp.asarray(v) for k, v in lnp.items()}, jnp.asarray(xn),
        jnp.asarray(pos), window=8)
    np.testing.assert_allclose(_np(got.detach()), _np(yj), **REF)


# --- the unsplit scans -------------------------------------------------------

def _parent_mlstm_scan(q, k, v, log_f, log_i, chunk=256):
    """``layers.mlstm_scan`` before v could be narrower than q."""
    B, S, H, D = q.shape
    L = layers._pick_chunk(S, chunk)
    dev = q.device
    tri = layers._tril(L, dev)[None, :, :, None]
    C = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    for s0 in range(0, S, L):
        qc = q[:, s0:s0 + L].float() * (D ** -0.5)
        kc = k[:, s0:s0 + L].float()
        vc = v[:, s0:s0 + L].float()
        li = log_i[:, s0:s0 + L].float()
        LF = torch.cumsum(log_f[:, s0:s0 + L].float(), dim=1)
        tot = LF[:, -1]
        w = torch.exp((LF[:, :, None] - LF[:, None] + li[:, None])
                      .masked_fill(~tri, float("-inf")))
        dec = torch.exp(LF)
        h_inter = torch.einsum("bhde,blhe->blhd", C, qc) * dec[..., None]
        n_inter = dec[..., None] * n[:, None]
        A = torch.einsum("blhd,bmhd->blmh", qc, kc) * w
        h_intra = torch.einsum("blmh,bmhd->blhd", A, vc)
        denom = torch.abs((n_inter * qc).sum(-1) + A.sum(2))
        out[:, s0:s0 + L] = ((h_inter + h_intra)
                             / torch.clamp_min(denom, 1.0)[..., None])
        wk = torch.exp(tot[:, None] - LF + li)
        et = torch.exp(tot)
        C = et[..., None, None] * C + torch.einsum(
            "blhd,blhe->bhde", vc * wk[..., None], kc)
        n = et[..., None] * n + torch.einsum("blh,blhd->bhd", wk, kc)
    return out


def _parent_ssm_scan(x, delta, Bmat, Cmat, A_log, chunk=256):
    """``layers.ssm_scan`` as it was before the model axis split it
    (without grad: its in-place form)."""
    B, S, H, D = x.shape
    L = layers._pick_chunk(S, chunk)
    dev = x.device
    A = -torch.exp(A_log.float())
    dt = layers._softplus(delta.float())
    lg = dt[..., None] * A
    xB = dt[..., None] * Bmat.float()
    above = ~layers._tril(L, dev)[None, :, :, None, None]
    h = torch.zeros((B, H, Bmat.shape[-1], D), dtype=torch.float32,
                    device=dev)
    out = torch.empty((B, S, H, D), dtype=x.dtype, device=dev)
    for s0 in range(0, S, L):
        xc = x[:, s0:s0 + L].float()
        bc = xB[:, s0:s0 + L]
        cc = Cmat[:, s0:s0 + L].float()
        LG = torch.cumsum(lg[:, s0:s0 + L], dim=1)
        tot = LG[:, -1]
        y = torch.einsum("blhn,bhnd->blhd", cc * torch.exp(LG), h)
        w = (LG[:, :, None] - LG[:, None]).masked_fill_(
            above, float("-inf")).exp_()
        cb = w.mul_(cc[:, :, None]).mul_(bc[:, None]).sum(-1)
        del w
        y += torch.einsum("blmh,bmhd->blhd", cb, xc)
        out[:, s0:s0 + L] = y
        wk = torch.exp(tot[:, None] - LG)
        h = torch.exp(tot)[..., None] * h + torch.einsum(
            "blhn,blhd->bhnd", wk * bc, xc)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk", [(48, 256), (96, 32)])
def test_unsplit_scans_are_bitwise_the_parents(S, chunk, dtype):
    g = torch.Generator().manual_seed(7)
    B, H, D, N = 2, 3, 16, 4

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)
    q, k, v = r(B, S, H, D), r(B, S, H, D), r(B, S, H, D)
    log_f = torch.nn.functional.logsigmoid(torch.randn(B, S, H,
                                                       generator=g) + 3)
    log_i = torch.randn(B, S, H, generator=g)
    assert torch.equal(layers.mlstm_scan(q, k, v, log_f, log_i, chunk),
                       _parent_mlstm_scan(q, k, v, log_f, log_i, chunk))
    x, delta = r(B, S, H, D), r(B, S, H)
    Bm, Cm = r(B, S, H, N), r(B, S, H, N)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand(
        H, N)
    assert torch.equal(layers.ssm_scan(x, delta, Bm, Cm, A_log, chunk),
                       _parent_ssm_scan(x, delta, Bm, Cm, A_log, chunk))
