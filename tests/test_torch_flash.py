"""The port's flash attention against ``repro``'s.

* ``kernels.flash.flash_attention_plain`` (what the CUDA kernel computes)
  against the Pallas kernel ``flash_attention_pallas`` in interpret mode,
  f32 and bf16 inputs, causal and not;
* ``models.layers.flash_attention`` against the reference's jnp oracle
  ``repro.models.layers.flash_attention``, with the window, logit-softcap
  and query-offset cases that stay on the chunked path, and its routing
  to the kernel;
* ``models.layers.decode_attention`` against the reference's;
* the bf16 CUDA kernel's split-bf16 arithmetic (q' and p as bf16 hi +
  lo, products summed in f32), emulated in plain torch, against the
  Pallas kernel, and the same with p_hi alone failing the tolerance;
* the wrapper's launch on the card that holds its tensors (any index
  reaches the C entry, which makes it current), with the entry replaced.

Tolerances: f32 2e-5 (the reference's own kernel test); the plain
version against the Pallas kernel, and the CUDA kernel against the plain
version, in bf16 rtol 2^-7 with atol 1e-5 (both compute in f32 and round
once, so they differ by at most one bf16 ulp); the port against
the oracle in bf16 3e-2 (the reference's own bf16 tolerance: the oracle
rounds p to bf16 before p . v, the kernel keeps it in f32).

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against it by the test that needs a GPU (skipped without one) and by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention_pallas
from repro.models import layers as jlayers
from repro_torch.kernels import flash as tflash
from repro_torch.models import layers as tlayers

#: the reference's ``tests/test_flash_kernel.py`` CASES, plus smollm-135m's
#: heads: (B, S, H, Hk, Dh, q_block, k_block)
CASES = [
    (2, 64, 4, 2, 16, 32, 32),
    (1, 128, 8, 8, 32, 64, 32),
    (2, 96, 6, 3, 8, 32, 48),
    (1, 64, 2, 1, 64, 64, 64),
    (2, 128, 9, 3, 64, 128, 128),
]

#: (rtol, atol): in bf16 one ulp, 2^-7 of the value (atol covers outputs
#: near 0)
TOL_KERNEL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}
TOL_ORACLE = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, S, T, H, Hk, Dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, T, Hk, Dh)).astype(np.float32),
            rng.normal(size=(B, T, Hk, Dh)).astype(np.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype`` (bf16
    rounds once, on the JAX side, and crosses as exact f32)."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel(case, causal, dtype):
    B, S, H, Hk, Dh, qb, kb = case
    arrs = _qkv(sum(case), B, S, S, H, Hk, Dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, q_block=qb,
                                  k_block=kb, interpret=True)
    got = tflash.flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, Dh)
    rtol, atol = TOL_KERNEL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_bf16_kernel_tolerance_rejects_p_rounded_to_bf16():
    """The one-ulp bf16 tolerance can fail: the reference's oracle, which
    rounds p to bf16 before p . v as SDPA does, falls outside it."""
    B, S, H, Hk, Dh = 2, 128, 9, 3, 64
    arrs = _qkv(1, B, S, S, H, Hk, Dh)
    q, k, v = (_pair(a, "bfloat16")[0] for a in arrs)
    kernel = flash_attention_pallas(q, k, v, causal=True, q_block=128,
                                    k_block=128, interpret=True)
    oracle = jlayers.flash_attention(q, k, v, causal=True, q_chunk=64,
                                     k_chunk=64)
    rtol, atol = TOL_KERNEL["bfloat16"]
    assert not np.allclose(_np(oracle), _np(kernel), rtol=rtol, atol=atol)


def _split_bf16(x: torch.Tensor):
    """f32 x as bf16 hi = bf16(x) and lo = bf16(x - hi), held in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_bf16_attention(q, k, v, causal, p_lo=True):
    """The arithmetic of the bf16 tensor-core kernel, in plain torch: q'
    = f32(q) * scale split in bf16 hi and lo, s = q_hi . k + q_lo . k
    (bf16 products, exact in f32, summed in f32), the online softmax in
    f32 over 64-key tiles, p split in bf16 hi and lo for p . v (only hi
    when ``p_lo`` is False, as a kernel that rounds p to bf16 would), one
    rounding to bf16 at the end."""
    B, S, H, Dh = q.shape
    T, G = k.shape[1], H // k.shape[2]
    q_hi, q_lo = _split_bf16(q.float() * tflash.softmax_scale(Dh))
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    s = (torch.einsum("bshd,bthd->bhst", q_hi, kf)
         + torch.einsum("bshd,bthd->bhst", q_lo, kf))
    if causal:
        s = s.masked_fill(torch.arange(S)[:, None] < torch.arange(T), -np.inf)
    m = torch.full((B, H, S), -np.inf)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, Dh))
    for j0 in range(0, T, 64):
        sj = s[..., j0:j0 + 64]
        m_new = torch.maximum(m, sj.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(sj), torch.exp(sj - m_safe[..., None]),
                        0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        p_hi, p_rest = _split_bf16(p)
        pv = torch.einsum("bhst,bthd->bhsd", p_hi, vf[:, j0:j0 + 64])
        if p_lo:
            pv = pv + torch.einsum("bhst,bthd->bhsd", p_rest,
                                   vf[:, j0:j0 + 64])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_split_bf16_arithmetic_meets_kernel_tolerance(case, causal):
    """The bf16 kernel's split-bf16 products, emulated on the CPU, stay
    within one bf16 ulp of the Pallas kernel."""
    B, S, H, Hk, Dh, qb, kb = case
    arrs = _qkv(sum(case) + 1, B, S, S, H, Hk, Dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in arrs)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, q_block=qb,
                                  k_block=kb, interpret=True)
    got = _split_bf16_attention(qt, kt, vt, causal)
    rtol, atol = TOL_KERNEL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def test_bf16_kernel_tolerance_rejects_p_hi_alone():
    """The same arithmetic with p rounded to bf16 (p_hi alone) fails the
    one-ulp tolerance: the p_lo product is what keeps the kernel in it."""
    B, S, H, Hk, Dh = 2, 128, 9, 3, 64
    arrs = _qkv(1, B, S, S, H, Hk, Dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in arrs)
    kernel = flash_attention_pallas(qj, kj, vj, causal=True, q_block=128,
                                    k_block=128, interpret=True)
    rtol, atol = TOL_KERNEL["bfloat16"]
    both = _split_bf16_attention(qt, kt, vt, True)
    assert np.allclose(_np(both), _np(kernel), rtol=rtol, atol=atol)
    hi_only = _split_bf16_attention(qt, kt, vt, True, p_lo=False)
    assert not np.allclose(_np(hi_only), _np(kernel), rtol=rtol, atol=atol)


def test_plain_blocks_and_ragged_tails_agree():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 100, 100, 6, 2, 32))
    a = tflash.flash_attention_plain(q, k, v, q_block=256, k_block=256)
    b = tflash.flash_attention_plain(q, k, v, q_block=24, k_block=40)
    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    # S != T, non-causal: every query sees every key
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 40, 72, 4, 2, 16))
    got = tflash.flash_attention_plain(q, k, v, causal=False, q_block=16,
                                       k_block=32)
    ref = torch.softmax(torch.einsum(
        "bshd,bthd->bhst", q * tflash.softmax_scale(16),
        k.repeat_interleave(2, dim=2)), -1)
    ref = torch.einsum("bhst,bthd->bshd", ref, v.repeat_interleave(2, dim=2))
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def test_softmax_scale_is_rounded_to_f32_once():
    for dh in (16, 64, 128, 96):
        assert tflash.softmax_scale(dh) == float(np.float32(dh ** -0.5))


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 64, 64, 4, 2, 16))
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=True)
    assert tflash.launches == before
    assert torch.equal(got, tflash.flash_attention_plain(q, k, v))


def test_wrapper_on_meta_runs_plain_and_launches_nothing(monkeypatch):
    """The dry-run's meta tensors take the plain version (shapes only, in
    tiles of S / 8) and never the C entry; ``layers.flash_attention``
    routes them there as it routes a CUDA tensor to the kernel (the CUDA
    branch is held by ``test_wrapper_passes_its_tensors_card_to_the_entry``)."""
    calls = []
    plain = tflash.flash_attention_plain
    monkeypatch.setattr(tflash, "flash_attention_plain", lambda *a, **k: (
        calls.append(k) or plain(*a, **k)))
    monkeypatch.setattr(tflash, "_entry",
                        lambda dt: pytest.fail("the C entry was reached"))
    q = torch.empty((2, 4096, 8, 64), dtype=torch.bfloat16, device="meta")
    k = v = torch.empty((2, 4096, 2, 64), dtype=torch.bfloat16,
                        device="meta")
    before = tflash.launches
    out = tflash.flash_attention(q, k, v, causal=True)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    out = tlayers.flash_attention(q, k, v, causal=False)
    assert out.device.type == "meta" and out.shape == q.shape
    assert tflash.launches == before
    assert calls == [dict(causal=True, q_block=512, k_block=512),
                     dict(causal=False, q_block=512, k_block=512)]


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)),     # 4 heads over 3
    ((1, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)),     # batch differs
    ((1, 8, 4, 16), (1, 8, 2, 32), (1, 8, 2, 32)),     # head width differs
    ((1, 8, 4, 16), (1, 8, 2, 16), (1, 9, 2, 16)),     # k and v differ
])
def test_wrapper_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, v)


# --- models.layers.flash_attention against the jnp oracle -------------------

ORACLE_CASES = [
    # (B, S, T, H, Hk, Dh), kwargs, q_chunk, k_chunk
    ((2, 64, 64, 4, 2, 16), dict(causal=True), 512, 1024),
    ((2, 96, 96, 6, 3, 16), dict(causal=True), 32, 48),
    ((1, 64, 64, 4, 4, 32), dict(causal=False), 32, 32),
    ((2, 128, 128, 9, 3, 64), dict(causal=True, window=1 << 30), 64, 64),
    ((2, 64, 64, 4, 2, 16), dict(causal=True, window=16), 32, 32),
    ((1, 64, 64, 4, 2, 16), dict(causal=False, window=8), 16, 32),
    ((2, 64, 64, 4, 2, 16), dict(causal=True, logit_softcap=50.0), 32, 32),
    ((2, 32, 64, 4, 2, 16), dict(causal=True, q_offset=32), 16, 32),
    ((1, 48, 64, 4, 1, 32), dict(causal=True, q_offset=16, window=24,
                                 logit_softcap=30.0), 16, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ORACLE_CASES,
                         ids=[str(c[1]) + str(c[0]) for c in ORACLE_CASES])
def test_layers_flash_attention_matches_oracle(case, dtype):
    (B, S, T, H, Hk, Dh), kw, qc, kc = case
    arrs = _qkv(B * S + T + Dh, B, S, T, H, Hk, Dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    want = jlayers.flash_attention(qj, kj, vj, q_chunk=qc, k_chunk=kc, **kw)
    got = tlayers.flash_attention(qt, kt, vt, q_chunk=qc, k_chunk=kc, **kw)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, Dh)
    tol = TOL_ORACLE[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("kw,routed", [
    (dict(), True),
    (dict(causal=False), True),
    (dict(window=1 << 30), True),
    (dict(window=64), True),                 # a window of T masks nothing
    (dict(window=63), False),
    (dict(logit_softcap=50.0), False),
    (dict(q_offset=8), False),
])
def test_layers_flash_attention_routes_plain_attention_to_the_kernel(
        monkeypatch, kw, routed):
    calls = []
    real = tflash.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(tflash, "flash_attention", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 64, 64, 4, 2, 16))
    tlayers.flash_attention(q, k, v, **kw)
    assert calls == ([kw.get("causal", True)] if routed else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=5),
                                dict(logit_softcap=50.0)])
def test_decode_attention_matches_reference(dtype, kw):
    B, T, H, Hk, Dh, t = 2, 24, 6, 2, 16, 17
    rng = np.random.default_rng(9)
    arrs = (rng.normal(size=(B, 1, H, Dh)).astype(np.float32),
            rng.normal(size=(B, T, Hk, Dh)).astype(np.float32),
            rng.normal(size=(B, T, Hk, Dh)).astype(np.float32))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in arrs)
    want = jlayers.decode_attention(qj, kj, vj, jnp.int32(t), **kw)
    got = tlayers.decode_attention(qt, kt, vt, t, **kw)
    tol = TOL_ORACLE[dtype] if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = TOL_KERNEL[str(dtype).split(".")[-1]]
        for causal in (True, False):
            q, k, v = (torch.from_numpy(a).to("cuda", dtype)
                       for a in _qkv(8, 2, 200, 200, 9, 3, 64))
            before = tflash.launches
            got = tflash.flash_attention(q, k, v, causal=causal)
            assert tflash.launches == before + 1
            want = tflash.flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rtol, atol=atol)


# --- the wrapper launches on the card that holds its tensors ----------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:<INDEX>`` as its device, so the
    wrapper's launch path runs here with the C entry replaced."""
    INDEX = 0

    @property
    def device(self):
        return torch.device("cuda", _OnCard.INDEX)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 1, 3])
def test_wrapper_passes_its_tensors_card_to_the_entry(monkeypatch, index,
                                                      dtype):
    """Any card index reaches the C entry as its last int, and the launch
    runs with that card current (no refusal of cuda:1 and up)."""
    import contextlib
    entered, calls = [], []

    @contextlib.contextmanager
    def device_ctx(dev):
        entered.append(dev)
        yield

    class Stream:
        cuda_stream = 4321

    def entry(dt):
        assert dt == dtype
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(_OnCard, "INDEX", index)
    monkeypatch.setattr(tflash, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream)
    q, k, v = (torch.Tensor._make_subclass(_OnCard, torch.zeros(s, dtype=dtype))
               for s in ((2, 64, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    assert q.device == torch.device("cuda", index)
    before = tflash.launches
    tflash.flash_attention(q, k, v, causal=False)
    assert tflash.launches == before + 1
    assert entered == [torch.device("cuda", index)]
    (args,) = calls
    # 4 pointers, then B, S, T, H, Hk, Dh, causal, device; the scale; the
    # stream
    assert args[4:12] == (2, 64, 48, 4, 2, 16, 0, index)
    assert args[12] == tflash.softmax_scale(16) and args[13] == 4321


def test_flash_entry_makes_its_device_current():
    """The C entry takes the device as its last int and calls
    ``cudaSetDevice`` before it launches, as the stencil and pack entries
    do (each library links its own cudart)."""
    import pathlib
    src = (pathlib.Path(tflash.__file__).parent / "csrc" / "flash.cu"
           ).read_text()
    entry = src[src.index("#define MSZ_FLASH_ENTRY"):]
    entry = entry[:entry.index("MSZ_FLASH_ENTRY(msz_flash_f32")]
    sig = " ".join(entry[entry.index("NAME("):entry.index("{")]
                   .replace("\\", " ").split())
    assert "int causal, int device, float scale, void* stream" in sig
    assert entry.index("cudaSetDevice(device)") < entry.index("launch<BF16>")


# --- the kernel path's gradient ---------------------------------------------

class _OnCardWhileForward(torch.Tensor):
    """A CPU tensor that reports ``cuda:0`` while ``ON`` is set: the
    forward then takes the wrapper's launch path (the C entry replaced),
    and the backward, with ``ON`` cleared, runs on the CPU."""
    ON = False

    @property
    def device(self):
        return torch.device("cuda", 0) if _OnCardWhileForward.ON \
            else torch.device("cpu")


def _fake_launch(monkeypatch, calls):
    """Replace the flash C entry (and the CUDA device and stream calls
    around it) by one that writes the plain version's output into ``o``
    at its pointer, as the kernel would."""
    import contextlib
    import ctypes

    class Stream:
        cuda_stream = 0

    def entry(dtype):
        def launch(qp, kp, vp, op, B, S, T, H, Hk, Dh, causal, dev, scale,
                   stream):
            def view(ptr, shape):
                n = int(np.prod(shape))
                buf = (ctypes.c_byte * (n * torch.finfo(dtype).bits // 8)
                       ).from_address(ptr)
                t = torch.frombuffer(buf, dtype=dtype)
                return t.view(shape)
            q, k, v = (view(qp, (B, S, H, Dh)), view(kp, (B, T, Hk, Dh)),
                       view(vp, (B, T, Hk, Dh)))
            o = view(op, (B, S, H, Dh))
            o.copy_(tflash.flash_attention_plain(q, k, v,
                                                 causal=bool(causal)))
            calls.append((B, S, T, H, Hk, Dh, causal))
            return 0
        return launch
    monkeypatch.setattr(tflash, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_path_carries_the_oracles_gradient(monkeypatch, dtype,
                                                  causal):
    """Through the wrapper's CUDA branch (the kernel's output written
    through its pointer, as the launch writes it), attention has a
    gradient: q, k and v each get one, non-zero, equal to autograd
    through the chunked oracle itself (several query and key chunks).
    f32: 1e-6 (dk and dv sum over the query chunks in another order).
    bf16: 2^-6 of the largest |g|, two bf16 ulps at its scale: autograd
    through the oracle rounds each chunk's bf16 partial of dk and dv and
    sums them in bf16, the Function sums in f32 and rounds once. Without
    the autograd Function around the launch the output has no
    ``grad_fn`` and this fails."""
    calls = []
    _fake_launch(monkeypatch, calls)
    B, S, H, Hk, Dh = 2, 64, 6, 2, 16
    arrs = [torch.from_numpy(a).to(dtype)
            for a in _qkv(21, B, S, S, H, Hk, Dh)]
    dout = torch.from_numpy(np.random.default_rng(22).normal(
        size=(B, S, H, Dh)).astype(np.float32)).to(dtype)
    q, k, v = (torch.Tensor._make_subclass(_OnCardWhileForward, a, True)
               for a in arrs)
    monkeypatch.setattr(_OnCardWhileForward, "ON", True)
    before = tflash.launches
    out = tlayers.flash_attention(q, k, v, causal=causal, q_chunk=16,
                                  k_chunk=32)
    assert tflash.launches == before + 1 and len(calls) == 1
    assert out.grad_fn is not None
    monkeypatch.setattr(_OnCardWhileForward, "ON", False)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref_in = [a.clone().requires_grad_(True) for a in arrs]
    ref_out = tlayers.oracle_attention(*ref_in, causal=causal, q_chunk=16,
                                       k_chunk=32)
    want = torch.autograd.grad(ref_out, ref_in, dout)
    for name, g, w in zip("qkv", got, want):
        assert g is not None and g.dtype == dtype, name
        assert g.float().abs().max() > 0, name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        else:
            err = (g.float() - w.float()).abs().max()
            assert err <= 2.0 ** -6 * w.float().abs().max(), (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_path_gradient_matches_jax_grad_of_the_oracle(causal):
    """On the CPU (the plain version forward), the q, k, v gradients
    against ``jax.grad`` of the reference's oracle, f32, 1e-5."""
    import jax
    B, S, H, Hk, Dh = 2, 48, 4, 2, 16
    arrs = _qkv(23, B, S, S, H, Hk, Dh)
    w = np.random.default_rng(24).normal(size=(B, S, H, Dh)).astype(
        np.float32)

    def ref(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, causal=causal,
                                               q_chunk=16, k_chunk=16) * w)
    want = jax.grad(ref, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = tlayers.flash_attention(*ts, causal=causal, q_chunk=16,
                                  k_chunk=16)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-5)


def test_kernel_attention_adds_nothing_without_a_gradient(monkeypatch):
    """With no input requiring a gradient, and under inference mode, the
    wrapper is called as before: one call, no autograd node."""
    calls = []
    real = tflash.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(1)
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(tflash, "flash_attention", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(25, 1, 32, 32, 4, 2, 16))
    assert tlayers.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        qr = q.clone().requires_grad_(False)
        assert tlayers.flash_attention(qr, k, v).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert tlayers.flash_attention(q, k, v).grad_fn is None
    assert len(calls) == 3


# --- the in-place repairs: gradients flow, serving bits unchanged -----------

def _smoke(arch: str, dtype: str = "float32"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_final_softcap_backpropagates():
    """gemma2's ``final_softcap`` under autograd: the gradient of a
    weighted sum of the logits reaches the embedding, finite, and equals
    the one through ``cap * tanh(x / cap)`` written out."""
    from repro_torch.models import forward
    cfg, p = _smoke("gemma2-9b")
    assert cfg.final_softcap
    emb = p["embed"].clone().requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    w = torch.randn((2, 12, cfg.vocab), generator=torch.Generator()
                    .manual_seed(1))
    out = forward(cfg, {**p, "embed": emb}, {"tokens": toks}).logits
    (g,) = torch.autograd.grad((out * w).sum(), emb)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    hidden = forward(cfg, {**p, "embed": emb}, {"tokens": toks},
                     logits_mode="hidden").logits
    unemb = p["unembed"] if "unembed" in p else emb.T
    raw = hidden.float() @ unemb.float()
    capped = cfg.final_softcap * torch.tanh(raw / cfg.final_softcap)
    (g2,) = torch.autograd.grad((capped * w).sum(), emb)
    torch.testing.assert_close(g, g2, rtol=1e-5, atol=1e-6)


def test_ssm_scan_backpropagates_as_the_reference():
    """hymba's SSM scan under autograd (two chunks), every input's
    gradient against ``jax.grad`` of the reference's scan, f32, 1e-4 of
    its largest value."""
    import jax
    rng = np.random.default_rng(26)
    B, S, H, D, N = 2, 16, 3, 8, 4
    arrs = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((B, S, H, D), 1.0), ((B, S, H), 0.5), ((B, S, H, N), 1.0),
        ((B, S, H, N), 1.0), ((H, N), 0.3))]
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)

    def ref(*xs):
        return jnp.sum(jlayers.ssm_scan(*xs, chunk=8) * w)
    want = jax.grad(ref, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = torch.autograd.grad(
        (tlayers.ssm_scan(*ts, chunk=8) * torch.from_numpy(w)).sum(), ts)
    for g, wg in zip(got, want):
        wg = np.asarray(wg)
        assert np.isfinite(wg).all()
        assert np.abs(g.numpy() - wg).max() <= 1e-4 * np.abs(wg).max()


@pytest.mark.parametrize("arch", ["gemma2-9b", "hymba-1.5b", "smollm-135m",
                                  "xlstm-1.3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_logits_are_unchanged_by_the_gradient_repairs(arch, dtype):
    """The serving prefill (inference mode, or grad mode with no input
    requiring a gradient: the in-place softcap and SSM weights, the
    kernel without its autograd Function) and the forward with the
    parameters requiring gradients (the out-of-place forms, the
    Function, remat) give the same logits, bit for bit."""
    from repro_torch.models import forward
    from repro_torch.serve import make_prefill
    cfg, p = _smoke(arch, dtype)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    with torch.inference_mode():
        _, served = make_prefill(cfg, max_len=24)(p, {"tokens": toks})
        full = forward(cfg, p, {"tokens": toks}).logits
    # grad mode with nothing requiring a gradient: the serving entry
    # points as callers run them, the in-place forms
    assert torch.equal(forward(cfg, p, {"tokens": toks}).logits, full)
    grads_on = {k: v.detach().requires_grad_(True) if isinstance(
        v, torch.Tensor) else {kk: vv.detach().requires_grad_(True)
                               for kk, vv in v.items()}
        for k, v in p.items()}
    for remat in (False, True):
        out = forward(cfg, grads_on, {"tokens": toks}, remat=remat).logits
        assert out.grad_fn is not None
        assert torch.equal(out.detach(), full)
    assert torch.equal(served[:, -1], full[:, -1])


def test_serving_keeps_the_in_place_forms(monkeypatch):
    """Where autograd records nothing (grad mode on, as the serving entry
    points run, but no input requires a gradient), the softcap and the
    SSM weights stay in place (gemma2's f32 logits, hymba's (B, L, M, H,
    N) weights: no second buffer); only a recorded forward takes the
    out-of-place forms."""
    from repro_torch.models import forward
    calls = {"tanh": 0, "exp_": 0}
    tanh, exp_ = torch.tanh, torch.Tensor.exp_

    def count_tanh(*a, **kw):
        calls["tanh"] += 1
        return tanh(*a, **kw)

    def count_exp_(self):
        calls["exp_"] += 1
        return exp_(self)
    monkeypatch.setattr(torch, "tanh", count_tanh)
    monkeypatch.setattr(torch.Tensor, "exp_", count_exp_)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 16)).astype(np.int32))
    cfg, p = _smoke("gemma2-9b")
    forward(cfg, p, {"tokens": toks}, logits_mode="hidden")
    hidden_tanh = calls["tanh"]            # the attention softcaps
    forward(cfg, p, {"tokens": toks})
    assert calls["tanh"] == 2 * hidden_tanh
    emb = p["embed"].clone().requires_grad_(True)
    forward(cfg, {**p, "embed": emb}, {"tokens": toks})
    assert calls["tanh"] == 3 * hidden_tanh + 1
    cfg, p = _smoke("hymba-1.5b")
    forward(cfg, p, {"tokens": toks})
    assert calls["exp_"] == cfg.n_layers          # one chunk a layer
    forward(cfg, {**p, "embed": p["embed"].clone().requires_grad_(True)},
            {"tokens": toks})
    assert calls["exp_"] == cfg.n_layers
