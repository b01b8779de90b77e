"""The port's MoE layer (``repro_torch.models.layers.moe_ffn``) against
``repro.models.layers.moe_ffn`` on the same f32 inputs, made with numpy
from a seed: the output ``y`` and the Switch ``aux_loss`` within 1e-5.

The cases cover few and many experts (E 8 / K 2, E 128 / K 8), capacity
factors with no drops (4.0), some (1.25) and many (0.5), and a zero
router, where every probability ties and the two packages must pick the
same experts (``jax.lax.top_k``'s lower-index-first order) and so drop
the same assignments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers as tlayers

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(E: int, d: int = 32, ff: int = 16, B: int = 2, S: int = 24,
            seed: int = 0, zero_router: bool = False):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x = normal(B, S, d)
    p = {"router": normal(d, E, scale=d ** -0.5),
         "w_gate": normal(E, d, ff, scale=d ** -0.5),
         "w_up": normal(E, d, ff, scale=d ** -0.5),
         "w_down": normal(E, ff, d, scale=ff ** -0.5)}
    if zero_router:
        p["router"][:] = 0
    return x, p


def _both(x, p, E: int, K: int, cf: float):
    want = jlayers.moe_ffn(jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in p.items()},
                           E, K, cf)
    got = tlayers.moe_ffn(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()},
                          E, K, cf)
    return want, got


def _drops(x, p, E: int, K: int, cf: float) -> int:
    """Assignments beyond an expert's capacity, from the reference's own
    top-k ids."""
    N = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(N, -1) @ p["router"]), -1)
    ids = np.asarray(jax.lax.top_k(probs, K)[1]).ravel()
    cap = int(np.ceil(N * K / E * cf / 8)) * 8
    return int(np.maximum(np.bincount(ids, minlength=E) - cap, 0).sum())


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5])
@pytest.mark.parametrize("E,K", [(8, 2), (128, 8)])
def test_moe_ffn_matches_reference(E, K, cf):
    # enough tokens that the capacity's rounding up to a multiple of 8
    # leaves 0.5 below the mean load: it drops about half
    x, p = _inputs(E, S=max(64, 2 * E), seed=E + int(cf * 4))
    drops = _drops(x, p, E, K, cf)
    if cf == 4.0:
        assert drops == 0
    if cf == 0.5:
        assert drops > x.shape[0] * x.shape[1] * K // 4
    want, got = _both(x, p, E, K, cf)
    assert got.y.dtype == torch.float32 and got.y.shape == x.shape
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)
    np.testing.assert_allclose(float(got.aux_loss),
                               float(want.aux_loss), **TOL)


@pytest.mark.parametrize("E,K", [(8, 2), (128, 8)])
def test_moe_ffn_zero_router_ties_like_reference(E, K):
    """Every probability is 1/E: the reference takes experts 0..K-1 for
    every token (``torch.topk`` picks others), so all N tokens queue for
    the same K experts and all but ``cap`` of each are dropped."""
    x, p = _inputs(E, zero_router=True)
    assert _drops(x, p, E, K, 1.25) > 0
    want, got = _both(x, p, E, K, 1.25)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)
    np.testing.assert_allclose(float(got.aux_loss),
                               float(want.aux_loss), **TOL)
    probs = torch.full((3, E), 1.0 / E)
    assert tlayers._top_k(probs, K)[1].tolist() == [list(range(K))] * 3


def test_top_k_breaks_ties_like_jax():
    """Rows drawn from four values, so most entries tie: the same values
    and indices as ``jax.lax.top_k``."""
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, (64, 128)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 8)
    tv, ti = tlayers._top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_ffn_bf16_within_tolerance_and_repeatable():
    """bf16 activations and weights, as the models run: within rtol
    5e-2, atol 1e-1 of the reference (the LM tests' bf16 tolerance), and
    two calls bitwise equal (the combine has no atomics)."""
    x, p = _inputs(8, seed=3)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    want = jlayers.moe_ffn(jnp.asarray(x, jnp.bfloat16), jp, 8, 2, 1.25)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    tx = torch.from_numpy(x).bfloat16()
    got = tlayers.moe_ffn(tx, tp, 8, 2, 1.25)
    assert got.y.dtype == torch.bfloat16
    np.testing.assert_allclose(got.y.float().numpy(),
                               np.asarray(want.y.astype(jnp.float32)),
                               rtol=5e-2, atol=1e-1)
    again = tlayers.moe_ffn(tx, tp, 8, 2, 1.25)
    assert torch.equal(again.y, got.y)
    assert torch.equal(again.aux_loss, got.aux_loss)
