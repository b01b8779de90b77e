"""The rank rule behind the extrema kernel's SoS scans, on the CPU.

``csrc/extrema.cu`` carries no linear index through its scans: for two
candidates of one vertex's neighborhood that both lie inside the tile
and the global domain (the vertex itself included), it takes the sign
of their global linear-index difference to be the lexicographic order
of their (dz, dy, dx) offsets. Each scan then visits the directions in
rank order (those above the vertex ascending, those below it
descending) and breaks value ties by position; a cell off the tile or
the domain holds NaN, which loses every comparison.

The first tests check the rule exhaustively on small 2D and 3D shapes
(extents 1, 2 and 3 on every axis, and tiles at a non-zero origin
inside larger global extents). The last ones emulate the kernel's scans
in plain torch, comparison for comparison, and hold the emulation
bitwise against the reference's Pallas kernel in interpret mode (as
``tests/test_torch_kernels.py`` runs it) on tie-heavy fields, and
against the port's plain version on tiles."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.extrema import extrema_masks_pallas
from _torch_threads import one_thread  # noqa: F401
from repro_torch.core.grid import shift
from repro_torch.kernels import extrema as kx
from repro_torch.kernels.stencil import geometry, neighbor_ok, slab_offsets


def lex_rank(off) -> int:
    """Rank of a (dz, dy, dx) offset among the 27 of {-1, 0, 1}^3,
    lexicographically; the vertex itself, (0, 0, 0), ranks 13."""
    dz, dy, dx = off
    return (dz + 1) * 9 + (dy + 1) * 3 + dx + 1


def scan_order(ndim: int):
    """The directions in the kernel's scan order: those ranked above the
    vertex in ascending rank, then those below it in descending rank
    (``scan_slot`` in ``csrc/stencil.cuh``)."""
    offs = slab_offsets(ndim)
    above = sorted((k for k, o in enumerate(offs) if lex_rank(o) > 13),
                   key=lambda k: lex_rank(offs[k]))
    below = sorted((k for k, o in enumerate(offs) if lex_rank(o) < 13),
                   key=lambda k: -lex_rank(offs[k]))
    return above + below


# --- the rank rule, exhaustively -------------------------------------------

def check_rank_rule(geo) -> int:
    """Over every vertex of the tile and every pair of its candidates
    (self included) inside the tile and the global domain: the sign of
    their global linear-index difference is the sign of their rank
    difference. Returns the number of pairs checked."""
    slots = ((0, 0, 0),) + slab_offsets(geo.ndim)
    z, y, x = np.meshgrid(np.arange(geo.nz), np.arange(geo.ny),
                          np.arange(geo.nx), indexing="ij")
    cand = []
    for dz, dy, dx in slots:
        lz, ly, lx = z + dz, y + dy, x + dx
        gz, gy, gx = lz + geo.z0, ly + geo.y0, lx + geo.x0
        ok = ((lz >= 0) & (lz < geo.nz) & (ly >= 0) & (ly < geo.ny)
              & (lx >= 0) & (lx < geo.nx) & (gz >= 0) & (gz < geo.N)
              & (gy >= 0) & (gy < geo.NY) & (gx >= 0) & (gx < geo.NX))
        # the global row-major id of the candidate's own position
        lin = (gz.astype(np.int64) * geo.NY + gy) * geo.NX + gx
        cand.append((ok, lin))
    # the plain version's masks agree with this domain test
    for o, (ok, _) in zip(slots, cand):
        assert np.array_equal(neighbor_ok(geo, o, "cpu").numpy(), ok)
    n = 0
    for a, b in itertools.permutations(range(len(slots)), 2):
        both = cand[a][0] & cand[b][0]
        sign = np.sign(lex_rank(slots[a]) - lex_rank(slots[b]))
        assert np.all(np.sign(cand[a][1] - cand[b][1])[both] == sign), \
            (geo, slots[a], slots[b])
        n += int(both.sum())
    return n


@pytest.mark.parametrize("shape", list(itertools.product((1, 2, 3),
                                                         repeat=3)))
def test_rank_rule_3d(shape):
    n = check_rank_rule(geometry(shape))
    if min(shape) > 1:
        assert n > 0


@pytest.mark.parametrize("shape", list(itertools.product((1, 2, 3),
                                                         repeat=2)))
def test_rank_rule_2d(shape):
    check_rank_rule(geometry(shape))


#: (tile shape, origin, global extents): tiles of extent 1, 2 and 3 at a
#: non-zero origin inside larger fields, flush with a domain edge or not
TILES = [((3, 2, 3), (1, 1, 2), (5, 4, 6)),
         ((1, 2, 1), (1, 1, 1), (3, 3, 3)),
         ((2, 3, 1), (2, 0, 4), (4, 3, 5)),
         ((3, 3, 3), (0, 2, 1), (3, 5, 4)),
         ((2, 2), (3, 1), (5, 3)),
         ((3, 1), (1, 4), (4, 5))]


@pytest.mark.parametrize("shape,origin,total", TILES)
def test_rank_rule_on_tiles(shape, origin, total):
    if len(shape) == 3:
        geo = geometry(shape, *origin, *total)
    else:
        geo = geometry(shape, origin[0], 0, origin[1], total[0], None,
                       total[1])
    assert check_rank_rule(geo) > 0


def test_scan_order_is_a_permutation_split_at_the_vertex():
    for ndim, K in ((3, 14), (2, 6)):
        order = scan_order(ndim)
        offs = slab_offsets(ndim)
        assert sorted(order) == list(range(K))
        ranks = [lex_rank(offs[k]) for k in order]
        assert all(r > 13 for r in ranks[:K // 2])
        assert all(r < 13 for r in ranks[K // 2:])
        assert ranks[:K // 2] == sorted(ranks[:K // 2])
        assert ranks[K // 2:] == sorted(ranks[K // 2:], reverse=True)


# --- the kernel's scans, emulated ------------------------------------------

def emulated_extrema(g, M, m, is_max, is_min, geo):
    """The five outputs of ``csrc/extrema.cu``, computed as its scans do:
    NaN in every cell off the tile or the domain, the directions in
    ``scan_order``, ties won in the first half and lost in the second,
    and no linear index."""
    offs = slab_offsets(geo.ndim)
    K = len(offs)
    g3, M3, m3 = (t.reshape(geo.shape3) for t in (g, M, m))
    vals = [torch.where(neighbor_ok(geo, o, "cpu"),
                        shift(g3, o, float("nan")), float("nan"))
            for o in offs]
    order = scan_order(geo.ndim)

    def scan(ascending):
        best = g3.clone()
        code = torch.full(g3.shape, K, dtype=torch.int32)
        visits = order if ascending else order[K // 2:] + order[:K // 2]
        for i, k in enumerate(visits):
            v = vals[k]
            if ascending:
                win = v >= best if i < K // 2 else v > best
            else:
                win = v <= best if i < K // 2 else v < best
            best = torch.where(win, v, best)
            code = torch.where(win, k, code)
        return code

    def at(x, code):
        out = x
        for k, o in enumerate(offs):
            out = torch.where(code == k, shift(x, o, 0), out)
        return out

    up, dn = scan(True), scan(False)
    mx, mn = is_max.reshape(geo.shape3), is_min.reshape(geo.shape3)
    is_max_g, is_min_g = up == K, dn == K
    t_max = ~is_max_g & (at(M3, up) != M3)
    t_min = ~is_min_g & (at(m3, dn) != m3)
    outs = (up, dn, (is_max_g & ~mx) | (~is_min_g & mn),
            (~is_max_g & mx) | t_max, (is_min_g & ~mn) | t_min)
    return [o.to(torch.int32).reshape(g.shape) for o in outs]


def tie_field(kind, shape, rng):
    """A field whose steepest neighbors tie often: every value equal,
    plateaus of 2 x 2 (x 2) blocks, or values on a quarter grid."""
    if kind == "constant":
        return np.full(shape, 0.75)
    if kind == "plateau":
        coarse = np.round(rng.normal(size=[(s + 1) // 2 for s in shape]))
        for ax in range(len(shape)):
            coarse = np.repeat(coarse, 2, axis=ax)
        return coarse[tuple(slice(0, s) for s in shape)]
    return np.round(rng.normal(size=shape) * 4) / 4


def stencil_inputs(kind, shape, dtype, seed):
    """g of ``kind``, labels drawn from {0, 1, 2} (a winner's label
    matches its vertex's about a third of the time), extremum masks at
    50 %."""
    rng = np.random.default_rng(seed)
    g = tie_field(kind, shape, rng).astype(dtype)
    M, m = (rng.integers(0, 3, size=shape).astype(np.int32)
            for _ in range(2))
    mx, mn = (rng.random(shape) < 0.5 for _ in range(2))
    return g, M, m, mx, mn


KINDS = ("constant", "plateau", "quarter")
SHAPES = [((5, 6, 7), np.float32), ((6, 4, 9), np.float64),
          ((3, 1, 5), np.float32), ((2, 2, 2), np.float64),
          ((9, 11), np.float32), ((7, 12), np.float64),
          ((1, 7), np.float32), ((5, 4), np.float64)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_emulated_scan_matches_pallas(shape, dtype, kind):
    g, M, m, mx, mn = stencil_inputs(kind, shape, dtype, seed=sum(shape))
    with jax.enable_x64(dtype == np.float64):
        want = extrema_masks_pallas(
            jnp.asarray(g), jnp.asarray(M), jnp.asarray(m),
            jnp.asarray(mx.astype(np.int32)),
            jnp.asarray(mn.astype(np.int32)), interpret=True)
        want = [np.asarray(w) for w in want]
    geo = geometry(shape)
    got = emulated_extrema(*(torch.from_numpy(x) for x in (g, M, m, mx, mn)),
                           geo)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,tile", [
    ((8, 9, 10), (2, 7, 1, 8, 2, 9)),
    ((6, 3, 5), (1, 5, 1, 3, 1, 4)),
    ((12, 15), (3, 10, 0, 0, 4, 13)),
])
def test_emulated_scan_matches_plain_on_tiles(shape, tile, kind):
    ins = stencil_inputs(kind, shape, np.float32, seed=3)
    z0, z1, y0, y1, x0, x1 = tile
    if len(shape) == 3:
        sl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        geo = geometry((z1 - z0, y1 - y0, x1 - x0), z0, y0, x0, *shape)
    else:
        sl = (slice(z0, z1), slice(x0, x1))
        geo = geometry((z1 - z0, x1 - x0), z0, 0, x0, shape[0], None,
                       shape[1])
    sub = [torch.from_numpy(np.ascontiguousarray(x[sl])) for x in ins]
    got = emulated_extrema(*sub, geo)
    want = kx.extrema_masks_plain(*sub, geo)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
