"""The port's device-pack codec (``entropy="device-pack"``, SZP1) against
``repro``'s, bitwise: the pack/unpack kernels' plain versions and the
numpy host mirror against the Pallas kernels in interpret mode, the jnp
codec and the reference's host mirror on adversarial code arrays; SZP1
blobs byte for byte; whole device-pack artifacts for 2D and 3D fields in
f32 and f64; and each package decoding the other's artifacts.

On the CPU each wrapper runs its plain version. The CUDA kernels are
held against their plain versions by the test that needs a GPU (skipped
without one) and by ``chip_smoke.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import pipeline as jpipe, szlike as jsz
from repro.data import synthetic_field
from repro.kernels import pack as jpack
from _torch_threads import one_thread  # noqa: F401
from repro_torch.compress import pipeline as tpipe, szlike as tsz
from repro_torch.convert import artifact_from_dict, artifact_to_dict
from repro_torch.core import backend as tbackend
from repro_torch.kernels import pack as tpack

INT32_MIN, INT32_MAX = np.int32(-2**31), np.int32(2**31 - 1)


def _adversarial_cases():
    """The code arrays of the reference's ``tests/test_entropy.py``:
    chunk-boundary sizes, full-width magnitudes, sign edges, constants,
    empties."""
    rng = np.random.default_rng(7)
    C = tpack.CHUNK
    return {
        "empty": np.zeros(0, np.int32),
        "zeros": np.zeros(3 * C + 11, np.int32),
        "ones": np.ones(C - 1, np.int32),
        "minus_one": np.full(C + 1, -1, np.int32),
        "int32_min": np.full(17, INT32_MIN, np.int32),
        "int32_extremes": np.array(
            [INT32_MIN, INT32_MAX, 0, -1, 1,
             INT32_MIN + 1, INT32_MAX - 1], np.int32),
        "small": rng.integers(-5, 6, size=C // 2).astype(np.int32),
        "mixed_chunks": np.concatenate([
            rng.integers(-3, 4, size=C),             # narrow chunk
            rng.integers(-2**20, 2**20, size=C),     # wide chunk
            np.zeros(C, np.int32),                   # zero chunk (b=0)
            rng.integers(-2**30, 2**30, size=37),    # ragged tail
        ]).astype(np.int32),
        "chunk_exact": rng.integers(-1000, 1000, size=2 * C).astype(np.int32),
        "powers": np.array([-(2**k) for k in range(31)] +
                           [2**k for k in range(31)], np.int32),
    }


CASES = sorted(_adversarial_cases().items())


def _words(w):
    """An int32 tensor holding the bits of the uint32 stream ``w``."""
    return torch.from_numpy(np.array(w, np.uint32).view(np.int32))


def _streams(codes):
    """Every packer's (words uint32, bits int32) of ``codes``, keyed by
    name, each checked to give the same ``n_words``."""
    w_h, b_h = jpack.pack_codes_host(codes)
    out = {"repro.host": (w_h, b_h)}
    for tag, fn in (("repro.jnp", jpack.pack_codes_jnp),
                    ("repro.pallas", functools.partial(
                        jpack.pack_codes_pallas, interpret=True))):
        w, b, n = fn(jnp.asarray(codes))
        assert int(n) == w_h.size, tag
        out[tag] = (np.asarray(w)[:int(n)], np.asarray(b))
    w, b, n = tpack.pack_codes(torch.from_numpy(codes))
    assert n == w.numel() == w_h.size
    assert w.dtype == b.dtype == torch.int32
    out["port.plain"] = (w.numpy().view(np.uint32), b.numpy())
    out["port.host"] = tpack.pack_codes_host(codes)
    return out


@pytest.mark.parametrize("name,codes", CASES)
def test_pack_is_bitwise_every_reference_packer(name, codes):
    streams = _streams(codes)
    w_h, b_h = streams["repro.host"]
    for tag, (w, b) in streams.items():
        assert w.dtype == np.uint32, tag
        np.testing.assert_array_equal(w, w_h, err_msg=f"{name}/{tag} words")
        np.testing.assert_array_equal(b, b_h, err_msg=f"{name}/{tag} bits")


@pytest.mark.parametrize("name,codes", CASES)
def test_every_unpacker_inverts_the_stream(name, codes):
    w, b = jpack.pack_codes_host(codes)
    n = codes.size
    outs = {
        "port.plain": tpack.unpack_codes(_words(w),
                                         torch.from_numpy(b),
                                         codes.shape).numpy(),
        "port.reference_backend": tbackend.ReferenceBackend().unpack_codes(
            _words(w), torch.from_numpy(b),
            codes.shape).numpy(),
        "port.host": tpack.unpack_codes_host(w, b, n),
        "repro.host": jpack.unpack_codes_host(w, b, n),
        "repro.jnp": np.asarray(jpack.unpack_codes_jnp(
            jnp.asarray(w), jnp.asarray(b), codes.shape)),
        "repro.pallas": np.asarray(jpack.unpack_codes_pallas(
            jnp.asarray(w), jnp.asarray(b), codes.shape, interpret=True)),
    }
    for tag, got in outs.items():
        assert got.dtype == np.int32, tag
        np.testing.assert_array_equal(got, codes, err_msg=f"{name}/{tag}")


def test_plain_codec_keeps_shape_and_zigzag_matches_numpy():
    rng = np.random.default_rng(3)
    codes = rng.integers(-2**31, 2**31, size=(9, 70, 5),
                         dtype=np.int64).astype(np.int32)
    codes.reshape(-1)[:4] = [INT32_MIN, INT32_MAX, 0, -1]
    r = torch.from_numpy(codes)
    u = tpack.zigzag(r)
    assert np.array_equal(u.numpy().astype(np.uint32),
                          jpack._zigzag_np(codes))
    assert torch.equal(tpack.unzigzag(u), r)
    w, b, n = tpack.pack_codes(r)
    back = tpack.unpack_codes(w, b, codes.shape)
    assert back.shape == codes.shape and torch.equal(back, r)
    assert n == int(b.sum()) * tpack.words_per_plane()


@pytest.mark.parametrize("bad", ["n_chunks", "width", "short", "long"])
def test_bad_streams_raise_in_both_packages(bad):
    codes = _adversarial_cases()["mixed_chunks"]
    w, b = jpack.pack_codes_host(codes)
    w, b = w.copy(), b.copy()
    if bad == "n_chunks":
        b = b[:-1]
    elif bad == "width":
        b[1] = 33
    elif bad == "short":
        w = w[:-1]
    else:
        w = np.concatenate([w, np.zeros(32, np.uint32)])
    n = codes.size
    with pytest.raises(ValueError):
        jpack.unpack_codes_host(w, b, n)
    with pytest.raises(ValueError):
        tpack.unpack_codes_host(w, b, n)
    with pytest.raises(ValueError):
        tpack.unpack_codes(_words(w), torch.from_numpy(b),
                           codes.shape)
    with pytest.raises(ValueError):
        tbackend.ReferenceBackend().unpack_codes(
            _words(w), torch.from_numpy(b), codes.shape)


def test_wrappers_count_no_launch_on_cpu():
    before = (tpack.pack_launches, tpack.unpack_launches)
    codes = _adversarial_cases()["small"]
    w, b, _ = tbackend.CudaBackend().pack_codes(torch.from_numpy(codes))
    tbackend.CudaBackend().unpack_codes(w, b, codes.shape)
    assert (tpack.pack_launches, tpack.unpack_launches) == before
    with pytest.raises(ValueError, match="bits on"):
        tpack.unpack_codes(w, b.to("meta"), codes.shape)


# --- the kernels' chained scan (csrc/pack.cu), modelled in Python ------------
#
# Both CUDA kernels find their word offsets with a single-pass chained scan
# with decoupled look-back over tiles of ``per_block`` chunks. The model
# below runs the same protocol over the same scratch layout (meta[0]
# stream length, meta[1] widths outside [0, 32], meta[2] ticket, then a
# flag|value status word a tile), one generator a block, yielding at every
# global read or write, under seeded random schedules with a bounded
# number of resident blocks.

FLAG_A, FLAG_P = 1 << 62, 2 << 62
VALUE = FLAG_A - 1
META = tpack.scratch_size(0)
TILE = 8                                   # csrc/pack.cu's kTile


def _block(mem, widths, per_block, offsets):
    """One block: ticket; count and clamp bad widths; publish the tile's
    count; look back 32 tiles at a time (lane i at tile t-1-i, spinning
    on an empty status); publish the inclusive prefix, the last tile the
    stream length; each chunk's offset is the tile's plus the counts of
    the tile's chunks before it."""
    n_tiles = -(-len(widths) // per_block)
    t = mem[2]
    mem[2] += 1
    yield
    tile = [int(w) for w in widths[t * per_block:(t + 1) * per_block]]
    bad = sum(not 0 <= w <= 32 for w in tile)
    counts = [32 * min(max(w, 0), 32) for w in tile]
    count = sum(counts)
    mem[META + t] = (FLAG_P if t == 0 else FLAG_A) | count
    yield
    if bad:
        mem[1] += bad
        yield
    excl, end = 0, t
    while end > 0:
        window = []
        for lane in range(32):
            j = end - 1 - lane
            s = FLAG_P
            if j >= 0:
                while (s := mem[META + j]) < FLAG_A:
                    yield
                yield
            window.append(s)
        prefix = [s >= FLAG_P for s in window]
        stop = prefix.index(True) if any(prefix) else 31
        excl += sum(s & VALUE for s in window[:stop + 1])
        if any(prefix):
            break
        end -= 32
    if t > 0:
        mem[META + t] = FLAG_P | (excl + count)
        yield
    if t == n_tiles - 1:
        mem[0] = excl + count
    for i, c in enumerate(counts):
        offsets[t * per_block + i] = excl + sum(counts[:i])


def _run_scan(widths, resident, rng, per_block=1):
    """(scratch, chunk offsets) after every block has run, at most
    ``resident`` at a time, each step given to a random resident block."""
    n_tiles = -(-len(widths) // per_block)
    mem = [0] * tpack.scratch_size(len(widths))
    offsets = [None] * len(widths)
    waiting, running, steps = n_tiles, [], 0
    while waiting or running:
        while waiting and len(running) < resident:
            running.append(_block(mem, widths, per_block, offsets))
            waiting -= 1
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
        steps += 1
        assert steps < 10 ** 7, "the scan made no progress"
    return mem, offsets


@pytest.mark.parametrize("per_block", [1, TILE])
@pytest.mark.parametrize("n_chunks", [1, 2, 32, 33, 97, 300, 1500])
def test_chained_scan_gives_the_exclusive_scan(n_chunks, per_block):
    rng = np.random.default_rng(n_chunks)
    n_tiles = -(-n_chunks // per_block)
    for _ in range(4):
        widths = rng.choice([0, 1, 7, 31, 32], size=n_chunks)
        resident = int(rng.integers(1, 80))
        mem, offsets = _run_scan(widths, resident, rng, per_block)
        ends = np.cumsum(32 * widths)
        assert offsets == (ends - 32 * widths).tolist()
        assert mem[:META] == [int(ends[-1]), 0, n_tiles]
        tile_ends = ends[per_block - 1::per_block].tolist()
        if len(tile_ends) < n_tiles:
            tile_ends.append(int(ends[-1]))
        assert mem[META:META + n_tiles] == [FLAG_P | e for e in tile_ends]


@pytest.mark.parametrize("per_block", [1, TILE])
def test_chained_scan_counts_and_clamps_bad_widths(per_block):
    rng = np.random.default_rng(5)
    widths = rng.integers(0, 33, size=70)
    widths[[3, 40, 69]] = [33, -2, 1000]
    mem, offsets = _run_scan(widths, 16, rng, per_block)
    clamped = np.clip(widths, 0, 32) * 32
    assert offsets == (np.cumsum(clamped) - clamped).tolist()
    assert mem[0] == int(clamped.sum()) and mem[1] == 3
    with pytest.raises(ValueError, match=r"\[0, 32\]"):
        tpack._check_status(int(clamped.sum()), mem[0], mem[1])


def _bad_stream(bad):
    """The stream of ``mixed_chunks`` broken as ``bad`` says."""
    codes = _adversarial_cases()["mixed_chunks"]
    w, b = jpack.pack_codes_host(codes)
    w, b = w.copy(), b.copy()
    if bad == "n_chunks":
        b = b[:-1]
    elif bad == "width":
        b[1] = 33
    elif bad == "short":
        w = w[:-1]
    elif bad == "long":
        w = np.concatenate([w, np.zeros(32, np.uint32)])
    return codes, w, b


@pytest.mark.parametrize("bad", ["n_chunks", "width", "short", "long", None])
def test_launched_unpack_raises_for_every_bad_stream(bad, monkeypatch):
    """The wrapper's device path with the kernel emulated on the CPU (the
    scan model for the status, the plain decode or garbage for the
    codes): a bad stream raises ValueError and returns nothing, a good
    one returns the codes."""
    codes, w, b = _bad_stream(bad)
    launched = []

    def emulated(words, bits, out, scratch):
        mem, _ = _run_scan(bits.numpy(), 8, np.random.default_rng(0), TILE)
        # the kernel's uint64 status words in the int64 scratch
        scratch.copy_(torch.from_numpy(np.array(mem, np.uint64)
                                       .view(np.int64)))
        if bad is None:
            out.copy_(tpack.unpack_codes_plain(words, bits, out.shape))
        else:
            out.fill_(-1)
        launched.append(1)

    monkeypatch.setattr(tpack, "launch_unpack", emulated)
    monkeypatch.setattr(tpack, "unpack_launches", tpack.unpack_launches)
    call = functools.partial(tpack._unpack_launched, _words(w),
                             torch.from_numpy(b), codes.shape, codes.size)
    if bad is None:
        assert np.array_equal(call().numpy(), codes) and launched == [1]
        return
    with pytest.raises(ValueError) as info:
        call()
    with pytest.raises(ValueError) as want:
        tpack.check_stream(w.size, b, codes.size)
    # the host checks (chunk count) raise before any launch
    assert launched == ([] if bad == "n_chunks" else [1])
    assert str(info.value) == str(want.value)


# --- blob level -------------------------------------------------------------

def _field(name, shape, dtype):
    return synthetic_field(name, shape).astype(dtype)


BLOB_FIELDS = [("nyx", (12, 14, 16), np.float32),
               ("climate", (24, 30), np.float32),
               ("fingering", (10, 12, 14), np.float64),
               ("climate", (20, 28), np.float64)]


@pytest.mark.parametrize("name,shape,dtype", BLOB_FIELDS)
def test_szp1_blobs_are_byte_identical(name, shape, dtype):
    f = _field(name, shape, dtype)
    xi = 1e-3 * float(np.ptp(f))
    with jax.enable_x64(dtype == np.float64):
        ref = jsz.sz_compress(f, xi, entropy="device-pack")
        ref_r, *_ = jsz.sz_decode_residuals(jsz.sz_compress(f, xi))
    blob = tsz.sz_compress(f, xi, entropy="device-pack")
    assert blob == ref and blob[:4] == b"SZP1"
    assert tsz.sz_blob_entropy(blob) == "device-pack"
    assert tsz.sz_blob_entropy(tsz.sz_compress(f, xi)) == "deflate"
    # the pieces re-assemble to the same bytes on either side
    words, bits, shp, dt, step, chunk = tsz.sz_parse_packed(blob)
    assert (shp, dt, chunk) == (shape, np.dtype(dtype), tpack.CHUNK)
    assert tsz.sz_encode_packed(words, bits, shape, dtype, step) == ref
    assert jsz.sz_encode_packed(words, bits, shape, dtype, step) == ref
    # SZP1 and SZJ2 carry the same residual codes and decode alike
    r, *_ = tsz.sz_decode_residuals(blob)
    assert r.dtype == np.int64 and np.array_equal(r, ref_r)
    assert np.array_equal(tsz.sz_decompress(blob), jsz.sz_decompress(ref))
    assert np.array_equal(tsz.sz_decompress(blob),
                          tsz.sz_decompress(tsz.sz_compress(f, xi)))


def test_bad_szp1_blobs_raise_value_error_in_both_packages():
    f = _field("climate", (24, 30), np.float32)
    blob = tsz.sz_compress(f, 1e-2, entropy="device-pack")
    hdr = 4 + 1 + 1 + 8 + 8 + 8 * 2
    bad = {
        "truncated_header": blob[:10],
        "truncated_sub_header": blob[:hdr + 6],
        "truncated_words": blob[:-1],
        "over_long": blob + b"\0",
        "chunk_count": blob[:hdr + 4] + (7).to_bytes(4, "little")
        + blob[hdr + 8:],
        "chunk_size_zero": blob[:hdr] + bytes(4) + blob[hdr + 4:],
    }
    for label, b in bad.items():
        with pytest.raises(ValueError):
            jsz.sz_decode_residuals(b)
        with pytest.raises(ValueError):
            tsz.sz_decode_residuals(b)
        with pytest.raises(ValueError):
            tsz.sz_parse_packed(b)
    with pytest.raises(ValueError, match="not a packed"):
        tsz.sz_parse_packed(tsz.sz_compress(f, 1e-2))
    with pytest.raises(ValueError, match="bit-width table"):
        tsz.sz_encode_packed(np.zeros(0, np.uint32), np.zeros(3, np.int32),
                             (24, 30), np.float32, 0.1)
    with pytest.raises(ValueError, match="not an SZ-like"):
        tsz.sz_blob_entropy(b"XXXX")


# --- the slice as a whole ---------------------------------------------------

#: artifact fields that must agree (timings and backend differ by design)
KEYS = ("base_payload", "edit_payload", "fix_iters", "edit_ratio", "shape",
        "dtype", "xi", "path", "entropy", "base_magic", "version")

SLICE_FIELDS = [("nyx", (12, 14, 16), np.float32),
                ("climate", (24, 30), np.float32),
                ("nyx", (12, 14, 16), np.float64),
                ("climate", (24, 30), np.float64)]


@functools.lru_cache(maxsize=None)
def _reference_artifacts(name, shape, dtype):
    """The reference's device-pack artifacts on its ``reference`` and
    ``pallas`` (interpret) backends, and its g."""
    f = _field(name, shape, dtype)
    xi = 1e-3 * float(np.ptp(f))
    with jax.enable_x64(dtype == np.float64):
        arts = {be: jpipe.compress_preserving_mss(
            f, xi, entropy="device-pack", backend=be)
            for be in ("reference", "pallas")}
        g = jpipe.decompress_preserving_mss(arts["reference"],
                                            backend="reference")
    return f, xi, arts, g


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name,shape,dtype", SLICE_FIELDS)
def test_device_pack_artifact_is_bitwise_the_reference(name, shape, dtype,
                                                       backend):
    f, xi, refs, g_ref = _reference_artifacts(name, shape, dtype)
    art = tpipe.compress_preserving_mss(f, xi, entropy="device-pack",
                                        backend=backend, device="cpu")
    assert art.entropy == "device-pack" and art.base_magic == "SZP1"
    for ref in refs.values():
        assert ref.path == "device"
        for k in KEYS:
            assert getattr(art, k) == getattr(ref, k), k
    assert art.edit_payload == tpipe.compress_preserving_mss(
        f, xi, device="cpu").edit_payload
    g = tpipe.decompress_preserving_mss(art, backend=backend, device="cpu")
    assert g.dtype == dtype and np.array_equal(g, g_ref)
    assert np.array_equal(tpipe.decompress_artifact(art), g_ref)


@pytest.mark.parametrize("name,shape,dtype", SLICE_FIELDS)
def test_each_package_decodes_the_others_szp1_artifact(name, shape, dtype):
    f, xi, refs, g_ref = _reference_artifacts(name, shape, dtype)
    art = tpipe.compress_preserving_mss(f, xi, entropy="device-pack",
                                        device="cpu")
    g_port = tpipe.decompress_preserving_mss(
        artifact_from_dict(dataclasses.asdict(refs["pallas"])), device="cpu")
    with jax.enable_x64(dtype == np.float64):
        back = jpipe.CompressedArtifact(**artifact_to_dict(art))
        g_cross = jpipe.decompress_preserving_mss(back, backend="reference")
        g_cross_host = jpipe.decompress_artifact(back)
    assert np.array_equal(g_port, g_ref)
    assert np.array_equal(g_cross, g_ref)
    assert np.array_equal(g_cross_host, g_ref)


def test_device_path_szp1_decodes_without_host_code_decode(monkeypatch):
    f, xi, refs, g_ref = _reference_artifacts("climate", (24, 30),
                                              np.float32)
    art = tpipe.compress_preserving_mss(f, xi, entropy="device-pack",
                                        device="cpu")
    calls = []
    real = tpack.unpack_codes

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    def no_host_decode(blob):
        raise AssertionError("the device-path SZP1 read decoded on the host")

    monkeypatch.setattr(tpack, "unpack_codes", counting)
    monkeypatch.setattr(tsz, "sz_decode_residuals", no_host_decode)
    g = tpipe.decompress_preserving_mss(art, backend="cuda", device="cpu")
    assert calls == [1] and np.array_equal(g, g_ref)


def test_other_szp1_artifacts_decode_through_the_host_mirror():
    f, xi, refs, g_ref = _reference_artifacts("nyx", (12, 14, 16),
                                              np.float32)
    art = tpipe.compress_preserving_mss(f, xi, entropy="device-pack",
                                        device="cpu")
    host_path = dataclasses.replace(art, path="host")
    assert np.array_equal(
        tpipe.decompress_preserving_mss(host_path, device="cpu"), g_ref)
    # a chunk size other than CHUNK is a format the host decoder reads
    r, shape, dtype, step = tsz.sz_decode_residuals(art.base_payload)
    words, bits = tpack.pack_codes_host(r, chunk=64)
    odd = tsz.sz_encode_packed(words, bits, shape, dtype, step, chunk=64)
    assert odd == jsz.sz_encode_packed(words, bits, shape, dtype, step,
                                       chunk=64)
    odd_art = dataclasses.replace(art, base_payload=odd)
    g = tpipe.decompress_preserving_mss(odd_art, device="cpu")
    g_jax = jpipe.decompress_preserving_mss(
        jpipe.CompressedArtifact(**artifact_to_dict(odd_art)),
        backend="reference")
    assert np.array_equal(g, g_ref) and np.array_equal(g_jax, g_ref)


def test_cuda_pack_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(11)
    cases = dict(CASES)
    cases["full_range"] = rng.integers(-2**31, 2**31, size=10**6,
                                       dtype=np.int64).astype(np.int32)
    for name, codes in cases.items():
        r = torch.from_numpy(codes).cuda()
        w, b, n = tpack.pack_codes(r)
        w_p, b_p, n_p = tpack.pack_codes_plain(r)
        assert n == n_p and torch.equal(w, w_p) and torch.equal(b, b_p), name
        back = tpack.unpack_codes(w, b, codes.shape)
        assert torch.equal(back, tpack.unpack_codes_plain(w, b, codes.shape))
        assert torch.equal(back, r), name
    for bad in ("n_chunks", "width", "short", "long"):
        codes, w, b = _bad_stream(bad)
        with pytest.raises(ValueError):
            tpack.unpack_codes(_words(w).cuda(), torch.from_numpy(b).cuda(),
                               codes.shape)
        torch.cuda.synchronize()


def test_width_table_that_disagrees_with_the_words_raises():
    f, xi, refs, _ = _reference_artifacts("climate", (24, 30), np.float32)
    art = artifact_from_dict(dataclasses.asdict(refs["reference"]))
    words, bits, shape, dtype, step, _ = tsz.sz_parse_packed(
        art.base_payload)
    bits = bits.copy()
    bits[0] += 1                 # the widths now demand 32 more words
    bad = dataclasses.replace(art, base_payload=tsz.sz_encode_packed(
        words, bits, shape, dtype, step))
    with pytest.raises(ValueError, match="expected"):
        jpipe.decompress_artifact(
            jpipe.CompressedArtifact(**artifact_to_dict(bad)))
    for backend in ("reference", "cuda"):
        with pytest.raises(ValueError, match="expected"):
            tpipe.decompress_preserving_mss(bad, backend=backend,
                                            device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tpipe.decompress_artifact(bad)
