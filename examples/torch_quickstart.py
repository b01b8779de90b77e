"""Quickstart on the PyTorch/CUDA port: MSS-preserving compression of a
scalar field, as ``examples/quickstart.py`` does it on ``repro``.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --codec zfplike
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

It runs on the GPU unless ``--device cpu`` says otherwise; without a GPU
it raises instead of falling back to the CPU. Both directions take the
device-resident paths when their preconditions hold: one h2d of f, the
quantize+Lorenzo kernel (``lorenzo``), the fused fix loop (the
``extrema`` and ``fixpass`` kernels) and the edit extraction on the
card, one d2h of the residual codes; the mirror on the read side. The
``zfplike`` base runs its transform on the host and its fix loop on the
card. Then a batch of four timesteps through one batched fix loop, and
the same series through the streaming scheduler, each artifact byte
identical to the batch's.

``main(argv)`` returns the artifacts, reports and printed figures.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.compress import (CompressStream,
                                  available_preserving_codecs,
                                  compress_preserving_mss,
                                  compress_preserving_mss_batch,
                                  decompress_artifact,
                                  decompress_preserving_mss,
                                  overall_compression_ratio)
from repro_torch.core import verify_preservation
from repro_torch.data import synthetic_field
from repro_torch.device import resolve_device


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--codec", default="szlike",
                    choices=available_preserving_codecs(),
                    help="base codec the MSz edits correct (default: szlike)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = _parse_args(argv)
    dev = resolve_device(args.device)
    codec = args.codec

    # a cosmology-like 3D scalar field (stands in for the paper's Nyx data)
    f = synthetic_field("nyx", shape=(32, 32, 32))
    xi = 1e-3 * float(np.ptp(f))          # absolute error bound

    # compress with the chosen base compressor + MSz edits (paper Fig. 3);
    # the fix loop runs on the card's stencil backend (auto: cuda)
    art = compress_preserving_mss(f, xi, codec=codec, device=dev)
    g = decompress_preserving_mss(art, device=dev)

    report = verify_preservation(f, g, xi, device=dev)
    ratio = overall_compression_ratio(f, art)
    print(f"base codec: {art.base} (payload magic {art.base_magic})")
    print(f"stencil backend: {art.backend}")
    print(f"compression ratio (incl. edits): {ratio:.2f}x")
    print(f"edit ratio: {art.edit_ratio:.4%} of vertices")
    print(f"error bound held:       {report['bound_ok']}  "
          f"(max|f-g|={report['max_abs_err']:.3g} <= {xi:.3g})")
    print(f"MS segmentation exact:  {report['mss_preserved']}")
    print(f"right-labeled ratio:    {report['right_labeled_ratio']:.4f}")
    assert report["mss_preserved"] and report["bound_ok"]

    # batched: a short timestep series through ONE batched fix loop
    series = [synthetic_field("nyx", shape=(16, 16, 16), seed=s)
              for s in range(4)]
    xis = [1e-3 * float(np.ptp(fi)) for fi in series]
    arts = compress_preserving_mss_batch(series, xis, codec=codec, device=dev)
    for fi, xi_i, a in zip(series, xis, arts):
        rep = verify_preservation(fi, decompress_artifact(a), xi_i, device=dev)
        assert rep["mss_preserved"] and rep["bound_ok"]
    print(f"batch of {len(arts)} timesteps: MSS preserved on every member")

    # streaming: the same series through the double-buffered scheduler;
    # every artifact byte-identical to its batch counterpart
    with CompressStream(window=4, max_batch=4, device=dev) as cs:
        futs = [cs.submit(fi, xi_i, base=codec)
                for fi, xi_i in zip(series, xis)]
        stream_arts = [fut.result() for fut in futs]
        occupancy = cs.stats()["batch_occupancy"]
    assert all(sa.base_payload == a.base_payload
               and sa.edit_payload == a.edit_payload
               for sa, a in zip(stream_arts, arts))
    print(f"stream of {len(stream_arts)} timesteps: batch occupancy "
          f"{occupancy:.2f}, artifacts byte-identical")
    print("OK")
    return {"field": f, "xi": xi, "artifact": art, "report": report,
            "ratio": ratio, "batch": arts, "stream": stream_arts,
            "occupancy": occupancy}


if __name__ == "__main__":
    main()
