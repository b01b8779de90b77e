"""Compression-service launcher on one GPU: drive
``repro_torch.serve.compression`` with synthetic streaming traffic and
report service metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --fields 16 \\
      --shape 128,128,128 --window 8 --max-batch 4 --verify

The flags are those of ``repro.launch.serve``. It generates a stream of
synthetic scalar fields (mixed shapes and bounds with ``--mixed``),
submits them through a ``CompressionService`` — coalesced into batched
device stages, entropy coding overlapped on worker threads — then
round-trips every artifact through the decompress stream.
``--stats-port P`` serves the live stats document at
``http://127.0.0.1:P/stats`` while the run is in flight. ``--verify``
checks exact MSS preservation and byte-identity against the one-shot
pipeline on every request. ``--devices N`` (N > 1) serves every fix loop
sharded over an N-block ``('data',)`` mesh: a block a card where N
cards are visible, else the blocks placed round robin on the cards
there are (said in the printout) — the counterpart of the reference's
emulated host devices, still on the card. Runs on CUDA; a caller of
``main`` may pass ``device="cpu"`` (the blocks then lie on the CPU).
"""
from __future__ import annotations

import argparse
import time

from ..device import DeviceLike


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fields", type=int, default=16,
                    help="number of fields in the synthetic request stream")
    ap.add_argument("--shape", default="24,24,24",
                    help="comma-separated field shape (2D or 3D)")
    ap.add_argument("--xi-rel", type=float, default=1e-3,
                    help="error bound as a fraction of each field's range")
    ap.add_argument("--window", type=int, default=8,
                    help="in-flight request bound (backpressure window)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="dynamic-batching limit per device stage")
    ap.add_argument("--coalesce-ms", type=float, default=2.0,
                    help="linger for batch stragglers before dispatching")
    ap.add_argument("--backend", default="auto",
                    help="stencil backend (auto | reference | cuda | "
                         "cuda_tiled | cuda_worklist)")
    ap.add_argument("--devices", type=int, default=0,
                    help="serve every fix loop sharded over an N-block "
                         "('data',) mesh (round robin on fewer cards)")
    ap.add_argument("--mixed", action="store_true",
                    help="mix a second field shape and per-request bounds "
                         "into the traffic (exercises per-spec batching)")
    ap.add_argument("--stats-port", type=int, default=0,
                    help="serve GET /stats JSON on this port while running "
                         "(0 = no HTTP endpoint)")
    ap.add_argument("--verify", action="store_true",
                    help="verify MSS preservation + byte-identity vs the "
                         "one-shot pipeline on every request")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny quick-run preset (implies --verify)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _mesh(n: int, dev):
    """The ``--devices N`` mesh: N blocks of a ``('data',)`` chain, one
    a card, or round robin on the cards there are (on the CPU when the
    run is on the CPU); None for N <= 1."""
    if n <= 1:
        return None
    import torch

    from .mesh import make_data_mesh
    if dev.type == "cpu":
        places = ["cpu"] * n
    else:
        count = torch.cuda.device_count()
        places = [f"cuda:{i % count}" for i in range(n)]
        if count < n:
            print(f"# {n} blocks on {count} visible card(s): placed round "
                  f"robin ({', '.join(places)})")
    mesh = make_data_mesh(n, devices=places)
    print(f"# serving over {n} blocks (mesh axes {mesh.shape})")
    return mesh


def main(argv=None, *, device: DeviceLike = None):
    args = _parse_args(argv)
    if args.smoke:
        args.fields = min(args.fields, 8)
        args.shape = "12,12,12"
        args.verify = True

    import numpy as np

    from ..compress import compress_preserving_mss
    from ..core import verify_preservation
    from ..data import synthetic_field
    from ..device import resolve_device
    from ..serve import CompressionService, ServiceConfig
    from ..serve.compression import start_stats_server

    dev = resolve_device(device)
    shape = tuple(int(s) for s in args.shape.split(","))
    mesh = _mesh(args.devices, dev)
    shapes = [shape] * args.fields
    if args.mixed:
        alt = tuple(max(s // 2, 8) for s in shape)
        shapes = [shape if i % 3 else alt for i in range(args.fields)]
    rng = np.random.default_rng(args.seed)
    fields = [synthetic_field("nyx", shape=sh, seed=int(rng.integers(1 << 30)))
              .astype(np.float32) for sh in shapes]
    xis = [args.xi_rel * float(np.ptp(f)) for f in fields]
    if args.mixed:
        xis = [x * (0.5 if i % 2 else 1.0) for i, x in enumerate(xis)]

    cfg = ServiceConfig(window=args.window, max_batch=args.max_batch,
                        coalesce_ms=args.coalesce_ms, backend=args.backend,
                        mesh=mesh, device=dev)
    with CompressionService(cfg) as service:
        server = None
        if args.stats_port:
            server = start_stats_server(service, port=args.stats_port)
            host, port = server.server_address[:2]
            print(f"# stats endpoint: http://{host}:{port}/stats")
        try:
            t0 = time.perf_counter()
            comp_futs = [service.submit_compress(f, xi)
                         for f, xi in zip(fields, xis)]
            arts = [fut.result() for fut in comp_futs]
            t_comp = time.perf_counter() - t0

            t0 = time.perf_counter()
            dec_futs = [service.submit_decompress(a) for a in arts]
            outs = [fut.result() for fut in dec_futs]
            t_dec = time.perf_counter() - t0

            if args.verify:
                for f, xi, art, g in zip(fields, xis, arts, outs):
                    solo = compress_preserving_mss(f, xi,
                                                   backend=args.backend,
                                                   device=dev)
                    if (art.base_payload != solo.base_payload
                            or art.edit_payload != solo.edit_payload):
                        raise RuntimeError("service artifact differs from "
                                           "the one-shot pipeline")
                    rep = verify_preservation(f, g, xi, device=dev)
                    if not (rep["mss_preserved"] and rep["bound_ok"]):
                        raise RuntimeError(f"MSS not preserved: {rep}")
                print(f"# verified: {len(arts)} artifacts byte-identical "
                      "to the one-shot path, MSS preserved on every request")

            st = service.stats()
            for leg, dt in (("compress", t_comp), ("decompress", t_dec)):
                s = st[leg]
                print(f"{leg:10s} {args.fields / dt:8.2f} fields/s  "
                      f"batches={s['batches']:3d}  "
                      f"occupancy={s['batch_occupancy']:.2f}  "
                      f"max_in_flight={s['max_in_flight']}  "
                      f"h2d={s['nbytes_h2d']}B d2h={s['nbytes_d2h']}B  "
                      f"cache={s['cache']['hits']}h/{s['cache']['misses']}m")
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
    print("OK")
    return arts


if __name__ == "__main__":
    main()
