"""The paper's compression sweep on the PyTorch/CUDA port, as
``examples/topo_pipeline.py`` runs it on ``repro``: datasets x base
compressors x error bounds, exact MSS preservation verified on every
cell, and the paper's metrics printed (OCR, OBR, edit ratio, PSNR,
right-labeled ratio before correction).

  PYTHONPATH=src python examples/torch_topo_pipeline.py [--full] [--stream]

It runs on the GPU unless ``--device cpu`` says otherwise; without a GPU
it raises instead of falling back to the CPU. On the card each szlike
cell launches the ``lorenzo``, ``extrema`` and ``fixpass`` kernels, each
zfplike cell the last two. Both directions default to the
device-resident paths; every flag combination below produces
bitwise-identical artifacts and outputs, the flags change execution
strategy only.

  --full           paper-scale dataset sizes and the full bound sweep
  --backend B      stencil backend for the fix loops
                   (auto | cuda | cuda_tiled | cuda_worklist | reference |
                   sharded)
  --devices N      slab-shard fix loops/transforms over an N-block
                   ('data',) chain: a card a block, or the blocks placed
                   round robin on the cards there are; every block on
                   the CPU under --device cpu
  --host-path      force the host byte-codec COMPRESS path (default:
                   device-resident whenever preconditions hold)
  --decode-path P  decompression path: auto | host | device
  --stream         route each dataset's szlike cells through the
                   streaming scheduler (repro_torch.compress.stream)
                   instead of one-shot calls, and print its stats line;
                   artifacts stay byte-identical
  --device D       cuda (the default) or cpu

``main(argv)`` returns the table's rows as dicts.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compress import (CompressStream, compress_preserving_mss,
                                  decompress_artifact,
                                  decompress_preserving_mss,
                                  overall_bit_rate,
                                  overall_compression_ratio, psnr,
                                  sz_roundtrip, zfp_roundtrip)
from repro_torch.core import (available_backends, segmentation_accuracy,
                              verify_preservation)
from repro_torch.data import synthetic_field
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import round_robin_data_mesh


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--backend", default="auto",
                    choices=("auto",) + available_backends(),
                    help="stencil backend for the fix loops")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the fix loops over an N-block ('data',) "
                         "chain (round robin on fewer cards)")
    ap.add_argument("--host-path", action="store_true",
                    help="force the host byte-codec path (default: the "
                         "device-resident path whenever its preconditions "
                         "hold; artifacts are bitwise identical either way)")
    ap.add_argument("--decode-path", default="auto",
                    choices=("auto", "host", "device"),
                    help="decompression path: 'device' forces the "
                         "device-resident decode (szlike artifacts only; "
                         "zfplike rows fall back to auto), 'host' the "
                         "byte-codec loop; outputs are bitwise identical")
    ap.add_argument("--stream", action="store_true",
                    help="serve each dataset's szlike cells through the "
                         "streaming scheduler instead of one-shot calls; "
                         "artifacts stay byte-identical")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = _parse_args(argv)
    dev = resolve_device(args.device)
    mesh = round_robin_data_mesh(args.devices, dev)
    if mesh is not None:
        print(f"# sharding fix loops over {args.devices} devices (mesh axes "
              f"{mesh.shape})")
    datasets = {
        "molecular": (24, 24, 12),
        "nyx": (24, 24, 24),
        "climate": (48, 96),
    }
    if args.full:
        datasets = {"molecular": (48, 48, 24), "nyx": (64, 64, 64),
                    "climate": (180, 360), "combustion": (64, 64, 64),
                    "fingering": (48, 48, 48)}
    bounds = (1e-4, 1e-3) if not args.full else (1e-5, 1e-4, 1e-3, 1e-2)

    device_path = False if args.host_path else "auto"
    stream = None
    if args.stream:
        stream = CompressStream(window=2 * len(bounds), max_batch=len(bounds),
                                backend=args.backend, mesh=mesh,
                                device_path=device_path, device=dev)
    print(f"{'dataset':12s} {'base':8s} {'rel_xi':8s} {'raw_right%':>10s} "
          f"{'OCR':>6s} {'OBR':>6s} {'edit%':>7s} {'PSNR':>6s} {'t_fix':>6s} "
          f"{'path':6s} ok")
    rows = []
    for name, shape in datasets.items():
        f = synthetic_field(name, shape=shape)
        rng = float(np.ptp(f))
        f_dev = torch.as_tensor(f, device=dev)
        for base, rt in (("szlike", sz_roundtrip), ("zfplike", zfp_roundtrip)):
            futs = None
            if stream is not None and base == "szlike":
                # every bound's request in flight at once: same-spec cells
                # coalesce into batched device dispatches
                futs = {rel: stream.submit(f, rel * rng) for rel in bounds}
            for rel in bounds:
                xi = rel * rng
                fh, _ = rt(f, xi)
                raw_acc = float(segmentation_accuracy(
                    f_dev, torch.as_tensor(fh, device=dev)))
                art = futs[rel].result() if futs is not None else \
                    compress_preserving_mss(f, xi, base=base,
                                            backend=args.backend,
                                            mesh=mesh,
                                            device_path=device_path,
                                            device=dev)
                if args.decode_path == "host":
                    g = decompress_artifact(art)
                else:
                    # 'device' forces the device decode for szlike rows;
                    # zfplike has no device reconstruct, so fall back to
                    # auto there (bitwise identical output either way)
                    dp = True if (args.decode_path == "device"
                                  and base == "szlike") else "auto"
                    g = decompress_preserving_mss(art, device_path=dp,
                                                  backend=args.backend,
                                                  mesh=mesh, device=dev)
                rep = verify_preservation(f, g, xi, device=dev)
                ok = rep["mss_preserved"] and rep["bound_ok"]
                row = {"dataset": name, "base": base, "rel_xi": rel,
                       "raw_right": raw_acc,
                       "ocr": overall_compression_ratio(f, art),
                       "obr": overall_bit_rate(f, art),
                       "edit_ratio": art.edit_ratio, "psnr": psnr(f, g),
                       "t_fix": art.t_fix, "path": art.path, "ok": ok}
                rows.append(row)
                print(f"{name:12s} {base:8s} {rel:<8g} {100*raw_acc:10.2f} "
                      f"{row['ocr']:6.2f} {row['obr']:6.2f} "
                      f"{100*art.edit_ratio:7.3f} {row['psnr']:6.1f} "
                      f"{art.t_fix:6.2f} {art.path:6s} {ok}")
                assert ok, (name, base, rel)
    if stream is not None:
        st = stream.stats()
        stream.close()
        print(f"# stream: {st['completed']} cells in {st['batches']} batches, "
              f"occupancy={st['batch_occupancy']:.2f}, "
              f"{st['fields_per_sec']:.2f} fields/s")
    print("all cells preserved MSS exactly within bounds")
    return rows


if __name__ == "__main__":
    main()
