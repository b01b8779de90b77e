#!/usr/bin/env python3
"""Time the port's bitplane pack and unpack kernels of several source
trees on one GPU, in turns, each in its own process.

    python3 tools/pack_ab.py --tree build/parent --tree . --tree . \\
        --tree build/parent

A tree is a directory holding ``src/repro_torch`` (a checkout, or a
``git archive`` of one). Each ``--tree`` runs in a fresh process that
imports that tree's ``repro_torch``, builds its ``pack.cu``, quantizes
the nyx 512^3 and climate 1800x3600 fields with its Lorenzo kernel and
times, at both sizes:

* ``wrapper_ms``: the median of ``--reps`` CUDA-event-timed calls of
  ``pack_codes`` / ``unpack_codes`` (host work included), every call's
  output compared bitwise with the first;
* ``device_ms``: CUDA events around ``--launches`` back-to-back
  launches of the C entry points alone on preallocated buffers, over
  the count (the two-launch design of ``msz_pack_widths`` +
  ``msz_pack_planes`` with its offsets computed once beforehand, or
  the one-launch ``msz_pack``; ``msz_unpack`` either way), the last
  launch's output compared bitwise with the wrapper's.

The timing helpers and the bound are ``chip_smoke.py``'s. Every tree
must produce the same stream (sha256 of words and widths) and decode it
back to the codes. Stdout: one JSON record per tree and
size, then a summary by design; the last line ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _device_calls(kp, lib, r, words, bits):
    """(design, pack launch, unpack launch, pack outputs, unpack output)
    of the tree's C entry points on preallocated buffers."""
    import torch
    from repro_torch.kernels import _build
    n = r.numel()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(r)
    b = torch.empty_like(bits)
    if hasattr(lib, "msz_pack_widths"):             # two launches
        offsets, _ = kp._offsets(bits, kp.words_per_plane())
        w = torch.empty_like(words)
        widths = _build.entry(lib, "msz_pack_widths", 2, 1, 0)
        planes = _build.entry(lib, "msz_pack_planes", 4, 1, 0)
        unpack = _build.entry(lib, "msz_unpack", 4, 1, 0)

        def pack():
            widths(r.data_ptr(), b.data_ptr(), n, stream)
            planes(r.data_ptr(), b.data_ptr(), offsets.data_ptr(),
                   w.data_ptr(), n, stream)

        def unpack_():
            unpack(words.data_ptr(), bits.data_ptr(), offsets.data_ptr(),
                   out.data_ptr(), n, stream)
        return "two-pass", pack, unpack_, (w, b), out
    w = torch.empty(bits.numel() * kp.CHUNK, dtype=torch.int32,
                    device=r.device)
    s = torch.empty(kp.scratch_size(bits.numel()), dtype=torch.int64,
                    device=r.device)
    return ("single-pass", lambda: kp.launch_pack(r, w, b, s),
            lambda: kp.launch_unpack(words, bits, out, s),
            (w[:words.numel()], b), out)


def worker(tree: Path, nyx: int, climate: str, reps: int,
           launches: int) -> None:
    sys.path.insert(0, str(tree.resolve() / "src"))
    sys.path.append(str(ROOT))
    import numpy as np
    import torch
    from chip_smoke import back_to_back_ms, cuda_time_checked_ms, pack_bound
    from repro_torch.compress import szlike
    from repro_torch.data import synthetic_field
    from repro_torch.kernels import _build, lorenzo as kl, pack as kp
    lib = _build.load("pack")
    shapes = {"nyx": (nyx,) * 3,
              "climate": tuple(int(s) for s in climate.split("x"))}
    for label, shape in shapes.items():
        f_np = synthetic_field(label, shape)
        xi = 1e-3 * float(np.ptp(f_np))
        f = torch.from_numpy(f_np).cuda()
        step = torch.tensor(szlike.effective_step(f_np, xi), dtype=f.dtype,
                            device="cuda")
        r = kl.lorenzo_quant(f, step)
        del f
        words, bits, n_words = kp.pack_codes(r)
        words, bits = words.clone(), bits.clone()
        shp = tuple(r.shape)
        wrap_pack = cuda_time_checked_ms(
            lambda: kp.pack_codes(r),
            lambda o: o[2] == n_words and torch.equal(o[0], words)
            and torch.equal(o[1], bits), reps)
        wrap_unpack = cuda_time_checked_ms(
            lambda: kp.unpack_codes(words, bits, shp),
            lambda o: torch.equal(o, r), reps)
        design, pack, unpack, (w_d, b_d), out = _device_calls(
            kp, lib, r.reshape(-1), words, bits)
        dev_pack = back_to_back_ms(pack, launches)
        dev_unpack = back_to_back_ms(unpack, launches)
        if not (torch.equal(w_d, words) and torch.equal(b_d, bits)
                and torch.equal(out, r.reshape(-1))):
            raise AssertionError(f"{tree} {label}: the entry points' output "
                                 "differs from the wrappers'")
        bound_pack, bound_unpack = pack_bound(r.numel(), n_words)
        print(json.dumps({
            "tree": str(tree), "design": design, "field": label,
            "shape": list(shp), "n_words": n_words,
            "n_chunks": bits.numel(), "digest": _digest(words, bits),
            "pack": {"wrapper_ms": wrap_pack, "device_ms": dev_pack,
                     "bound_ms": bound_pack},
            "unpack": {"wrapper_ms": wrap_unpack, "device_ms": dev_unpack,
                       "bound_ms": bound_unpack}}), flush=True)
        del r, words, bits, w_d, b_d, out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, default=[],
                    help="a source tree to time (repeat, in run order)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--nyx", type=int, default=512)
    ap.add_argument("--climate", default="1800x3600")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed wrapper calls per kernel (median)")
    ap.add_argument("--launches", type=int, default=50,
                    help="back-to-back launches of each entry point")
    args = ap.parse_args(argv)
    sizes = ["--nyx", str(args.nyx), "--climate", args.climate,
             "--reps", str(args.reps), "--launches", str(args.launches)]
    if args.worker is not None:
        worker(args.worker, args.nyx, args.climate, args.reps, args.launches)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("pack_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    records = []
    for tree in args.tree or [Path(".")]:
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(tree), *sizes], capture_output=True,
                             text=True)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"pack_ab: tree {tree} failed "
                             f"(rc={out.returncode})")
        records += [json.loads(ln) for ln in out.stdout.splitlines()]
    for field in {r["field"] for r in records}:
        if len({r["digest"] for r in records if r["field"] == field}) != 1:
            raise SystemExit(f"pack_ab: the trees' {field} streams differ")
    summary = {}
    for r in records:
        cell = summary.setdefault(f"{r['design']} {r['field']}", {})
        for k in ("pack", "unpack"):
            for m in ("wrapper_ms", "device_ms"):
                cell.setdefault(f"{k}_{m}", []).append(r[k][m])
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
