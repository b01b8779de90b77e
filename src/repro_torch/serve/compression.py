"""repro_torch.serve.compression — the request-batched
topology-preserving compression service, the port of
``repro.serve.compression``.

``CompressionService`` sits on the streaming scheduler
(``repro_torch.compress.stream``): concurrent callers submit compress and
decompress requests with per-request error bounds (``xi``) and base
codec selection; the service coalesces same-shape/same-dtype requests
inside a bounded window into batched device dispatches, applies
backpressure when the window fills (block or reject, per config), and
exposes a stats surface — fields/sec, batch occupancy, transfer bytes,
cache hit rates — as a dict and, via ``start_stats_server``, as a
plain-HTTP JSON endpoint.

Requests are served by the same pipeline the one-shot API uses, so every
artifact and every decompressed field is byte-identical to a solo
``compress_preserving_mss`` / ``decompress_preserving_mss`` call; the
service only changes *when* work runs, never *what* it computes. It runs
on one GPU (``device=None``) or, when the config asks, on the CPU; with
a mesh (``ServiceConfig(mesh=...)``) every fix loop runs on the mesh's
blocks, ``stats()["compress"]["shard"]`` counts the halo bytes, and
``shard_timings()`` probes one sharded iteration's parts.

    service = CompressionService(ServiceConfig(window=16, max_batch=4))
    fut = service.submit_compress(field, xi=1e-3)
    art = fut.result()
    g = service.decompress(art)
    print(service.stats()["compress"]["fields_per_sec"])
    service.close()
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

from ..compress import pipeline
from ..compress.stream import (CompressStream, DecompressStream,
                               StreamBackpressure)
from ..core.backend import BackendLike
from ..device import DeviceLike

__all__ = ["ServiceConfig", "ServiceOverloaded", "CompressionService",
           "start_stats_server"]


class ServiceOverloaded(RuntimeError):
    """Raised by submit calls when the in-flight window is full and the
    service runs with ``overload="reject"`` (the HTTP-429 analogue);
    ``overload="block"`` applies backpressure by waiting instead."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tuning knobs of one ``CompressionService``.

    ``window``
        In-flight request bound per direction (compress / decompress).
        This is the backpressure contract: at most ``window`` requests
        hold memory at once; producers beyond it block or get
        ``ServiceOverloaded`` (see ``overload``).
    ``max_batch``
        Dynamic-batching limit: up to this many same-(shape, dtype,
        codec) requests coalesce into one batched device dispatch.
    ``coalesce_ms``
        How long a sub-full batch lingers for stragglers before
        dispatching — the service's latency/occupancy trade-off.
    ``backend`` / ``mesh`` / ``device_path`` / ``max_iters``
        Forwarded to the pipeline (see ``compress_preserving_mss``);
        a mesh (``repro_torch.launch.mesh``) shards every fix loop.
    ``workers``
        Host worker threads per stream for entropy coding/decoding
        (default: scales with ``max_batch``). Device-pack requests
        (``entropy="device-pack"``) never touch these workers — their
        entropy streams are built on the device.
    ``cache_size``
        LRU capacity of each stream's dispatch-spec cache
        (``repro_torch.compress.stream.SpecCache``).
    ``pad_pow2``
        Pad coalesced batches to power-of-two member counts, as the
        reference does.
    ``fix_batching``
        ``"fused"`` runs each batch's fix loops as one batched loop,
        ``"pipelined"`` as per-member solo loops behind a shared
        transform; ``"auto"`` fuses members up to a voxel threshold
        (see ``CompressStream``).
    ``fused_fix_voxels``
        The "auto" policy's voxel threshold. ``None`` (default) derives
        it from the one-shot machine calibration in
        ``repro_torch.compress.calibrate`` (cached per backend/dtype/
        device type; ``MSZ_FUSED_FIX_VOXELS`` overrides); an explicit
        integer pins it. The per-batch decisions appear under
        ``fix_modes`` in ``stats()``.
    ``device``
        Where the service runs: ``None`` means CUDA (raises without a
        GPU); ``"cpu"`` runs the plain versions.
    ``overload``
        ``"block"``: submits wait for a window slot (backpressure);
        ``"reject"``: submits raise ``ServiceOverloaded`` immediately.
    """
    window: int = 16
    max_batch: int = 4
    coalesce_ms: float = 2.0
    backend: BackendLike = "auto"
    mesh: Optional[object] = None
    device_path: object = "auto"
    max_iters: int = 512
    workers: Optional[int] = None
    cache_size: int = 32
    pad_pow2: bool = True
    fix_batching: str = "auto"
    fused_fix_voxels: Optional[int] = None
    overload: str = "block"
    device: DeviceLike = None

    def __post_init__(self):
        if self.overload not in ("block", "reject"):
            raise ValueError(
                f'overload must be "block" or "reject", got {self.overload!r}')


class CompressionService:
    """Request queue + dynamic batching + backpressure around one
    ``CompressStream`` and one ``DecompressStream``.

    Thread-safe: any number of producer threads may submit concurrently;
    results arrive on ``concurrent.futures.Future``s. Close with
    ``close()`` (or use as a context manager) to drain in-flight work.
    """

    def __init__(self, config: ServiceConfig = ServiceConfig()):
        self.config = config
        kw = dict(window=config.window, max_batch=config.max_batch,
                  linger_ms=config.coalesce_ms, backend=config.backend,
                  mesh=config.mesh, device_path=config.device_path,
                  max_iters=config.max_iters, workers=config.workers,
                  cache_size=config.cache_size, pad_pow2=config.pad_pow2,
                  fix_batching=config.fix_batching,
                  fused_fix_voxels=config.fused_fix_voxels,
                  device=config.device)
        self._compress = CompressStream(**kw)
        self._decompress = DecompressStream(**kw)
        self._t_start = time.perf_counter()
        self._lock = threading.Lock()
        self._shard_probe = None               # guarded-by: self._lock

    # -- submission ---------------------------------------------------
    def _guard(self, submit, *args, **kw) -> Future:
        try:
            return submit(*args, block=self.config.overload == "block", **kw)
        except StreamBackpressure as exc:
            raise ServiceOverloaded(
                f"service window full ({self.config.window} in-flight "
                "requests); retry later or configure overload='block'"
            ) from exc

    def submit_compress(self, field: np.ndarray, xi: float, *,
                        base: str = "szlike",
                        edit_value_dtype: str = "auto",
                        entropy: str = "deflate",
                        codec: Optional[str] = None) -> Future:
        """Queue a field; the Future resolves to its
        ``CompressedArtifact`` (byte-identical to the one-shot call).
        ``xi``, ``base``, and ``entropy`` ("deflate" | "device-pack")
        are free per request — only same-(shape, dtype, base, entropy)
        requests share a batch. ``codec`` is the pipeline's alias for
        ``base`` (overrides it when given — zfplike batches through the
        host correction path).
        Device-pack batches do their residual entropy coding on the
        device, bypassing the host worker pool entirely; ``stats()``
        breaks traffic down per codec under ``entropy_codecs``."""
        if codec is not None:
            base = codec
        return self._guard(self._compress.submit, field, xi, base=base,
                           edit_value_dtype=edit_value_dtype,
                           entropy=entropy)

    def submit_decompress(self, art: pipeline.CompressedArtifact) -> Future:
        """Queue an artifact; the Future resolves to the decompressed
        field g with MSS(g) == MSS(f)."""
        return self._guard(self._decompress.submit, art)

    # -- sync conveniences --------------------------------------------
    def compress(self, field: np.ndarray, xi: float, *,
                 base: str = "szlike",
                 edit_value_dtype: str = "auto",
                 entropy: str = "deflate",
                 codec: Optional[str] = None
                 ) -> pipeline.CompressedArtifact:
        """Blocking ``submit_compress(...).result()``."""
        return self.submit_compress(
            field, xi, base=base, edit_value_dtype=edit_value_dtype,
            entropy=entropy, codec=codec).result()

    def decompress(self, art: pipeline.CompressedArtifact) -> np.ndarray:
        """Blocking ``submit_decompress(...).result()``."""
        return self.submit_decompress(art).result()

    # -- observability ------------------------------------------------
    def shard_timings(self, *, refresh: bool = False
                      ) -> Optional[Dict[str, object]]:
        """Time one sharded fix iteration's interior pass, ghost
        exchange and full step on the last sharded request class
        (``distributed.shardfix.time_step_parts``, synthetic data of the
        recorded shape and dtype, seeded). The probe runs the first time
        — and again only with ``refresh`` — and is then served from its
        cache; None when no sharded dispatch has happened yet or no
        data mesh is reachable."""
        shard = self._compress.stats().get("shard") or {}
        meta = shard.get("last")
        if not meta:
            return None
        from ..distributed.shardfix import active_data_mesh, time_step_parts
        mesh = self.config.mesh
        if mesh is None:
            mesh = active_data_mesh()
        if mesh is None:
            return None
        shape = tuple(meta["shape"])
        key = (shape, meta["dtype"], tuple(mesh.axis_names),
               tuple(mesh.devices.shape))
        with self._lock:
            probe = self._shard_probe
        if probe is not None and not refresh and probe[0] == key:
            return probe[1]
        from ..core import field_topology
        from ..device import _h2d, resolve_device
        rng = np.random.default_rng(0)
        f = _h2d(rng.normal(size=shape).astype(meta["dtype"]),
                 resolve_device(self.config.device))
        timings = time_step_parts(f, field_topology(f, 0.1), mesh)
        doc = dict(shape=list(shape), dtype=meta["dtype"], **timings)
        with self._lock:
            self._shard_probe = (key, doc)
        return doc

    def stats(self) -> Dict[str, object]:
        """The service stats document (what the HTTP endpoint serves):
        uptime plus one ``repro_torch.compress.stream`` counter snapshot
        per direction — fields/sec, batch occupancy, in-flight depth,
        transfer bytes, spec-cache hit/miss/eviction counts and the
        straggler policy's live coalescing scale, and the per-mesh-axis
        halo bytes of sharded dispatches. ``shard_timings`` carries the
        cached probe when one has run (``shard_timings()`` triggers
        it)."""
        return dict(
            uptime_s=time.perf_counter() - self._t_start,
            config=dict(window=self.config.window,
                        max_batch=self.config.max_batch,
                        coalesce_ms=self.config.coalesce_ms,
                        overload=self.config.overload),
            compress=self._compress.stats(),
            decompress=self._decompress.stats(),
            shard_timings=self._shard_timings_snapshot(),
        )

    def _shard_timings_snapshot(self) -> Optional[Dict[str, object]]:
        with self._lock:
            return self._shard_probe[1] if self._shard_probe else None

    # -- lifecycle ----------------------------------------------------
    def flush(self) -> None:
        """Block until every in-flight request (both directions) has
        completed or failed."""
        self._compress.flush()
        self._decompress.flush()

    def close(self) -> None:
        """Drain in-flight work and stop both streams (idempotent)."""
        self._compress.close()
        self._decompress.close()

    def __enter__(self) -> "CompressionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_stats_server(service: CompressionService, port: int = 0,
                       host: str = "127.0.0.1"):
    """Serve ``service.stats()`` as JSON over plain HTTP on a daemon
    thread: ``GET /stats`` returns the live stats document,
    ``GET /healthz`` returns ``ok``. Returns the running
    ``ThreadingHTTPServer`` (``.server_address`` carries the bound port
    when ``port=0``); call ``.shutdown()`` to stop it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):              # noqa: N802 (http.server API)
            if self.path == "/healthz":
                body, ctype = b"ok\n", "text/plain"
            elif self.path.split("?")[0] in ("/", "/stats"):
                body = (json.dumps(service.stats(), indent=2) + "\n").encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path (try /stats)")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: stats polls are chatty
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="compression-stats-http")
    thread.start()
    return server
