"""Streaming topology-preserving compression, the port of
``repro.compress.stream``.

The one-shot pipeline serves one call at a time: the caller pays the
device stage (transform, fix loop, edit extraction) and the host
entropy coding one after the other, and the card idles while zlib and
the MSE1 edit encode run. Timestep series and ensemble members arrive
continuously, so this module overlaps the two:

* ``CompressStream`` / ``DecompressStream`` — double-buffered schedulers
  over a bounded window of in-flight fields. A scheduler thread owns the
  DEVICE stage (one coalesced batch at a time,
  ``pipeline._device_batch_stage`` or ``_device_pipelined_stage``); host
  entropy coding of batch *k* runs on worker threads while the scheduler
  runs batch *k+1*'s device stage. The device stage ends with the d2h of
  the codes and of the edits on the scheduler thread, so a worker's
  entropy coding reads host arrays only and waits on no kernel queued
  for the next batch (every thread queues on the same CUDA stream).
* **dynamic batching** — same-spec requests (shape, dtype, base codec,
  edit dtype, entropy codec; ``xi`` is free per request) queued at
  dispatch time coalesce into one batch, padded to a power-of-two member
  count as the reference pads it (``pad_pow2``; the port compiles
  nothing per batch size, so a padding member only costs its transform,
  and in a fused batch its fix loop). Mixed-spec traffic batches
  separately; ``strict_uniform=True`` rejects it at submit instead.
  Whether a batch's fix loops run fused (``fixes.fused_fix_batch``) or
  pipelined (a solo loop a member) is decided by a measured voxel
  threshold (``compress.calibrate``); the decision taken per batch is in
  ``stats()['fix_modes']``.
* **backpressure** — ``window`` bounds in-flight requests; ``submit``
  blocks (or raises ``StreamBackpressure`` with ``block=False``) until a
  slot frees, so memory stays O(window x field).
* ``SpecCache`` — an LRU of dispatch specializations keyed by
  ``(shape, dtype, xi, backend)`` plus the mesh's data-axis widths when
  a mesh is given; values hold the resolved, mesh-bound stencil backend.
  Hits, misses and evictions feed the service stats.

Every artifact (and decompressed field) is byte-identical to its
one-shot ``compress_preserving_mss`` / ``decompress_preserving_mss``
counterpart: the stream reorders and overlaps work, never changes it.
With ``mesh=`` a batch's members run one after another through the
sharded fix loop (no batch padding: it would only add work), and
``stats()["shard"]`` adds up the per-axis halo bytes (``halo_plan`` x
each member's iterations).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..core import fixes
from ..core.backend import BackendLike, resolve_backend
from ..debug import sanitize_transfers
from ..device import DeviceLike, resolve_device, torch_dtype
from ..distributed.shardfix import ALL_DATA_AXES
from ..distributed.straggler import StepWatchdog
from . import calibrate, pipeline, szlike


class StreamBackpressure(RuntimeError):
    """Raised by a non-blocking ``submit`` when the in-flight window is
    full (the stream's bounded-memory contract; block=True waits
    instead)."""


class StreamClosed(RuntimeError):
    """Raised by ``submit`` after ``close()`` — a closed stream drains
    its in-flight work but accepts no new requests."""


# ---------------------------------------------------------------------------
# specialization cache
# ---------------------------------------------------------------------------

class SpecCache:
    """LRU cache of dispatch specializations, keyed by
    ``(shape, dtype, xi, backend)``.

    The cached value is the resolved stencil backend for that request
    class: one instance per spec, and an observable cache surface
    (``hits`` / ``misses`` / ``evictions`` feed the service stats
    endpoint). Thread-safe.

    Note the xi component: the cached backend itself is xi-independent,
    so traffic that varies xi per request creates one (cheap-to-rebuild)
    entry per distinct bound — the key deliberately identifies the full
    request class the stats observe, trading some LRU churn under
    many-bound traffic for a cache population that mirrors the workload.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        # guarded-by: self._lock
        self._data: "collections.OrderedDict[Hashable, object]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0                        # guarded-by: self._lock
        self.misses = 0                      # guarded-by: self._lock
        self.evictions = 0                   # guarded-by: self._lock

    def get(self, key: Hashable, build: Callable[[], object]) -> object:
        """The cached value for ``key``, building (and possibly evicting
        the least-recently-used entry) on a miss.

        Concurrent misses of one key both ``build()`` (the lock is
        released around the build), but exactly ONE winner's instance is
        kept and returned to every racer. The losing thread's call is
        reclassified as a hit (it returns the cached winner)."""
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
        value = build()          # outside the lock
        with self._lock:
            if key in self._data:        # lost a build race: keep the winner
                self.hits += 1
                self.misses -= 1
                self._data.move_to_end(key)
                return self._data[key]
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> Dict[str, int]:
        """Counter snapshot: hits, misses, evictions, size, maxsize."""
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        evictions=self.evictions, size=len(self._data),
                        maxsize=self.maxsize)


@dataclasses.dataclass
class _Request:
    """One queued stream request: the payload, its coalescing spec, and
    the Future the caller holds."""
    item: object
    spec: Tuple
    xi: float
    future: Future
    t_submit: float


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class _StreamBase:
    """Shared scheduler machinery of ``CompressStream`` and
    ``DecompressStream``: the bounded window, the coalescing queue, the
    worker pool, and the stats. Subclasses implement ``_dispatch`` (one
    coalesced same-spec batch) and ``_spec_of`` (the coalescing key)."""

    def __init__(self, *, window: int = 8, max_batch: int = 4,
                 linger_ms: float = 2.0,
                 backend: BackendLike = "auto", mesh=None,
                 device_path="auto",
                 max_iters: int = 512,
                 workers: Optional[int] = None,
                 strict_uniform: bool = False,
                 pad_pow2: bool = True,
                 fix_batching: str = "auto",
                 fused_fix_voxels: Optional[int] = None,
                 cache_size: int = 32,
                 device: DeviceLike = None,
                 start: bool = True):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if fix_batching not in ("auto", "fused", "pipelined"):
            raise ValueError(
                'fix_batching must be "auto", "fused", or "pipelined"; '
                f"got {fix_batching!r}")
        self.window = window
        self.max_batch = max_batch
        self.linger_s = max(linger_ms, 0.0) / 1e3
        self._backend = backend
        self._mesh = mesh
        self._device = resolve_device(device)
        self._device_path = device_path
        self._max_iters = max_iters
        self._strict = strict_uniform
        self._pad_pow2 = pad_pow2
        self._fix_batching = fix_batching
        # None => derive the fused-vs-pipelined threshold from the
        # one-shot machine calibration (compress.calibrate) on first use
        self._fused_fix_voxels = fused_fix_voxels
        self._fix_mode_counts: Dict[str, int] = {}
        self._codec_stats: Dict[str, List[int]] = {}   # name -> [count, bytes]
        self.cache = SpecCache(cache_size)

        # straggler policy: a batch whose device time blows past the
        # watchdog's EWMA deadline widens the coalescing window (x2 per
        # flag, capped) instead of stalling the service; healthy batches
        # decay the scale back toward 1
        self._watchdog = StepWatchdog()
        self._linger_scale = 1.0
        self._linger_scale_max = 8.0
        self._watchdog_verdicts: Dict[str, int] = {}

        # sharded-dispatch accounting: per-mesh-axis halo bytes moved by
        # the fix loops (analytic halo_plan x observed iteration counts)
        self._halo_bytes: Dict[str, int] = {}    # guarded-by: self._lock
        self._halo_iters = 0                     # guarded-by: self._lock
        # guarded-by: self._lock
        self._shard_meta: Optional[Dict[str, object]] = None

        self._slots = threading.Semaphore(window)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)   # scheduler wake-ups
        self._done = threading.Condition(self._lock)   # flush() wake-ups
        # guarded-by: self._lock
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._closed = False                 # guarded-by: self._lock
        self._spec0: Optional[Tuple] = None  # guarded-by: self._lock

        # stats counters, each # guarded-by: self._lock (mszlint verifies
        # every write below sits inside the critical section)
        self._submitted = 0                  # guarded-by: self._lock
        self._completed = 0                  # guarded-by: self._lock
        self._failed = 0                     # guarded-by: self._lock
        self._in_flight = 0                  # guarded-by: self._lock
        self._max_in_flight = 0              # guarded-by: self._lock
        self._batches = 0                    # guarded-by: self._lock
        self._members_real = 0               # guarded-by: self._lock
        self._members_padded = 0             # guarded-by: self._lock
        self._nbytes_h2d = 0                 # guarded-by: self._lock
        self._nbytes_d2h = 0                 # guarded-by: self._lock
        self._t_device = 0.0                 # guarded-by: self._lock
        self._t_encode = 0.0                 # guarded-by: self._lock
        # guarded-by: self._lock
        self._t_first_submit: Optional[float] = None
        # guarded-by: self._lock
        self._t_last_done: Optional[float] = None

        self._pool = ThreadPoolExecutor(
            max_workers=workers or max(2, min(8, max_batch)),
            thread_name_prefix=type(self).__name__ + "-worker")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=type(self).__name__)
        self._started = False
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        """Start the scheduler thread (idempotent; ``start=False``
        constructors queue requests without draining until called)."""
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        """Drain every in-flight request, then stop the scheduler and
        worker pool — no Future is ever abandoned (a never-started
        stream is started so its queue drains too). Safe to call twice;
        submits afterwards raise ``StreamClosed``."""
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        self.start()        # a start=False stream still owes its queue
        self._thread.join()
        self._pool.shutdown(wait=True)
        with self._lock:
            self._t_last_done = self._t_last_done or time.perf_counter()

    def __enter__(self) -> "_StreamBase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ---------------------------------------------------
    def _submit(self, item, xi: float, spec: Tuple, *, block: bool = True,
                timeout: Optional[float] = None) -> Future:
        if self._closed:
            raise StreamClosed("stream is closed")
        if self._strict:
            with self._lock:
                if self._spec0 is None:
                    self._spec0 = spec
                elif spec != self._spec0:
                    raise ValueError(
                        f"strict_uniform stream pinned to spec {self._spec0}; "
                        f"got {spec} (submit to a second stream, or drop "
                        "strict_uniform to batch mixed specs separately)")
        if block:
            ok = self._slots.acquire() if timeout is None \
                else self._slots.acquire(timeout=timeout)
        else:
            ok = self._slots.acquire(blocking=False)
        if not ok:
            raise StreamBackpressure(
                f"in-flight window full ({self.window} requests); "
                "block=True waits for a slot instead")
        fut: Future = Future()
        req = _Request(item=item, spec=spec, xi=xi, future=fut,
                       t_submit=time.perf_counter())
        with self._lock:
            if self._closed:           # closed while we held the slot
                self._slots.release()
                raise StreamClosed("stream is closed")
            self._submitted += 1
            self._in_flight += 1
            self._max_in_flight = max(self._max_in_flight, self._in_flight)
            if self._t_first_submit is None:
                self._t_first_submit = req.t_submit
            self._pending.append(req)
            self._wake.notify()
        return fut

    def flush(self) -> None:
        """Block until every submitted request has completed or failed."""
        with self._lock:
            while self._in_flight > 0:
                self._done.wait()

    # -- completion bookkeeping --------------------------------------
    def _finish(self, req: _Request, result=None, exc=None) -> None:
        # counters first (a caller woken by set_result must see them
        # settled), then the result, then the flush()/slot wake-ups —
        # so fut.done() holds by the time flush() returns
        with self._lock:
            if exc is not None:
                self._failed += 1
            else:
                self._completed += 1
            self._in_flight -= 1
            self._t_last_done = time.perf_counter()
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
        except Exception:       # cancelled under our feet: belt-and-braces
            pass
        with self._lock:
            self._done.notify_all()
        self._slots.release()

    def _begin(self, req: _Request) -> bool:
        """Transition a popped request's Future to RUNNING. False when
        the caller already cancelled it — the request is dropped with
        its slot freed, and the Future can no longer be cancelled once
        its batch dispatches (so result delivery cannot race a
        cancellation)."""
        if req.future.set_running_or_notify_cancel():
            return True
        with self._lock:
            self._failed += 1
            self._in_flight -= 1
            self._t_last_done = time.perf_counter()
            self._done.notify_all()
        self._slots.release()
        return False

    def _fail_batch(self, batch: List[_Request], exc: BaseException) -> None:
        for req in batch:
            self._finish(req, exc=exc)

    # -- the scheduler loop -------------------------------------------
    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            batch = [req for req in batch if self._begin(req)]
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except BaseException as exc:            # noqa: BLE001
                self._fail_batch(batch, exc)

    def _take_batch(self) -> Optional[List[_Request]]:
        """Pop the next coalesced same-spec batch (up to ``max_batch``
        members), lingering ``linger_ms`` for stragglers when the queue
        drains below a full batch. None = closed and fully drained."""
        with self._lock:
            while not self._pending and not self._closed:
                self._wake.wait()
            if not self._pending:
                return None
            spec = self._pending[0].spec
            batch = self._pop_spec_locked(spec)
            deadline = time.perf_counter() + self.linger_s * self._linger_scale
            while (len(batch) < self.max_batch and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._wake.wait(timeout=remaining):
                    break
                batch.extend(self._pop_spec_locked(
                    spec, self.max_batch - len(batch)))
            return batch

    def _pop_spec_locked(self, spec: Tuple,  # guarded-by: self._lock
                         limit: Optional[int] = None) -> List[_Request]:
        limit = self.max_batch if limit is None else limit
        taken: List[_Request] = []
        rest: List[_Request] = []
        for req in self._pending:
            if req.spec == spec and len(taken) < limit:
                taken.append(req)
            else:
                rest.append(req)
        self._pending = collections.deque(rest)
        return taken

    # -- stats --------------------------------------------------------
    def _note_batch(self, real: int, padded: int, nbytes_h2d: int,
                    nbytes_d2h: int, t_device: float) -> None:
        with self._lock:
            self._batches += 1
            self._members_real += real
            self._members_padded += padded
            self._nbytes_h2d += nbytes_h2d
            self._nbytes_d2h += nbytes_d2h
            self._t_device += t_device
            if t_device > 0.0:
                verdict = self._watchdog.observe(t_device)
                self._watchdog_verdicts[verdict] = \
                    self._watchdog_verdicts.get(verdict, 0) + 1
                if verdict == "ok":
                    self._linger_scale = max(1.0, self._linger_scale * 0.5)
                else:       # 'slow' / 'rebalance': widen, don't stall
                    self._linger_scale = min(self._linger_scale_max,
                                             self._linger_scale * 2.0)

    def _note_shard(self, be, shape, dtype, iters: int) -> None:
        """Record one sharded dispatch: ``iters`` fix iterations of the
        backend's per-axis halo traffic (``be.halo_plan``) into the
        byte counters the service stats surface."""
        try:
            plan = be.halo_plan(tuple(shape), dtype)
        except Exception:       # noqa: BLE001 — stats must never fail a batch
            return
        with self._lock:
            self._halo_iters += int(iters)
            for ax, nbytes in plan.items():
                self._halo_bytes[ax] = \
                    self._halo_bytes.get(ax, 0) + int(nbytes) * int(iters)
            self._shard_meta = dict(shape=tuple(int(s) for s in shape),
                                    dtype=str(np.dtype(dtype)),
                                    backend=getattr(be, "name", "sharded"))

    def _note_fix_mode(self, mode: str) -> None:
        """Record which fix-loop strategy one dispatched batch took
        ("fused" / "pipelined" / "host") — surfaced per-mode in
        ``stats()['fix_modes']`` so the service /stats endpoint exposes
        the calibrated policy's actual decisions, not just its
        threshold."""
        with self._lock:
            self._fix_mode_counts[mode] = self._fix_mode_counts.get(mode, 0) + 1

    def _note_codec(self, name: str, nbytes: int) -> None:
        """Record one member's entropy codec and base-payload size —
        surfaced per-codec in ``stats()['entropy_codecs']`` so mixed
        deflate / device-pack traffic stays attributable."""
        with self._lock:
            ent = self._codec_stats.setdefault(name, [0, 0])
            ent[0] += 1
            ent[1] += nbytes

    def stats(self) -> Dict[str, object]:
        """Live counter snapshot — the service stats endpoint surfaces
        this dict as JSON. ``fields_per_sec`` covers first submit to last
        completion; ``batch_occupancy`` is real members / dispatched
        member slots (padding included in the denominator)."""
        with self._lock:
            elapsed = None
            if self._t_first_submit is not None:
                end = self._t_last_done if self._in_flight == 0 and \
                    self._t_last_done else time.perf_counter()
                elapsed = max(end - self._t_first_submit, 1e-9)
            dispatched = self._members_real + self._members_padded
            return dict(
                submitted=self._submitted,
                completed=self._completed,
                failed=self._failed,
                in_flight=self._in_flight,
                max_in_flight=self._max_in_flight,
                window=self.window,
                batches=self._batches,
                max_batch=self.max_batch,
                mean_batch=(self._members_real / self._batches
                            if self._batches else 0.0),
                batch_occupancy=(self._members_real / dispatched
                                 if dispatched else 0.0),
                padded_members=self._members_padded,
                nbytes_h2d=self._nbytes_h2d,
                nbytes_d2h=self._nbytes_d2h,
                t_device_s=self._t_device,
                t_encode_s=self._t_encode,
                fields_per_sec=(self._completed / elapsed
                                if elapsed and self._completed else 0.0),
                fix_modes=dict(self._fix_mode_counts),
                entropy_codecs={k: dict(count=v[0], bytes=v[1])
                                for k, v in self._codec_stats.items()},
                fused_fix_voxels=self._fused_fix_voxels,
                cache=self.cache.stats(),
                straggler=dict(
                    linger_scale=self._linger_scale,
                    steps=self._watchdog.steps,
                    flagged_steps=self._watchdog.flagged_steps,
                    verdicts=dict(self._watchdog_verdicts),
                ),
                shard=dict(
                    halo_bytes_by_axis=dict(self._halo_bytes),
                    halo_bytes_total=sum(self._halo_bytes.values()),
                    fix_iters=self._halo_iters,
                    last=dict(self._shard_meta) if self._shard_meta else None,
                ),
            )

    # -- subclass hooks -----------------------------------------------
    def _dispatch(self, batch: List[_Request]) -> None:
        raise NotImplementedError

    def _backend_key_part(self) -> Tuple:
        name = self._backend if isinstance(self._backend, str) \
            else getattr(self._backend, "name", str(self._backend))
        if self._mesh is None:
            return (name, ())
        # the per-axis (name, size) layout, not just a block count: a
        # (2, 2) block mesh and a 4-block slab chain run different
        # decompositions and take different SpecCache slots
        data_axes = tuple((ax, int(n)) for ax, n in self._mesh.shape.items()
                          if ax in ALL_DATA_AXES)
        return (name, data_axes)

    def _resolved_backend(self, shape: Tuple[int, ...], dtype, xi: float):
        """The mesh-bound stencil backend for one request class, through
        the LRU ``SpecCache`` (key: shape, dtype, xi, backend, mesh)."""
        key = (tuple(shape), str(dtype), float(xi), *self._backend_key_part())
        return self.cache.get(key, lambda: fixes._bind(resolve_backend(
            self._backend, tuple(shape), torch_dtype(dtype), self._device,
            mesh=self._mesh)))


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------

class CompressStream(_StreamBase):
    """Double-buffered streaming ``compress_preserving_mss``.

    ``submit(field, xi)`` returns a ``concurrent.futures.Future`` that
    resolves to the ``CompressedArtifact`` — byte-identical to the
    one-shot call. Same-(shape, dtype, base, entropy) requests coalesce
    into one batched device dispatch (per-request ``xi`` rides along);
    a deflate batch's entropy coding runs on worker threads while the
    scheduler dispatches the next batch, while a device-pack batch
    finishes inline on the scheduler thread — its entropy stream was
    built on the device, so no worker-pool entropy work exists. zfplike
    (and any batch off the device path) runs as one host-path batch on a
    worker. ``map(fields, xis)`` is the ordered convenience wrapper.
    See ``_StreamBase`` for window/backpressure/batching knobs.
    """

    def submit(self, field: np.ndarray, xi: float, *,
               base: str = "szlike",
               edit_value_dtype: str = "auto",
               entropy: str = "deflate",
               block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Queue one field for compression; the Future resolves to its
        ``CompressedArtifact``. ``entropy`` picks the residual byte
        codec ("deflate" | "device-pack") and is part of
        the coalescing spec: device-pack batches finish entirely on the
        scheduler thread with zero worker-pool entropy work. Raises
        ``StreamBackpressure`` when ``block=False`` and the in-flight
        window is full."""
        field = np.asarray(field)
        pipeline._check_base_entropy(base, entropy)
        spec = (field.shape, str(field.dtype), base, edit_value_dtype,
                entropy)
        return self._submit(field, float(xi), spec, block=block,
                            timeout=timeout)

    def map(self, fields: Sequence[np.ndarray],
            xi) -> List[pipeline.CompressedArtifact]:
        """Compress ``fields`` through the stream; artifacts return in
        submission order regardless of completion order. ``xi``: scalar
        or per-field sequence."""
        fields = list(fields)
        xi_arr = np.broadcast_to(np.asarray(xi, np.float64), (len(fields),))
        futs = [self.submit(f, float(x)) for f, x in zip(fields, xi_arr)]
        return [f.result() for f in futs]

    def _dispatch(self, batch: List[_Request]) -> None:
        spec = batch[0].spec
        _, _, base, evd, entropy = spec
        fields = [req.item for req in batch]
        xi_arr = np.asarray([req.xi for req in batch], np.float64)

        steps: List[float] = []
        use_dev = False
        if self._device_path is True and base != "szlike":
            self._fail_batch(batch, ValueError(
                f"device_path=True but the device path serves the szlike "
                f"base only (got {base!r})"))
            return
        if self._device_path is not False and base == "szlike":
            reasons = [pipeline._device_path_reason(f, float(x), base)
                       for f, x in zip(fields, xi_arr)]
            use_dev = all(r is None for r, _ in reasons)
            steps = [s for _, s in reasons]
            if self._device_path is True and not use_dev:
                bad = next(r for r, _ in reasons if r is not None)
                self._fail_batch(batch, ValueError(
                    f"device_path=True but {bad}"))
                return
        if not use_dev:
            # host byte-codec path (zfplike base, unsupported dtype, range
            # precondition failures, ...): one whole-batch worker job so
            # the scheduler stays free for the next batch's device stage
            self._note_fix_mode("host")
            self._pool.submit(self._host_batch, batch, fields, xi_arr,
                              base, evd, entropy)
            return

        be = self._resolved_backend(fields[0].shape, fields[0].dtype,
                                    float(xi_arr[0]))
        # pad the batch to a power-of-two member count, as the reference
        # does (its jit specializes on batch sizes; here a padding member
        # just costs its transform, and in a fused batch its fix loop).
        # The sharded loop runs members one after another: padding would
        # only add work there
        B = len(fields)
        cap = _pow2_at_least(B) if (
            self._pad_pow2 and not hasattr(be, "fix_loop")) else B
        pad = cap - B
        if pad:
            fields = fields + [fields[-1]] * pad
            xi_arr = np.concatenate([xi_arr, np.full(pad, xi_arr[-1])])
            steps = steps + [steps[-1]] * pad
        t0 = time.perf_counter()
        # under MSZ_SANITIZERS the whole device stage runs inside the
        # transfer guard: an unaudited host<->device crossing fails the
        # batch loudly (debug.guards)
        with sanitize_transfers():
            if self._use_fused_fix(fields[0], be):
                self._note_fix_mode("fused")
                db = pipeline._device_batch_stage(fields, xi_arr, be,
                                                  self._max_iters, steps,
                                                  self._device,
                                                  entropy=entropy)
            else:
                self._note_fix_mode("pipelined")
                db = pipeline._device_pipelined_stage(fields, xi_arr, be,
                                                      self._max_iters, steps,
                                                      self._device,
                                                      n_real=B,
                                                      entropy=entropy)
        self._note_batch(B, pad, db.nbytes_h2d, db.nbytes_d2h,
                         time.perf_counter() - t0)
        if hasattr(be, "halo_plan"):
            self._note_shard(be, fields[0].shape, fields[0].dtype,
                             int(np.sum(db.iters_b[:B])))
        for i, req in enumerate(batch):
            if db.packed is not None:
                # device-pack: the entropy stream already left the device
                # as framed words — member finish is pure header assembly,
                # so it runs inline and the worker pool sees no entropy
                # work at all
                self._finish_compress(db, i, evd, req)
            else:
                self._pool.submit(self._finish_compress, db, i, evd, req)

    def _use_fused_fix(self, field: np.ndarray, be) -> bool:
        """Whether this batch's fix loops run as ONE batched loop
        (``_device_batch_stage``) or as per-member solo loops behind a
        shared transform (``_device_pipelined_stage``). "auto" fuses
        members up to ``fused_fix_voxels`` voxels; when the constructor
        leaves it ``None``, the first auto decision runs the one-shot
        machine calibration (``compress.calibrate``, cached per
        backend/dtype/device type, ``MSZ_FUSED_FIX_VOXELS``
        overrides). A sharded backend always takes the batch stage: its
        fix loops run members one after another either way."""
        if hasattr(be, "fix_loop"):
            return True
        if self._fix_batching != "auto":
            return self._fix_batching == "fused"
        if self._fused_fix_voxels is None:
            # scheduler-thread only, so the lazy fill needs no lock;
            # stats() readers see None until the first auto decision
            self._fused_fix_voxels = calibrate.fused_fix_threshold(
                be, field.dtype, self._device).threshold_voxels
        return field.size <= self._fused_fix_voxels

    def _host_batch(self, batch: List[_Request], fields, xi_arr,
                    base: str, evd: str, entropy: str = "deflate") -> None:
        try:
            arts = pipeline.compress_preserving_mss_batch(
                fields, xi_arr, base=base, edit_value_dtype=evd,
                max_iters=self._max_iters, backend=self._backend,
                mesh=self._mesh, device_path=False, entropy=entropy,
                device=self._device)
        except BaseException as exc:                # noqa: BLE001
            self._fail_batch(batch, exc)
            return
        self._note_batch(len(batch), 0, 0, 0, 0.0)
        for req, art in zip(batch, arts):
            self._note_codec(getattr(art, "entropy", "deflate"),
                             len(art.base_payload))
            self._finish(req, result=art)

    def _finish_compress(self, db: "pipeline._DeviceBatch", i: int,
                         evd: str, req: _Request) -> None:
        t0 = time.perf_counter()
        try:
            art = pipeline._encode_batch_member(db, i, evd)
        except BaseException as exc:                # noqa: BLE001
            self._finish(req, exc=exc)
            return
        with self._lock:
            self._t_encode += time.perf_counter() - t0
        self._note_codec(getattr(art, "entropy", "deflate"),
                         len(art.base_payload))
        self._finish(req, result=art)


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------

class DecompressStream(_StreamBase):
    """Streaming ``decompress_preserving_mss``: same scheduler, artifacts
    in, fields out. Same-(base, shape, dtype) artifacts coalesce into one
    ``decompress_artifact_batch`` call — which itself pipelines threaded
    entropy decode against per-member device work — and whole batches
    run on worker threads, so batch *k+1*'s entropy decode overlaps
    batch *k*'s device work. Because those inner
    stages overlap inside one call, the read side cannot attribute them
    separately: ``stats()['t_device_s']`` carries the combined batch
    time and ``t_encode_s`` stays 0. Outputs are byte-identical to
    one-shot calls."""

    def submit(self, art: pipeline.CompressedArtifact, *,
               block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Queue one artifact; the Future resolves to the decompressed
        field g (``np.ndarray``)."""
        spec = (art.base, tuple(art.shape), str(art.dtype))
        return self._submit(art, float(art.xi), spec, block=block,
                            timeout=timeout)

    def map(self, arts: Sequence[pipeline.CompressedArtifact]
            ) -> List[np.ndarray]:
        """Decompress ``arts`` through the stream, results in submission
        order."""
        futs = [self.submit(a) for a in arts]
        return [f.result() for f in futs]

    def _dispatch(self, batch: List[_Request]) -> None:
        if self._device_path is not False and all(
                self._art_codec(req.item) == "device-pack" and
                getattr(req.item, "path", "host") == "device"
                for req in batch):
            # device-pack device-path batch: residual decode is a device
            # unpack, so there is no host entropy work to overlap — run
            # inline rather than paying a worker-pool hop. Under
            # MSZ_SANITIZERS the decode also runs inside the transfer
            # guard.
            with sanitize_transfers():
                self._decode_batch(batch)
        else:
            self._pool.submit(self._decode_batch, batch)

    @staticmethod
    def _art_codec(art: pipeline.CompressedArtifact) -> str:
        """The artifact's residual entropy codec, trusting the payload
        magic over the (v3+) artifact field when the base is szlike."""
        if art.base == "szlike":
            try:
                return szlike.sz_blob_entropy(art.base_payload)
            except ValueError:
                pass
        return getattr(art, "entropy", "deflate")

    def _decode_batch(self, batch: List[_Request]) -> None:
        arts = [req.item for req in batch]
        t0 = time.perf_counter()
        try:
            if len(arts) == 1:
                # skip the batch machinery (pooled entropy decode, stacked
                # d2h) for singleton batches — output is identical
                gs = [pipeline.decompress_preserving_mss(
                    arts[0], device_path=self._device_path,
                    backend=self._backend, mesh=self._mesh,
                    device=self._device)]
            else:
                gs = pipeline.decompress_artifact_batch(
                    arts, device_path=self._device_path,
                    backend=self._backend, mesh=self._mesh,
                    device=self._device)
        except BaseException as exc:                # noqa: BLE001
            self._fail_batch(batch, exc)
            return
        nbytes = sum(g.nbytes for g in gs)
        self._note_batch(len(batch), 0,
                         sum(len(a.base_payload) + len(a.edit_payload)
                             for a in arts),
                         nbytes, time.perf_counter() - t0)
        for a in arts:
            self._note_codec(self._art_codec(a), len(a.base_payload))
        for req, g in zip(batch, gs):
            self._finish(req, result=g)


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (0 stays 0): the batch-axis padding."""
    return 1 << max(n - 1, 0).bit_length() if n else 0
