"""Streaming inference engine for compiled SVM fleets.

The port of ``repro.serving.svm_engine``.  The compiled predict path is
batch-synchronous: one caller, one batch, one dispatch.  A deployed fleet
instead sees a continuous stream of small queries from many tenants; this
engine turns that stream back into efficient device batches.  Everything
but the device side runs on the host and is the reference's:

* **Micro-batching** — requests accumulate in per-priority-class queues
  under a max-wait / max-batch policy: a batch dispatches as soon as it is
  full or the oldest selected request has waited ``max_wait_ms``.
* **Continuous batching with deadlines and priorities** — ``submit`` takes
  ``deadline_ms=`` and ``priority=`` (higher = more important).  The batch
  former serves priority classes in order, earliest deadline first within
  a class, and backfills across classes: a request whose deadline falls
  inside the expiry horizon joins the next batch in EDF order whatever its
  class.  Non-expiring low-priority work never displaces higher-priority
  work.
* **Admission control at saturation** — with ``queue_bound`` the pending
  row count is bounded: on overflow the engine sheds already-expired
  queued work, then queued work of strictly lower priority (latest
  deadline first), else the incoming request.  Shed futures raise
  :class:`ShedError` (``reason`` ``"expired"`` or ``"overflow"``).  With
  ``shed_expired=True`` the batch former also drops queued requests whose
  deadline passed.  ``engine.backpressure`` is a high/low-watermark signal
  for open-loop producers.
* **Padding buckets** — every dispatch is padded to a power-of-two height
  (:class:`BucketPolicy`); padded rows carry zeros and model 0, and their
  labels are computed and discarded.
* **Mesh-sharded dispatch** — every dispatch goes through the fleet's
  :class:`~repro_torch.api.fleet.ShardedFleetForward` over a ``launch.mesh.
  make_serving_mesh`` mesh (``mesh=``; by default the fleet's own device
  alone, the unsharded program): bucket sizes are per device, and each
  device runs the fleet's labels on its whole slice.
* **Co-batching** — one dispatch carries rows of any mix of the fleet's
  members; a bare :class:`~repro_torch.api.CompiledMachine` is wrapped
  into a one-member fleet.
* **Observability** — a :class:`ServingStats` accumulator with exact
  streaming totals and a fixed-size latency reservoir (flat memory), plus
  each dispatch's host time and, on a card, its device time per bucket
  (CUDA events).

The device side is the port's own.  Each bucket owns ``pipeline_depth + 1``
staging slots; a slot is a page-locked host row / model-index buffer (numpy
views of ``torch.empty(..., pin_memory=True)``), its device buffers and a
page-locked label output.  A dispatch copies the slot up with
``non_blocking`` copies on the engine's own CUDA stream (one per mesh
device), runs the fleet's labels there, copies them back into the
slot's output and records an event; resolving a batch waits on that event
alone, never on the whole device.  PyTorch has no buffer donation: the slot
rotation takes the place of the reference's donated staging.  A slot is
restaged only after its batch's event completed — with at most
``pipeline_depth`` batches in flight over ``pipeline_depth + 1`` slots this
holds by construction, and ``_dispatch`` checks it.  On the CPU the slots
are plain host tensors and a dispatch computes at once.

An error raised at dispatch or surfacing at a batch's event fails that
batch's futures with it; the engine then stops: every other pending
future fails, and ``submit`` raises.

Usage::

    from repro_torch.serving import SVMEngine, ShedError
    with SVMEngine(fleet, max_batch=256, max_wait_ms=2.0,
                   shed_expired=True, queue_bound=4096) as eng:
        eng.warmup()
        fut = eng.submit(x_row, model="balance", deadline_ms=20.0)
        try:
            label = fut.result()
        except ShedError as e:
            ...  # request shed under overload (e.reason)
        print(eng.stats.summary())
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.compiled import CompiledMachine
from repro_torch.api.fleet import FleetMachine, compile_fleet, host_buffer
from repro_torch.launch.mesh import make_serving_mesh

DEFAULT_MAX_BATCH = 256
DEFAULT_MIN_BUCKET = 8
DEFAULT_MAX_WAIT_MS = 2.0
DEFAULT_RESERVOIR = 4096


class ShedError(Exception):
    """A request was shed by admission control instead of served.

    ``reason`` is ``"expired"`` (deadline passed before dispatch) or
    ``"overflow"`` (bounded queue full and the request lost the
    priority/deadline comparison).
    """

    def __init__(self, reason: str):
        super().__init__(f"request shed ({reason})")
        self.reason = reason


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class BucketPolicy:
    """Powers-of-two padding buckets between ``min_bucket`` and ``max_batch``.

    ``bucket_for(n)`` returns the smallest bucket holding ``n`` rows; the
    bucket set is the engine's set of dispatch heights, so its size bounds
    the staging memory and the warm-up.  Under a serving mesh the buckets
    are per-device sizes; the engine multiplies by the device count.
    """

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 min_bucket: int = DEFAULT_MIN_BUCKET):
        if not (_is_pow2(max_batch) and _is_pow2(min_bucket)):
            raise ValueError(
                f"buckets must be powers of two, got min={min_bucket} "
                f"max={max_batch}")
        if min_bucket > max_batch:
            raise ValueError(f"min_bucket {min_bucket} > max_batch {max_batch}")
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        buckets, b = [], min_bucket
        while b <= max_batch:
            buckets.append(b)
            b <<= 1
        self.buckets: tuple[int, ...] = tuple(buckets)

    def bucket_for(self, n_rows: int) -> int:
        if not 0 < n_rows <= self.max_batch:
            raise ValueError(
                f"{n_rows} rows outside (0, {self.max_batch}]")
        for b in self.buckets:
            if n_rows <= b:
                return b
        raise AssertionError("unreachable")  # pragma: no cover


class ServingStats:
    """Streaming serving telemetry with flat memory under sustained load.

    Totals (request/row/batch counts, stream span, mean/max latency,
    occupancy, shed counts, per-bucket dispatch times) are exact streaming
    accumulators; latency and queue-wait percentiles come from a fixed-size
    reservoir sample (Algorithm R over per-request latencies).  Timestamps
    are ``time.perf_counter`` seconds stamped by the engine: ``t_enqueue``
    at ``submit``, ``t_dispatch`` at the launch, ``t_complete`` when the
    future resolves.  Queries are counted in rows (a k-row request is k
    queries).
    """

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR, seed: int = 0):
        self._lock = threading.Lock()
        self._capacity = int(reservoir)
        self._seed = int(seed)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._rng = np.random.RandomState(self._seed)
            self._n_req = 0
            self._n_rows = 0
            self._n_batches = 0
            self._sum_occupancy = 0.0
            self._t_first = math.inf
            self._t_last = -math.inf
            self._sum_lat = 0.0
            self._max_lat = 0.0
            self._sum_wait = 0.0
            self._n_deadline = 0          # requests that carried a deadline
            self._n_deadline_met = 0
            self._n_shed = 0
            self._shed_rows = 0
            self._shed_reasons: dict[str, int] = {}
            # bucket -> [dispatches, Σ host ms, timed dispatches, Σ device ms]
            self._dispatch: dict[int, list] = {}
            # Fixed-size reservoirs: (latency_ms, wait_ms) per request.
            self._res = np.zeros((self._capacity, 2), np.float64)
            self._res_n = 0               # requests seen by the reservoir

    # -- ingestion -----------------------------------------------------------

    def observe_batch(self, rows: int, bucket: int, requests,
                      host_ms: Optional[float] = None,
                      device_ms: Optional[float] = None) -> None:
        with self._lock:
            self._n_batches += 1
            self._sum_occupancy += rows / bucket
            if host_ms is not None:
                acc = self._dispatch.setdefault(bucket, [0, 0.0, 0, 0.0])
                acc[0] += 1
                acc[1] += host_ms
                if device_ms is not None:
                    acc[2] += 1
                    acc[3] += device_ms
            for r in requests:
                lat_ms = (r.t_complete - r.t_enqueue) * 1e3
                wait_ms = (r.t_dispatch - r.t_enqueue) * 1e3
                self._n_req += 1
                self._n_rows += r.n_rows
                self._t_first = min(self._t_first, r.t_enqueue)
                self._t_last = max(self._t_last, r.t_complete)
                self._sum_lat += lat_ms
                self._max_lat = max(self._max_lat, lat_ms)
                self._sum_wait += wait_ms
                if r.deadline != math.inf:
                    self._n_deadline += 1
                    if r.t_complete <= r.deadline:
                        self._n_deadline_met += 1
                # Algorithm R: uniform sample over the full stream.
                if self._res_n < self._capacity:
                    self._res[self._res_n] = (lat_ms, wait_ms)
                else:
                    j = self._rng.randint(0, self._res_n + 1)
                    if j < self._capacity:
                        self._res[j] = (lat_ms, wait_ms)
                self._res_n += 1

    def observe_shed(self, request, reason: str) -> None:
        with self._lock:
            self._n_shed += 1
            self._shed_rows += request.n_rows
            self._shed_reasons[reason] = \
                self._shed_reasons.get(reason, 0) + 1

    # -- readout -------------------------------------------------------------

    @property
    def n_requests(self) -> int:
        with self._lock:
            return self._n_req

    @property
    def n_shed(self) -> int:
        with self._lock:
            return self._n_shed

    def summary(self) -> dict:
        with self._lock:
            if not self._n_req and not self._n_shed:
                return {"n_requests": 0, "n_queries": 0, "n_batches": 0}
            out = {
                "n_requests": self._n_req,
                "n_queries": self._n_rows,
                "n_batches": self._n_batches,
            }
            if self._n_shed:
                out["shed"] = {"n_requests": self._n_shed,
                               "n_queries": self._shed_rows,
                               "reasons": dict(self._shed_reasons)}
            if not self._n_req:
                return out
            span = self._t_last - self._t_first
            sample = self._res[: min(self._res_n, self._capacity)]
            lat, wait = sample[:, 0], sample[:, 1]
            out.update({
                "queries_per_s": round(self._n_rows / span, 1)
                if span > 0 else None,
                "batch_occupancy": round(
                    self._sum_occupancy / self._n_batches, 4),
                "mean_batch_rows": round(self._n_rows / self._n_batches, 2),
                "latency_ms": {
                    "p50": round(float(np.percentile(lat, 50)), 3),
                    "p95": round(float(np.percentile(lat, 95)), 3),
                    "p99": round(float(np.percentile(lat, 99)), 3),
                    "mean": round(self._sum_lat / self._n_req, 3),
                    "max": round(self._max_lat, 3),
                },
                "queue_wait_ms_p50": round(float(np.percentile(wait, 50)), 3),
                "latency_sample_n": int(min(self._res_n, self._capacity)),
            })
            if self._n_deadline:
                out["deadlines"] = {
                    "n_requests": self._n_deadline,
                    "met": self._n_deadline_met,
                    "met_rate": round(
                        self._n_deadline_met / self._n_deadline, 4),
                }
            if self._dispatch:
                out["dispatch"] = {
                    str(b): {"n": a[0], "host_ms": a[1] / a[0],
                             "device_ms": a[3] / a[2] if a[2] else None}
                    for b, a in sorted(self._dispatch.items())}
            return out


@dataclasses.dataclass
class _Request:
    x: np.ndarray            # (k, d) f32, d <= fleet.n_features
    model_idx: int
    n_rows: int
    scalar: bool             # 1-D submit -> scalar label result
    future: Future
    t_enqueue: float
    deadline: float          # absolute perf_counter s; inf = none
    priority: int            # higher = more important
    seq: int                 # submit order, FIFO tie-break
    t_dispatch: float = 0.0
    t_complete: float = 0.0

    @property
    def order(self) -> tuple:
        """Heap key inside a priority class: EDF, then FIFO."""
        return (self.deadline, self.seq)


class _Slot:
    """One staging slot of a bucket: host rows / model indices / labels
    (page-locked on a card, with numpy views for the batch former), one
    ``(x, idx)`` device buffer pair per device, and whether its batch is
    still in flight."""

    def __init__(self, rows: int, d: int, devices):
        host = devices[0]
        self.x = host_buffer((rows, d), torch.float32, host)
        self.idx = host_buffer((rows,), torch.int32, host)
        self.out = host_buffer((rows,), torch.int32, host)
        self.xv, self.iv, self.ov = (self.x.numpy(), self.idx.numpy(),
                                     self.out.numpy())
        per = rows // len(devices)
        self.dev_bufs = None
        if host.type == "cuda":
            self.dev_bufs = [
                (torch.empty((per, d), dtype=torch.float32, device=dev),
                 torch.empty((per,), dtype=torch.int32, device=dev))
                for dev in devices]
        self.in_flight = False


class SVMEngine:
    """Deadline/priority continuous-batched, bucketed, co-batched serving.

    See the module docstring for the design.  The engine owns one batcher
    thread; ``submit`` is thread-safe and non-blocking, returning a
    :class:`concurrent.futures.Future` that resolves to the request's
    label(s), or raises :class:`ShedError` if admission control shed it.
    Use as a context manager, or ``start()``/``stop()``.  The engine runs
    on its fleet's device (or its mesh's devices) and never moves work
    elsewhere.
    """

    def __init__(self, machine: Union[FleetMachine, CompiledMachine], *,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 pipeline_depth: int = 1,
                 mesh=None,
                 shed_expired: bool = False,
                 queue_bound: Optional[int] = None,
                 high_watermark: Optional[int] = None,
                 low_watermark: Optional[int] = None,
                 backfill_ms: Optional[float] = None,
                 stats: Optional[ServingStats] = None,
                 decider: Optional[str] = None):
        if isinstance(machine, CompiledMachine):
            machine = compile_fleet({"default": machine},
                                    decider=decider or machine.decider)
        elif isinstance(machine, FleetMachine) and decider is not None \
                and decider != machine.decider:
            machine = FleetMachine(machine.model_ids, machine._members,
                                   decider=decider)
        if not isinstance(machine, FleetMachine):
            raise TypeError(f"cannot serve a {type(machine).__name__}")
        self.fleet = machine
        self.policy = BucketPolicy(max_batch=max_batch, min_bucket=min_bucket)
        self.max_wait_s = float(max_wait_ms) * 1e-3
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        self.shed_expired = bool(shed_expired)
        self.queue_bound = None if queue_bound is None else int(queue_bound)
        if self.queue_bound is not None and self.queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {queue_bound}")
        if high_watermark is None:
            high_watermark = self.queue_bound
        if low_watermark is None:
            low_watermark = None if high_watermark is None \
                else max(1, high_watermark // 2)
        self.high_watermark = high_watermark
        self.low_watermark = low_watermark
        # Cross-class EDF backfill horizon: a request whose deadline falls
        # within `now + backfill` is treated as expiring and served EDF
        # regardless of priority class (default: one max-wait plus the
        # EMA batch service time, i.e. "would miss the batch after next").
        self._backfill_s = None if backfill_ms is None \
            else float(backfill_ms) * 1e-3
        self._service_ema = 0.0
        self.stats = stats if stats is not None else ServingStats()

        # Mesh-sharded forward, each device on its own stream: per-device
        # buckets scale to whole-slice global batches.  Without a mesh it
        # is the fleet's device alone, where it is the unsharded program.
        if mesh is None:
            mesh = make_serving_mesh(devices=[self.fleet.device])
        self._sharded = self.fleet.shard(mesh)
        self.n_devices = self._sharded.n_devices
        self.devices = list(self._sharded.devices)

        # pipeline_depth + 1 staging slots per bucket, used round-robin:
        # with k batches in flight the batcher stages batch t+k into the
        # slot of batch t-1, whose labels have been read.
        self._staging = {
            b: [self._make_slot(b) for _ in range(self.pipeline_depth + 1)]
            for b in self.policy.buckets
        }
        self._flip = {b: 0 for b in self.policy.buckets}

        # Per-priority-class pending queues: priority -> heap of
        # (deadline, seq, request); protected by _cond with _pending_rows.
        self._cond = threading.Condition()
        self._queues: dict[int, list] = {}
        self._pending_rows = 0
        self._seq = 0
        self._backpressure = False
        self._inflight: deque = deque()
        self._carry: Optional[_Request] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _make_slot(self, bucket: int) -> _Slot:
        return _Slot(bucket * self.n_devices, self.fleet.n_features,
                     self.devices)

    # -- lifecycle -----------------------------------------------------------

    def _order_after_banks(self) -> None:
        """The banks (and slot buffers) were written on the default
        stream: the engine's streams wait for them before their first use."""
        for dev, stream in zip(self.devices, self._sharded.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))

    def start(self) -> "SVMEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._order_after_banks()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="svm-engine-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue, resolve every future, join the batcher."""
        if self._thread is None:
            return
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "SVMEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self) -> None:
        """Dispatch every bucket once on fresh slots and wait (blocking).

        The first dispatch builds (or loads) the kernel-matrix library and
        warms the allocator, so no latency sample includes either."""
        self._order_after_banks()
        for b in self.policy.buckets:
            slot = self._make_slot(b)
            slot.xv[:] = 0.0
            slot.iv[:] = 0
            for launch in self._forward(slot):
                launch.wait()

    @property
    def n_buckets(self) -> int:
        return len(self.policy.buckets)

    @property
    def max_rows(self) -> int:
        """Largest single dispatch: max bucket x device count."""
        return self.policy.max_batch * self.n_devices

    @property
    def backpressure(self) -> bool:
        """High/low-watermark overload signal: ``True`` once pending rows
        reach ``high_watermark``, until the backlog drains below
        ``low_watermark``.  Open-loop producers should throttle on it."""
        with self._cond:
            return self._backpressure

    def _forward(self, slot: _Slot) -> list:
        """Enqueue the labels of a staged slot (asynchronous on a card):
        one launch per device, each with the event to wait on."""
        return self._sharded.enqueue(slot.x, slot.idx, slot.out,
                                     slot.dev_bufs)

    # -- request ingress -----------------------------------------------------

    def submit(self, x: np.ndarray, model: Union[str, int] = 0, *,
               deadline_ms: Optional[float] = None,
               priority: int = 0) -> Future:
        """Enqueue one request (``(d,)`` row or ``(k, d)`` mini-batch).

        The returned future resolves to a scalar ``int`` label for a 1-D
        input, else an ``(k,)`` int32 array, or raises :class:`ShedError`
        if admission control shed the request.  ``model`` is a fleet
        member id or index; ``deadline_ms`` is a relative completion
        deadline (``None`` = never expires); ``priority`` orders classes
        (higher = more important).
        """
        if self._thread is None:
            raise RuntimeError("engine not started (use `with SVMEngine(...)`)")
        if self._stop.is_set():
            raise RuntimeError("engine is stopping")
        x = np.asarray(x, np.float32)
        scalar = x.ndim == 1
        if scalar:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] > self.fleet.n_features:
            raise ValueError(
                f"expected (k, <= {self.fleet.n_features}) features, "
                f"got {x.shape}")
        if not 0 < x.shape[0] <= self.max_rows:
            raise ValueError(
                f"request rows {x.shape[0]} outside (0, {self.max_rows}]")
        now = time.perf_counter()
        deadline = math.inf if deadline_ms is None \
            else now + float(deadline_ms) * 1e-3
        req = _Request(x=x, model_idx=self.fleet.model_index(model),
                       n_rows=x.shape[0], scalar=scalar, future=Future(),
                       t_enqueue=now, deadline=deadline,
                       priority=int(priority), seq=0)
        with self._cond:
            if self._error is not None:
                raise RuntimeError("engine stopped after a failed batch") \
                    from self._error
            req.seq = self._seq
            self._seq += 1
            if self.queue_bound is not None and \
                    self._pending_rows + req.n_rows > self.queue_bound:
                self._admit_over_bound(req, now)
            else:
                self._enqueue(req)
            if self.high_watermark is not None:
                if self._pending_rows >= self.high_watermark:
                    self._backpressure = True
                elif self._pending_rows <= self.low_watermark:
                    self._backpressure = False
            self._cond.notify()
        return req.future

    def predict(self, x: np.ndarray, model: Union[str, int] = 0):
        """Synchronous convenience wrapper: ``submit(...).result()``."""
        return self.submit(x, model).result()

    def _enqueue(self, req: _Request) -> None:
        heapq.heappush(
            self._queues.setdefault(req.priority, []),
            (req.deadline, req.seq, req))
        self._pending_rows += req.n_rows

    def _shed(self, req: _Request, reason: str) -> None:
        req.future.set_exception(ShedError(reason))
        self.stats.observe_shed(req, reason)

    def _admit_over_bound(self, req: _Request, now: float) -> None:
        """Bounded-queue admission (called with the lock held): make room
        by shedding already-expired queued work, then strictly
        lower-priority queued work (latest deadline first), else shed the
        incoming request itself."""
        self._shed_expired_locked(now)
        while self._pending_rows + req.n_rows > self.queue_bound:
            victim = self._lowest_victim_locked(below=req.priority)
            if victim is None:
                self._shed(req, "overflow")
                return
            self._remove_locked(victim)
            self._shed(victim, "overflow")
        self._enqueue(req)

    def _shed_expired_locked(self, now: float) -> None:
        for prio in list(self._queues):
            q = self._queues[prio]
            while q and q[0][0] <= now:
                _, _, r = heapq.heappop(q)
                self._pending_rows -= r.n_rows
                self._shed(r, "expired")
            if not q:
                del self._queues[prio]

    def _lowest_victim_locked(self, below: int) -> Optional[_Request]:
        """Latest-deadline request of the lowest priority class < below."""
        prios = [p for p in self._queues if p < below and self._queues[p]]
        if not prios:
            return None
        q = self._queues[min(prios)]
        return max(q, key=lambda e: (e[0], e[1]))[2]

    def _remove_locked(self, req: _Request) -> None:
        q = self._queues[req.priority]
        q.remove((req.deadline, req.seq, req))
        heapq.heapify(q)
        self._pending_rows -= req.n_rows
        if not q:
            del self._queues[req.priority]

    # -- batch former (batcher thread) ---------------------------------------

    def _horizon(self, now: float) -> float:
        """Deadlines at or before this instant count as *expiring* and are
        backfilled EDF across priority classes."""
        backfill = self._backfill_s if self._backfill_s is not None \
            else self.max_wait_s + self._service_ema
        return now + backfill

    def _select_locked(self, now: float) -> Optional[_Request]:
        """Pop the next request: expiring-EDF across classes first (ties to
        the higher priority), then highest priority class, EDF within it.
        With ``shed_expired``, already-dead work is shed instead of served.
        Call with the lock held."""
        if self.shed_expired:
            self._shed_expired_locked(now)
        if not self._queues:
            return None
        horizon = self._horizon(now)
        best_prio, expiring = None, None
        for prio, q in self._queues.items():
            head = q[0]
            if head[0] <= horizon:
                # Expiring: earliest deadline wins; tie -> higher priority.
                key = (head[0], -prio, head[1])
                if expiring is None or key < expiring[0]:
                    expiring = (key, prio)
            if best_prio is None or prio > best_prio:
                best_prio = prio
        prio = expiring[1] if expiring is not None else best_prio
        q = self._queues[prio]
        _, _, req = heapq.heappop(q)
        self._pending_rows -= req.n_rows
        if not q:
            del self._queues[prio]
        if self.low_watermark is not None and \
                self._pending_rows <= self.low_watermark:
            self._backpressure = False
        return req

    def _take(self, timeout: float) -> Optional[_Request]:
        """Blocking select: wait up to ``timeout`` for a request."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while True:
                req = self._select_locked(time.perf_counter())
                if req is not None:
                    return req
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._stop.is_set():
                    return None
                self._cond.wait(remaining)

    def _take_nowait(self) -> Optional[_Request]:
        with self._cond:
            return self._select_locked(time.perf_counter())

    def _pending_empty(self) -> bool:
        with self._cond:
            return not self._queues

    def _loop(self) -> None:
        max_rows = self.max_rows
        while self._error is None:
            batch: list[_Request] = []
            rows = 0
            if self._carry is not None:
                # Carried requests lead the next batch with their ORIGINAL
                # enqueue time anchoring its max-wait deadline — a large
                # request can never starve behind a stream of small ones.
                batch.append(self._carry)
                rows = self._carry.n_rows
                self._carry = None
            if not batch:
                r = self._take(timeout=0.005)
                if r is None:
                    # Idle: complete any in-flight batch, then exit once
                    # stopped and fully drained.
                    self._resolve(all_pending=True)
                    if self._stop.is_set() and self._pending_empty() \
                            and self._carry is None:
                        return
                    continue
                batch.append(r)
                rows = r.n_rows
            wait_until = batch[0].t_enqueue + self.max_wait_s
            while rows < max_rows:
                timeout = wait_until - time.perf_counter()
                # Past the deadline we stop *waiting* but still drain the
                # immediately-available backlog — a burst that outruns the
                # batcher forms full batches instead of degrading to
                # per-request dispatch.
                r = self._take(timeout) if timeout > 0 \
                    else self._take_nowait()
                if r is None:
                    break
                if rows + r.n_rows > max_rows:
                    self._carry = r       # held for the next batch
                    break
                batch.append(r)
                rows += r.n_rows
            self._dispatch(batch, rows)

    def _dispatch(self, batch: list[_Request], rows: int) -> None:
        t0 = time.perf_counter()
        # Whole per-device slices: bucket the PER-DEVICE row count, then
        # scale back to the global batch (n_devices = 1 when unsharded).
        per_dev = -(-rows // self.n_devices)
        bucket = self.policy.bucket_for(per_dev)
        global_rows = bucket * self.n_devices
        slots = self._staging[bucket]
        slot = slots[self._flip[bucket]]
        self._flip[bucket] = (self._flip[bucket] + 1) % len(slots)
        # The slot rotation stands in for buffer donation: the slot's last
        # batch must be resolved (its event waited on) before restaging.
        if slot.in_flight:
            raise AssertionError(f"bucket {bucket}: staging slot reused "
                                 f"while its batch is in flight")
        xbuf, ibuf = slot.xv, slot.iv
        off = 0
        for r in batch:
            k, d = r.x.shape
            xbuf[off:off + k, :d] = r.x
            if d < xbuf.shape[1]:
                xbuf[off:off + k, d:] = 0.0
            ibuf[off:off + k] = r.model_idx
            off += k
        if off < global_rows:              # padded rows: zeros, model 0
            xbuf[off:] = 0.0
            ibuf[off:] = 0
        t_disp = time.perf_counter()
        for r in batch:
            r.t_dispatch = t_disp
        try:
            launches = self._forward(slot)
        except Exception as e:
            self._fail(e, batch)
            return
        slot.in_flight = True
        host_ms = (time.perf_counter() - t0) * 1e3
        self._inflight.append((launches, slot, batch, rows, bucket, t_disp,
                               host_ms))
        # Pipelining: block on the OLDEST batch only once the pipeline is
        # full, so staging batch t+k overlaps device compute of t..t+k-1.
        while len(self._inflight) > self.pipeline_depth and \
                self._error is None:
            self._resolve()

    def _resolve(self, all_pending: bool = False) -> None:
        while self._inflight:
            launches, slot, batch, rows, bucket, t_disp, host_ms = \
                self._inflight.popleft()
            try:
                for launch in launches:
                    launch.wait()          # this batch's events only
                device_ms = None
                if launches[0].start is not None:
                    device_ms = max(launch.device_ms() for launch in launches)
            except Exception as e:
                slot.in_flight = False
                self._fail(e, batch)
                return
            slot.in_flight = False
            out = slot.ov
            t_done = time.perf_counter()
            self._service_ema = 0.8 * self._service_ema + \
                0.2 * (t_done - t_disp)
            for r in batch:
                r.t_complete = t_done
            # Observed before the futures resolve, so a caller that has
            # every result also sees every batch in the stats.
            self.stats.observe_batch(rows, bucket, batch, host_ms=host_ms,
                                     device_ms=device_ms)
            off = 0
            for r in batch:
                lab = out[off:off + r.n_rows]
                off += r.n_rows
                r.future.set_result(int(lab[0]) if r.scalar else lab.copy())
            if not all_pending:
                return

    def _fail(self, exc: BaseException, batch: list[_Request]) -> None:
        """A batch failed at dispatch or at its event: its futures get the
        error, and the engine stops serving — every other in-flight or
        queued request fails too, and ``submit`` raises from now on."""
        for r in batch:
            r.future.set_exception(exc)
        stopped = RuntimeError("engine stopped after a failed batch")
        stopped.__cause__ = exc
        pending = [r for item in self._inflight for r in item[2]]
        self._inflight.clear()
        with self._cond:
            self._error = exc
            for q in self._queues.values():
                pending.extend(e[2] for e in q)
            self._queues.clear()
            self._pending_rows = 0
            if self._carry is not None:
                pending.append(self._carry)
                self._carry = None
        for r in pending:
            r.future.set_exception(stopped)
