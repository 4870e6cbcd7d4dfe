"""Dispatch engine internals for :class:`repro_torch.amq.service.FilterService`.

Port of ``repro.amq.dispatch`` (host-side Python and numpy, copied: the
port imports nothing of the JAX package); :class:`Dispatch` reads the
port's torch :class:`~repro_torch.amq.protocol.MixedReport`.

The service front door (submission API, tickets, hot swap) lives in
``service.py``; this module owns the machinery underneath (DESIGN.md §11):

* **Shape ladder** (:func:`shape_ladder` / :func:`rung_for`): a forced
  (deadline/flush/backpressure) dispatch no longer pads a 3-op tail to the
  full ``batch_size`` — it pads to the smallest ladder rung that fits.
  Rungs double from a small base up to ``batch_size``, so the set of
  dispatch shapes stays logarithmic while padding waste on short
  dispatches drops from ``batch_size - m`` to at
  most ``m``. Every rung is a multiple of the backend's ``batch_align``
  (the sharded backend's shard count — its all-to-all splits the batch
  across devices), so ladder dispatches stay legal on every backend.
* **Pending stream** (:class:`PendingStream`): the bounded admission queue
  — arrival-ordered keys/ops plus per-op enqueue timestamps and per-client
  occupancy (the fairness ledger admission control reads).
* **In-flight tracking** (:class:`Dispatch`): each dispatched batch keeps
  its report as device tensors until a ticket demands results or the
  engine's ``max_in_flight`` window slides past it; the first copy to the
  host stamps the batch's enqueue→ready latencies into the metrics.
* **SLO observability** (:class:`ServiceMetrics`): histogram-bucketed
  enqueue→dispatch and enqueue→ready latency (p50/p99 without retaining
  per-op samples), queue-depth high-water mark, padding waste,
  dispatch-size/trigger distributions, admission outcomes per client, and
  hot-swap pauses — exported by ``FilterService.stats()``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .protocol import MixedReport


class QueueFullError(RuntimeError):
    """Admission refused: the pending queue is at its configured bound.

    Raised by ``FilterService.submit`` under the ``"error"`` admission
    policy (and only then — ``"block"`` makes room by dispatching early,
    ``"shed"`` drops the submission and marks its ticket). The message
    names the bound that was hit (global ``max_pending`` or a client's
    fair share).
    """


def batch_align(handle) -> int:
    """The dispatch-width divisor ``handle`` requires (1 = unconstrained).

    Sharded backends split every batch across ``num_shards`` devices, so
    dispatch shapes must be multiples of the shard count; everything else
    accepts any width. Backends advertise the constraint via a
    ``batch_align`` property on their config (or on the handle itself, for
    cascades tracking their current level).
    """
    align = getattr(handle, "batch_align", None)
    if align is None:
        align = getattr(getattr(handle, "config", None), "batch_align", 1)
    return max(1, int(align))


def shape_ladder(batch_size: int, align: int = 1) -> Tuple[int, ...]:
    """Ascending dispatch shapes: ``align``-multiples doubling to the top.

    The base rung is the smallest multiple of ``align`` that is >= 8 (no
    point compiling 1/2/4-wide programs); each rung doubles; ``batch_size``
    is always the top rung. ``batch_size`` itself must be a multiple of
    ``align`` (validated loudly by the service constructor).

    Example::

        >>> shape_ladder(1024)
        (8, 16, 32, 64, 128, 256, 512, 1024)
        >>> shape_ladder(96, align=3)
        (12, 24, 48, 96)
    """
    if batch_size % align:
        raise ValueError(
            f"batch_size={batch_size} is not a multiple of the backend's "
            f"batch_align={align} (sharded dispatch splits the batch "
            "across that many devices)")
    base = align * max(1, math.ceil(8 / align))
    rungs: List[int] = []
    r = base
    while r < batch_size:
        rungs.append(r)
        r *= 2
    rungs.append(batch_size)
    return tuple(rungs)


def rung_for(m: int, ladder: Tuple[int, ...]) -> int:
    """The smallest ladder shape that fits ``m`` live ops."""
    for r in ladder:
        if m <= r:
            return r
    return ladder[-1]


# ---------------------------------------------------------------------------
# Latency accounting: fixed log-spaced histograms (no per-op retention).
# ---------------------------------------------------------------------------

# Bucket upper bounds in seconds: 1us .. ~68s doubling, +inf overflow.
_BUCKET_BOUNDS = tuple(1e-6 * 2.0 ** i for i in range(27)) + (float("inf"),)


class LatencyHistogram:
    """Log2-bucketed latency histogram with percentile readout.

    Observations land in doubling buckets from 1us to ~68s (overflow bucket
    above); percentiles report the bucket upper bound — a <=2x-granular,
    O(1)-memory estimate, which is the right fidelity for SLO dashboards
    (the alternative, retaining every sample, scales with traffic).
    """

    __slots__ = ("counts", "total")

    def __init__(self):
        self.counts = np.zeros((len(_BUCKET_BOUNDS),), np.int64)
        self.total = 0

    def observe(self, seconds) -> None:
        """Record one latency or an array of latencies (seconds)."""
        arr = np.atleast_1d(np.asarray(seconds, np.float64))
        if not arr.size:
            return
        idx = np.searchsorted(_BUCKET_BOUNDS, arr, side="left")
        np.add.at(self.counts, np.minimum(idx, len(_BUCKET_BOUNDS) - 1), 1)
        self.total += int(arr.size)

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket containing quantile ``q`` in [0, 1]."""
        if not self.total:
            return 0.0
        rank = q * self.total
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank, side="left"))
        idx = min(idx, len(_BUCKET_BOUNDS) - 1)
        if math.isinf(_BUCKET_BOUNDS[idx]):  # overflow bucket: report last edge
            return _BUCKET_BOUNDS[-2]
        return _BUCKET_BOUNDS[idx]

    def summary(self) -> dict:
        """JSON-able snapshot: count + p50/p90/p99 (seconds)."""
        return {"count": self.total,
                "p50_s": self.percentile(0.50),
                "p90_s": self.percentile(0.90),
                "p99_s": self.percentile(0.99)}


class ServiceMetrics:
    """The service's SLO ledger (DESIGN.md §11) — all host-side, O(1) size.

    * ``queue_wait`` — enqueue→dispatch latency histogram (time an op sat
      in the pending queue).
    * ``ready`` — enqueue→ready latency histogram (until its batch's
      results were concretised — the client-visible latency).
    * ``dispatch_sizes`` — ladder-rung → dispatch count (the shape mix).
    * ``dispatch_kinds`` — trigger → count (``full`` batch, ``deadline``,
      ``flush``, ``backpressure``).
    * ``clients`` — per-client accepted/shed op counts (the fairness
      ledger; clients are whatever hashable ids submitters pass).
    * ``swaps`` — hot-swap pause records.
    """

    def __init__(self):
        self.queue_wait = LatencyHistogram()
        self.ready = LatencyHistogram()
        self.accepted_ops = 0
        self.shed_ops = 0
        self.shed_submissions = 0
        self.dispatched_ops = 0
        self.padded_slots = 0
        self.dispatches = 0
        self.queue_depth_max = 0
        self.dispatch_sizes: Dict[int, int] = {}
        self.dispatch_kinds: Dict[str, int] = {}
        self.clients: Dict[object, Dict[str, int]] = {}
        self.swaps: List[dict] = []

    # -- observation hooks ---------------------------------------------------

    def _client(self, client) -> Dict[str, int]:
        return self.clients.setdefault(client, {"accepted": 0, "shed": 0})

    def observe_enqueue(self, n: int, client, depth: int) -> None:
        """An accepted submission: ``n`` ops now pending, queue at ``depth``."""
        self.accepted_ops += n
        self._client(client)["accepted"] += n
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def observe_shed(self, n: int, client) -> None:
        """A shed submission (``n`` ops refused under the shed policy)."""
        self.shed_ops += n
        self.shed_submissions += 1
        self._client(client)["shed"] += n

    def observe_dispatch(self, live: int, shape: int, kind: str,
                         waits: np.ndarray) -> None:
        """One batch left the queue: ``live`` real ops padded to ``shape``."""
        self.dispatches += 1
        self.dispatched_ops += live
        self.padded_slots += shape - live
        self.dispatch_sizes[shape] = self.dispatch_sizes.get(shape, 0) + 1
        self.dispatch_kinds[kind] = self.dispatch_kinds.get(kind, 0) + 1
        self.queue_wait.observe(waits)

    def observe_ready(self, latencies: np.ndarray) -> None:
        """A batch's results were concretised; per-op enqueue→ready."""
        self.ready.observe(latencies)

    def observe_swap(self, record: dict) -> None:
        """A hot swap completed (the record from ``hot_swap``)."""
        self.swaps.append(dict(record))

    # -- readout -------------------------------------------------------------

    @property
    def padding_waste(self) -> float:
        """Padded slots / dispatched slots (0.0 before any dispatch)."""
        total = self.dispatched_ops + self.padded_slots
        return self.padded_slots / total if total else 0.0

    def stats(self) -> dict:
        """JSON-able snapshot of every series (the ``BENCH_*`` payload)."""
        return {
            "accepted_ops": self.accepted_ops,
            "shed_ops": self.shed_ops,
            "shed_submissions": self.shed_submissions,
            "dispatched_ops": self.dispatched_ops,
            "dispatches": self.dispatches,
            "padded_slots": self.padded_slots,
            "padding_waste": self.padding_waste,
            "queue_depth_max": self.queue_depth_max,
            "dispatch_sizes": {str(k): v for k, v
                               in sorted(self.dispatch_sizes.items())},
            "dispatch_kinds": dict(sorted(self.dispatch_kinds.items())),
            "queue_wait": self.queue_wait.summary(),
            "ready": self.ready.summary(),
            "clients": {str(k): dict(v) for k, v in self.clients.items()},
            "swaps": [dict(s) for s in self.swaps],
        }


# ---------------------------------------------------------------------------
# In-flight dispatches.
# ---------------------------------------------------------------------------

class Dispatch:
    """One executed micro-batch: its report and the host copy of it.

    The report's tensors stay on the handle's device until first touch;
    the first touch copies them to the host (waiting for the device),
    caches the host arrays, and stamps this batch's enqueue→ready
    latencies into the metrics.
    """

    __slots__ = ("report", "_ok", "_routed", "_metrics", "_clock",
                 "_enqueued_at", "done")

    def __init__(self, report: MixedReport, metrics: ServiceMetrics,
                 clock: Callable[[], float], enqueued_at: np.ndarray):
        self.report = report
        self._ok: Optional[np.ndarray] = None
        self._routed: Optional[np.ndarray] = None
        self._metrics = metrics
        self._clock = clock
        self._enqueued_at = enqueued_at
        self.done = False

    def _observe_ready(self) -> None:
        if not self.done:
            self.done = True
            self._metrics.observe_ready(self._clock() - self._enqueued_at)
            self._enqueued_at = None  # release; latencies are binned now

    def ok(self) -> np.ndarray:
        if self._ok is None:  # first touch blocks on the device result
            self._ok = self.report.ok.cpu().numpy().astype(bool)
            self._observe_ready()
        return self._ok

    def routed(self) -> np.ndarray:
        if self._routed is None:
            self._routed = self.report.routed.cpu().numpy().astype(bool)
            self._observe_ready()
        return self._routed


# ---------------------------------------------------------------------------
# The pending (admission) queue.
# ---------------------------------------------------------------------------

class PendingStream:
    """Arrival-ordered op queue with per-client occupancy accounting.

    Submissions append (keys, ops, enqueue-time, claim) column-wise;
    ``take(m)`` pops the stream head, splitting a submission that
    straddles the boundary. Claims are (ticket, start, count) ranges, so
    bookkeeping is O(#submissions), never O(#ops). ``client_pending``
    tracks each client's share of the queue — the ledger the admission
    policies consult (DESIGN.md §11).
    """

    def __init__(self):
        self._keys: List[np.ndarray] = []      # pending key rows [m, 2]
        self._ops: List[np.ndarray] = []       # pending op codes [m]
        self._tenq: List[np.ndarray] = []      # enqueue stamps float64[m]
        self._claims: List[Tuple[object, int, int]] = []
        self._clients: List[object] = []       # claim -> client id
        self.pending = 0
        self.client_pending: Dict[object, int] = {}

    def append(self, keys: np.ndarray, ops: np.ndarray, t: float,
               ticket, client) -> None:
        """Enqueue one submission (all ops share enqueue stamp ``t``)."""
        n = keys.shape[0]
        self._keys.append(keys)
        self._ops.append(ops)
        self._tenq.append(np.full((n,), t, np.float64))
        self._claims.append((ticket, 0, n))
        self._clients.append(client)
        self.pending += n
        self.client_pending[client] = self.client_pending.get(client, 0) + n

    def oldest_enqueue(self) -> Optional[float]:
        """Enqueue stamp of the head op (None when empty)."""
        return float(self._tenq[0][0]) if self._tenq else None

    def take(self, m: int):
        """Pop the first ``m`` pending ops off the stream.

        Returns (keys[m, 2], ops[m], enqueued_at[m], claims) where claims
        are (ticket, start-pos-in-submission, count) ranges in stream
        order.
        """
        keys_out, ops_out, t_out, claims = [], [], [], []
        need = m
        while need:
            k, o, t = self._keys[0], self._ops[0], self._tenq[0]
            ticket, start, cnt = self._claims[0]
            client = self._clients[0]
            take = min(cnt, need)
            keys_out.append(k[:take])
            ops_out.append(o[:take])
            t_out.append(t[:take])
            claims.append((ticket, start, take))
            self.client_pending[client] -= take
            if not self.client_pending[client]:
                del self.client_pending[client]
            if take == cnt:
                self._keys.pop(0)
                self._ops.pop(0)
                self._tenq.pop(0)
                self._claims.pop(0)
                self._clients.pop(0)
            else:
                self._keys[0] = k[take:]
                self._ops[0] = o[take:]
                self._tenq[0] = t[take:]
                self._claims[0] = (ticket, start + take, cnt - take)
            need -= take
        self.pending -= m
        return (np.concatenate(keys_out), np.concatenate(ops_out),
                np.concatenate(t_out), claims)
