"""FilterService: a deadline-driven, backpressured micro-batching front-end.

Port of ``repro.amq.service``. Serving traffic reaches a filter as many
small, interleaved op streams — one per logical client — while the device
wants few, larger dispatches. The service bridges the two (DESIGN.md §9,
serving engine §11):

* **Coalescing**: ``query`` / ``insert`` / ``delete`` / ``submit`` calls
  append ops (any count, any client) onto one pending stream in arrival
  order. A full micro-batch dispatches immediately; short tails dispatch
  when their **deadline** (``max_delay``) expires, when a result is
  demanded, or on :meth:`flush`.
* **Shape ladder**: a forced (deadline/flush/backpressure) dispatch pads to
  the smallest power-of-two-ish ladder rung that fits instead of the full
  ``batch_size``, so deadline-mode padding waste stays bounded by the live
  op count.
* **Admission control**: ``max_pending`` bounds the pending queue with an
  explicit policy — ``"block"`` (dispatch early to make room — the
  backpressure path), ``"shed"`` (refuse the submission; its ticket
  reports ``shed``), or ``"error"`` (raise
  :class:`~repro_torch.amq.dispatch.QueueFullError`). ``client_share``
  caps any one client's slice of the queue (fairness).
* **Fused execution**: each micro-batch runs as a single mixed-op pass on
  the wrapped handle (``handle.apply_ops``, which moves the batch onto the
  handle's device) — queries, inserts, and deletes of *different* clients
  share one dispatch; in-batch order equals global arrival order, so the
  per-key semantics of DESIGN.md §9 apply across clients.
* **In-flight window**: each batch's
  :class:`~repro_torch.amq.protocol.MixedReport` stays on the device until
  a ticket's :meth:`Ticket.result` is called or the ``max_in_flight``
  window (default 2) slides past it. (The port's ``apply_ops`` itself
  reads a few counts back to the host on the way, so a dispatch does not
  overlap the next one's packing as the JAX package's does.)
* **Scatter**: every submission returns a :class:`Ticket` that knows which
  slots of which micro-batches carry its ops; ``result()`` gathers exactly
  those slots back into per-client order, however the ops were interleaved.
  Tickets carry enqueue → dispatch → ready timestamps.
* **Observability**: a :class:`~repro_torch.amq.dispatch.ServiceMetrics`
  ledger (histogram-bucketed enqueue→dispatch / enqueue→ready latency,
  queue depth, padding waste, dispatch-size and trigger distributions,
  per-client admission outcomes, swap pauses) — read the legacy counters
  as ``svc.stats["ops"]`` and the full SLO snapshot as ``svc.stats()``.
* **Hot swap** (DESIGN.md §10): :meth:`FilterService.hot_swap` drains the
  pending stream onto the old backend, migrates its state onto a new
  handle through a snapshot (``migrate=True``, the default) and resumes
  there.

Example::

    from repro_torch import amq

    svc = amq.FilterService(amq.make("cuckoo", capacity=1 << 20),
                            batch_size=1024, max_delay=0.002,
                            max_pending=8192, admission="shed")
    t1 = svc.insert(keys_a, client="ingest")   # client A
    t2 = svc.query(keys_b, client="serve")     # client B — may share A's batch
    hits = t2.result()                         # flushes pending ops, scatters B's
    svc.stats()["ready"]["p99_s"]              # SLO readout
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.hashing import normalize_keys
from .dispatch import (
    Dispatch,
    PendingStream,
    QueueFullError,
    ServiceMetrics,
    batch_align,
    rung_for,
    shape_ladder,
)
from .protocol import (
    OP_DELETE,
    OP_INSERT,
    OP_QUERY,
    OpBatch,
    normalize_ops,
)

_ADMISSION_POLICIES = ("block", "shed", "error")


class Ticket:
    """A client's claim on its slice of one or more micro-batches.

    ``result()`` returns ``ok`` per submitted op, in submission order
    (query → hit, insert → landed, delete → removed). ``routed()`` returns
    the matching routed mask (sharded backends). Both force a flush of any
    still-pending part of the submission.

    Lifecycle timestamps (service-clock seconds): ``t_enqueue`` when the
    submission was accepted, ``t_dispatch`` when its last op left the
    pending queue, ``t_ready`` when its results were first gathered.
    ``shed`` marks a submission refused by the shed admission policy —
    its ops never ran (``result()`` is all-False and nothing ever flushes
    on its behalf).
    """

    def __init__(self, service: "FilterService", n: int, *, client=None,
                 shed: bool = False):
        self._service = service
        self._n = n
        self.client = client
        self.shed = shed
        self.t_enqueue: float = service._clock()
        self.t_dispatch: Optional[float] = None
        self.t_ready: Optional[float] = None
        # (dispatch, slots-in-batch, positions-in-submission); appended by
        # the service when a batch carrying part of this submission
        # launches. Tickets are the only owners of Dispatch objects, so a
        # batch's reports are reclaimed as soon as every ticket that drew
        # from it is garbage — the service itself only keeps the bounded
        # in-flight window.
        self._parts: List[Tuple[Dispatch, np.ndarray, np.ndarray]] = []
        self._filled = 0
        if n == 0 or shed:
            # Nothing will ever dispatch for this ticket: it is born ready.
            self.t_dispatch = self.t_ready = self.t_enqueue

    def _gather(self, field: str) -> np.ndarray:
        if self.shed:
            return np.zeros((self._n,), bool)
        self._service._flush_for(self)
        out = np.zeros((self._n,), bool)
        for dispatch, slots, positions in self._parts:
            out[positions] = getattr(dispatch, field)()[slots]
        if self.t_ready is None:
            self.t_ready = self._service._clock()
        return out

    @property
    def dispatched(self) -> bool:
        """True once every op of this submission has left the pending
        stream — ``result()`` will then not force a flush."""
        return self.shed or self._filled >= self._n

    def result(self) -> np.ndarray:
        """Per-op outcomes, in submission order (bool[n])."""
        return self._gather("ok")

    def routed(self) -> np.ndarray:
        """Per-op routed mask, in submission order (bool[n])."""
        return self._gather("routed")


class _ServiceStats(dict):
    """Legacy counter dict that is also callable for the full SLO snapshot.

    ``svc.stats["dispatches"]`` keeps working (the pre-§11 counter
    surface); ``svc.stats()`` returns the complete
    :meth:`~repro_torch.amq.dispatch.ServiceMetrics.stats` payload plus these
    counters and the live queue depth.
    """

    def __init__(self, service: "FilterService"):
        super().__init__(dispatches=0, ops=0, padded=0)
        self._service = service

    def __call__(self) -> dict:
        svc = self._service
        out = svc.metrics.stats()
        out.update(self)
        out["pending_ops"] = svc.pending_ops
        out["fill"] = svc.stats_fill
        out["batch_size"] = svc.batch_size
        out["shape_ladder"] = list(svc._ladder)
        out["backend"] = svc.handle.name
        tiers = getattr(svc.handle, "tier_stats", None)
        if callable(tiers):
            # Tiered handles (DESIGN.md §12): budget use and cold-probe
            # traffic, the service's only off-device work.
            out["tiers"] = tiers()
        return out


def _validate_args(batch_size, max_delay, max_pending, admission,
                   client_share, max_in_flight) -> None:
    """Loud, argument-naming boundary checks (DESIGN.md §10 discipline)."""
    if not isinstance(batch_size, (int, np.integer)) or batch_size <= 0:
        raise ValueError(
            f"batch_size must be a positive int, got {batch_size!r}")
    if max_delay is not None:
        try:
            bad = not (float(max_delay) >= 0.0)
        except (TypeError, ValueError):
            bad = True
        if bad:
            raise ValueError(
                f"max_delay must be None or a non-negative number of "
                f"seconds, got {max_delay!r}")
    if max_pending is not None and (
            not isinstance(max_pending, (int, np.integer))
            or max_pending <= 0):
        raise ValueError(
            f"max_pending must be None or a positive int, got "
            f"{max_pending!r}")
    if admission not in _ADMISSION_POLICIES:
        raise ValueError(
            f"admission must be one of {_ADMISSION_POLICIES}, got "
            f"{admission!r}")
    if not (isinstance(client_share, (int, float, np.floating))
            and 0.0 < float(client_share) <= 1.0):
        raise ValueError(
            f"client_share must be a fraction in (0, 1], got "
            f"{client_share!r}")
    if max_in_flight is not None and (
            not isinstance(max_in_flight, (int, np.integer))
            or max_in_flight <= 0):
        raise ValueError(
            f"max_in_flight must be None or a positive int, got "
            f"{max_in_flight!r}")


class FilterService:
    """Coalesce many clients' op streams into fused, SLO-aware OpBatches.

    ``handle`` is any AMQ handle. ``batch_size`` is the
    micro-batch width — the top of the dispatch shape ladder; keep it large
    enough to amortise dispatch, small enough that a full batch's compute
    fits the latency budget.

    SLO knobs (all validated loudly, DESIGN.md §11):

    * ``max_delay`` — deadline seconds: once the oldest pending op has
      waited this long, the next service interaction (any submit, an
      explicit :meth:`poll`, or a result gather) dispatches the tail at a
      ladder shape instead of letting it wait for a full batch. ``None``
      (default) preserves the pre-§11 dispatch-on-full-only behaviour.
    * ``max_pending`` / ``admission`` / ``client_share`` — admission
      control (see class docstring bullets).
    * ``max_in_flight`` — dispatches whose reports stay on the device
      (default 2).
    * ``clock`` — injectable monotonic-seconds source (defaults to
      ``time.monotonic``); the traffic harness drives a virtual clock
      through it, which is also how deadline behaviour is unit-tested.
    """

    def __init__(self, handle, *, batch_size: int = 1024,
                 max_delay: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 admission: str = "block",
                 client_share: float = 1.0,
                 max_in_flight: Optional[int] = 2,
                 clock=None):
        _validate_args(batch_size, max_delay, max_pending, admission,
                       client_share, max_in_flight)
        self.handle = handle
        self.batch_size = int(batch_size)
        self.max_delay = None if max_delay is None else float(max_delay)
        self.max_pending = None if max_pending is None else int(max_pending)
        self.admission = admission
        self.client_share = float(client_share)
        self.max_in_flight = (None if max_in_flight is None
                              else int(max_in_flight))
        self._clock = time.monotonic if clock is None else clock
        self._align = batch_align(handle)
        self._ladder = shape_ladder(self.batch_size, self._align)
        self._queue = PendingStream()
        self._in_flight: List[Dispatch] = []
        self.metrics = ServiceMetrics()
        self.stats = _ServiceStats(self)

    # -- introspection -------------------------------------------------------

    @property
    def pending_ops(self) -> int:
        """Ops accepted but not yet dispatched."""
        return self._queue.pending

    @property
    def stats_fill(self) -> float:
        """Realised batch utilisation: live slots / dispatched slots."""
        total = (self.stats["ops"] - self.pending_ops - self.metrics.shed_ops
                 + self.stats["padded"])
        live = self.stats["ops"] - self.pending_ops - self.metrics.shed_ops
        return live / total if total else 1.0

    @property
    def shape_ladder(self) -> Tuple[int, ...]:
        """The dispatch shapes this service pads to (top = batch_size)."""
        return self._ladder

    def _client_limit(self) -> Optional[int]:
        if self.max_pending is None or self.client_share >= 1.0:
            return None
        return max(1, int(self.client_share * self.max_pending))

    # -- submission ----------------------------------------------------------

    def submit(self, keys, ops, *, client=None) -> Ticket:
        """Append a client's op stream; returns its :class:`Ticket`.

        ``keys``: raw ``uint64[m]`` or packed ``uint32[m, 2]`` pairs (the
        key-format contract — see ``repro_torch.core.hashing.normalize_keys``);
        ``ops``: int32[m] op codes; ``client``: optional hashable id for
        fairness accounting and the per-client queue-share bound. The ops
        join the global stream in call order — coalescing never reorders.
        Malformed arguments raise ``ValueError`` naming the offending
        argument at the boundary, before anything is enqueued; a full
        queue follows the admission policy (block / shed / error).

        ``n == 0`` submissions return an immediately-ready empty ticket:
        nothing is enqueued, no padded dispatch is forced, and no deadline
        starts ticking.
        """
        keys = normalize_keys(keys, arg="keys").cpu().numpy().view(np.uint32)
        ops = normalize_ops(ops, keys.shape[0]).cpu().numpy()
        if ((ops == OP_DELETE).any()
                and not self.handle.capabilities.supports_delete):
            raise NotImplementedError(
                f"{self.handle.name}: append-only backend cannot serve "
                "deletes (capabilities.supports_delete is False)")
        n = keys.shape[0]
        if n == 0:
            return Ticket(self, 0, client=client)

        # -- admission control (DESIGN.md §11) -------------------------------
        if self.max_pending is not None:
            if self.admission == "block":
                # Backpressure: make room by dispatching early. Ladder
                # shapes keep the forced padding proportional to the tail.
                while (self._queue.pending
                       and self._queue.pending + n > self.max_pending):
                    self._dispatch(min(self._queue.pending, self.batch_size),
                                   kind="backpressure")
            else:
                share = self._client_limit()
                held = self._queue.client_pending.get(client, 0)
                over_share = share is not None and held + n > share
                over_global = self._queue.pending + n > self.max_pending
                if over_global or over_share:
                    bound = (f"max_pending={self.max_pending}" if over_global
                             else f"client {client!r} share={share} "
                                  f"(client_share={self.client_share})")
                    if self.admission == "error":
                        raise QueueFullError(
                            f"pending queue full: {self._queue.pending} "
                            f"pending + {n} submitted exceeds {bound}")
                    self.metrics.observe_shed(n, client)
                    return Ticket(self, n, client=client, shed=True)

        ticket = Ticket(self, n, client=client)
        self._queue.append(keys, ops, ticket.t_enqueue, ticket, client)
        self.stats["ops"] += n
        self.metrics.observe_enqueue(n, client, self._queue.pending)
        while self._queue.pending >= self.batch_size:
            self._dispatch(self.batch_size, kind="full")
        if (self.max_pending is not None and self.admission == "block"
                and self._queue.pending > self.max_pending):
            # A single over-bound submission: drain its own tail too.
            self._dispatch(self._queue.pending, kind="backpressure")
        self.poll()
        return ticket

    def query(self, keys, *, client=None) -> Ticket:
        """Enqueue membership queries for ``keys``."""
        return self.submit(keys, np.full((len(keys),), OP_QUERY, np.int32),
                           client=client)

    def insert(self, keys, *, client=None) -> Ticket:
        """Enqueue inserts for ``keys``."""
        return self.submit(keys, np.full((len(keys),), OP_INSERT, np.int32),
                           client=client)

    def delete(self, keys, *, client=None) -> Ticket:
        """Enqueue deletes for ``keys`` (capability-gated at submit)."""
        return self.submit(keys, np.full((len(keys),), OP_DELETE, np.int32),
                           client=client)

    # -- execution -----------------------------------------------------------

    def poll(self) -> int:
        """Fire any deadline-due dispatches; returns how many were fired.

        With ``max_delay`` unset this is a no-op. Call it from an event
        loop (or let any submit/result call do it implicitly) — the
        deadline guarantee is: once the oldest pending op has waited
        ``max_delay``, the *next* service interaction dispatches it, so
        enqueue→dispatch latency is bounded by ``max_delay`` plus one
        interaction gap plus one dispatch.
        """
        if self.max_delay is None:
            return 0
        fired = 0
        while self._queue.pending:
            oldest = self._queue.oldest_enqueue()
            if self._clock() - oldest < self.max_delay:
                break
            self._dispatch(min(self._queue.pending, self.batch_size),
                           kind="deadline")
            fired += 1
        return fired

    def flush(self) -> None:
        """Dispatch every pending op now (tails pad to ladder shapes)."""
        while self._queue.pending:
            self._dispatch(min(self._queue.pending, self.batch_size),
                           kind="flush")

    def drain(self) -> None:
        """Flush, then copy every in-flight dispatch's report to the host
        (settles the enqueue→ready histogram before final metrics are
        read)."""
        self.flush()
        for dispatch in self._in_flight:
            dispatch.ok()
        self._in_flight.clear()

    def hot_swap(self, new_handle, *, migrate: bool = True) -> dict:
        """Swap the backing filter with zero downtime (DESIGN.md §10).

        Sequence:

        1. **drain** — every accepted-but-pending op is dispatched to the
           *old* handle and the device is synced, so no acknowledged
           operation is lost (tickets already issued keep their claims on
           the old dispatches and stay readable);
        2. **migrate** — the old handle's state moves to ``new_handle``
           through ``new_handle.restore(old.snapshot())`` (``migrate=True``,
           the default): a same-config replica, or a cascade or tiered
           handle built with the same knobs. Pass ``migrate=False`` to swap
           to a pre-populated handle (e.g. rebuilt offline from the source
           of truth).
        3. **resume** — subsequent submissions coalesce onto the new
           handle; the shape ladder is rebuilt for the new backend's
           ``batch_align``; nothing about tickets or batching changes.

        Returns swap stats: ``pause_s`` (wall-clock the service could not
        accept dispatches), ``drained_ops``, ``migrated``, and the old/new
        backend names; the record is also appended to ``metrics.swaps``.
        A mismatched migration target raises
        :class:`~repro_torch.amq.protocol.SnapshotMismatchError` before the
        swap (the service keeps running on the old handle); an
        incompatible ``batch_align`` raises ``ValueError`` before anything
        drains.
        """
        align = batch_align(new_handle)
        if self.batch_size % align:
            raise ValueError(
                f"batch_size={self.batch_size} is not a multiple of the "
                f"new handle's batch_align={align}; the swapped-in backend "
                "could never dispatch — refusing before the drain")
        t0 = time.perf_counter()
        drained = self.pending_ops
        self.flush()
        old = self.handle
        # Sync: the old table(s) are fully written before the migration
        # (the snapshot would wait anyway; this also covers migrate=False).
        if old.device.type == "cuda":
            torch.cuda.synchronize(old.device)
        if migrate:
            new_handle.restore(old.snapshot())
        self.handle = new_handle
        self._align = align
        self._ladder = shape_ladder(self.batch_size, align)
        record = {"pause_s": time.perf_counter() - t0,
                  "drained_ops": drained, "migrated": bool(migrate),
                  "old_backend": old.name, "new_backend": new_handle.name}
        self.metrics.observe_swap(record)
        return record

    def _flush_for(self, ticket: Ticket) -> None:
        if ticket._filled < ticket._n:
            self.flush()

    def _dispatch(self, m: int, kind: str = "full") -> None:
        now = self._clock()
        keys, ops, enqueued_at, claims = self._queue.take(m)
        shape = rung_for(m, self._ladder)
        # Host-side padding: each channel crosses host->device once, at
        # its final ladder shape (no device concatenates per dispatch).
        batch = OpBatch.make_padded(keys, ops, shape)
        report = self.handle.apply_ops(batch)  # not copied to the host here
        dispatch = Dispatch(report, self.metrics, self._clock, enqueued_at)
        self.stats["dispatches"] += 1
        self.stats["padded"] += shape - m
        self.metrics.observe_dispatch(m, shape, kind, now - enqueued_at)

        # Scatter the contiguous claim ranges back onto tickets (the
        # tickets alone keep a dispatch alive past the in-flight window —
        # see Ticket._parts).
        slot = 0
        for ticket, start, cnt in claims:
            ticket._parts.append((dispatch,
                                  np.arange(slot, slot + cnt),
                                  np.arange(start, start + cnt)))
            ticket._filled += cnt
            if ticket._filled >= ticket._n:
                ticket.t_dispatch = now
            slot += cnt

        # Slide the in-flight window: copying the oldest batch's report to
        # the host bounds the device-result backlog and stamps enqueue→ready
        # latencies promptly. With an unbounded
        # window the service tracks nothing (tickets alone own dispatches,
        # the pre-§11 behaviour).
        if self.max_in_flight is not None:
            self._in_flight.append(dispatch)
            while len(self._in_flight) > self.max_in_flight:
                self._in_flight.pop(0).ok()
            self._in_flight = [d for d in self._in_flight if not d.done]
