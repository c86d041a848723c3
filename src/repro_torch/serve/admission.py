"""Bounded admission for streaming sessions — port of
``repro.serve.admission``.

``submit`` records a request (sid, priority, optionally an evicted
:class:`Session` to re-attach); the engine drains the queue into free rows
at tick boundaries, highest priority first, FIFO within a priority.  At
``max_pending`` waiting requests ``submit`` raises :class:`QueueFull`.

:class:`WeightedFairQueue` is the fleet's one queue for every tenant: a
drain hands free capacity to the backlogged tenant with the fewest
admissions per unit weight (stride scheduling), FIFO within a tenant, with
an aging guard for starved head-of-line tickets.  Its admission order is
integer behaviour and equals the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Callable, Iterator, Mapping

from repro_torch.serve.sessions import CapacityError, Session, SessionStore


class QueueFull(RuntimeError):
    """Admission refused: ``max_pending`` requests are already waiting."""


class DrainRejected(RuntimeError):
    """One or more tickets could not be admitted during a drain.

    Raised after the drain completes, carrying ``admitted`` (sessions that
    went live) and ``rejected`` (``[(Ticket, Exception), ...]``).
    """

    def __init__(self, admitted: list[Session], rejected: list):
        self.admitted = admitted
        self.rejected = rejected
        sids = ", ".join(repr(t.sid) for t, _ in rejected)
        super().__init__(
            f"drain rejected ticket(s) {sids} "
            f"({len(admitted)} session(s) still admitted this drain): "
            + "; ".join(str(err) for _, err in rejected))


@dataclasses.dataclass(frozen=True)
class Ticket:
    """One queued admission request (drain order: priority desc, then FIFO)."""

    sid: str
    priority: int
    seq: int
    session: Session | None = None
    submitted_at: float = 0.0
    n_samples: int | None = None
    mode: str | None = None    # fresh admissions: "mc" | "student" (None:
                               # "mc"; a re-attach carries its own mode)


class AdmissionQueue:
    """Bounded priority queue feeding a :class:`SessionStore`."""

    def __init__(self, max_pending: int = 256):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self._heap: list[tuple[int, int, Ticket]] = []
        self._pending: dict[str, Ticket] = {}
        self._seq = 0

    def submit(self, sid: str, *, priority: int = 0,
               session: Session | None = None,
               n_samples: int | None = None,
               mode: str | None = None) -> Ticket:
        """Queue an admission (or, with ``session``, a re-attach) request.

        ``n_samples`` and ``mode`` ride the ticket of a fresh admission and
        are checked by the store when it is drained (a student ticket
        drains into a student session).
        """
        if session is not None and session.sid != sid:
            raise ValueError(f"ticket sid {sid!r} != session.sid "
                             f"{session.sid!r}")
        if sid in self._pending:
            raise ValueError(f"session {sid!r} already queued")
        if len(self._pending) >= self.max_pending:
            raise QueueFull(
                f"admission queue full ({self.max_pending} pending); "
                "shed load upstream or raise max_pending")
        ticket = Ticket(sid=sid, priority=int(priority), seq=self._seq,
                        session=session, submitted_at=time.monotonic(),
                        n_samples=None if n_samples is None
                        else int(n_samples), mode=mode)
        self._seq += 1
        self._pending[sid] = ticket
        heapq.heappush(self._heap, (-ticket.priority, ticket.seq, ticket))
        return ticket

    def cancel(self, sid: str) -> bool:
        """Withdraw a waiting request; False if it was not queued."""
        hit = self._pending.pop(sid, None) is not None
        # Deletion is lazy (drain skips stale heap entries); compact so
        # submit / cancel churn on a full store cannot grow the heap.
        if hit and len(self._heap) > 2 * len(self._pending) + 8:
            self._heap = [(-t.priority, t.seq, t)
                          for t in self._pending.values()]
            heapq.heapify(self._heap)
        return hit

    def drain(self, store: SessionStore) -> list[Session]:
        """Admit waiting requests into free store rows, best-priority first.

        A ticket the store rejects is dropped without stopping the drain;
        :class:`DrainRejected` is raised once the drain has finished.
        """
        admitted: list[Session] = []
        rejected: list[tuple[Ticket, Exception]] = []
        while self._pending and len(store) < store.max_sessions:
            _, _, ticket = heapq.heappop(self._heap)
            if self._pending.get(ticket.sid) is not ticket:
                continue                      # cancelled (lazy deletion)
            del self._pending[ticket.sid]
            try:
                if ticket.session is not None:
                    admitted.append(store.attach(ticket.session))
                else:
                    admitted.append(store.admit(
                        ticket.sid, n_samples=ticket.n_samples,
                        mode=ticket.mode or "mc"))
            except (ValueError, CapacityError) as err:
                rejected.append((ticket, err))
        if rejected:
            raise DrainRejected(admitted, rejected)
        return admitted

    def oldest_wait_s(self, now: float | None = None) -> float:
        """Age (s) of the oldest still-waiting ticket; 0.0 when empty."""
        if not self._pending:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(0.0, now - min(t.submitted_at
                                  for t in self._pending.values()))

    def waiting(self) -> list[Ticket]:
        """Live tickets in drain order (priority desc, FIFO within)."""
        return sorted(self._pending.values(),
                      key=lambda t: (-t.priority, t.seq))

    @property
    def depth(self) -> int:
        return len(self._pending)

    def __len__(self) -> int:
        return len(self._pending)

    def __contains__(self, sid: str) -> bool:
        return sid in self._pending

    def __iter__(self) -> Iterator[Ticket]:
        return iter(self.waiting())


# ---------------------------------------------------------------------------
# Weighted-fair admission across tenants (the fleet's shared queue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetTicket(Ticket):
    """One queued admission request, tagged with its owning tenant."""

    tenant: str = ""
    enqueued_round: int = 0     # drain round at submit (aging-guard clock)


class WeightedFairQueue:
    """One bounded admission queue shared by every tenant of a fleet.

    ``drain`` admits from the tenant, among those with pending tickets and
    room, whose admitted count per unit weight is smallest (name breaks
    ties), so under sustained overload each tenant's share of admissions
    converges to its weight's share.  Within a tenant the order is FIFO.
    A head-of-line ticket that has waited ``aging_rounds`` drain rounds is
    admitted before the weighted pick, oldest first.  ``state`` /
    ``load_state`` carry the fairness ledger through fleet snapshots.
    """

    def __init__(self, weights: Mapping[str, float], *,
                 max_pending: int = 256, aging_rounds: int = 16):
        if not weights:
            raise ValueError("need at least one tenant weight")
        for name, w in weights.items():
            if "/" in name:
                raise ValueError(f"tenant name {name!r} may not contain '/' "
                                 "(reserved for fleet sid namespacing)")
            if not w > 0:
                raise ValueError(f"tenant {name!r} weight must be > 0, "
                                 f"got {w}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if aging_rounds < 1:
            raise ValueError(f"aging_rounds must be >= 1, "
                             f"got {aging_rounds}")
        self.weights = {name: float(w) for name, w in weights.items()}
        self.max_pending = int(max_pending)
        self.aging_rounds = int(aging_rounds)
        self._fifos: dict[str, deque[FleetTicket]] = {
            name: deque() for name in self.weights}
        self._admitted: dict[str, int] = {name: 0 for name in self.weights}
        self._round = 0
        self._seq = 0
        self._sids: set[str] = set()

    def submit(self, tenant: str, sid: str, *, priority: int = 0,
               session: Session | None = None,
               mode: str | None = None) -> FleetTicket:
        """Queue an admission (or re-attach) request for ``tenant``."""
        if tenant not in self._fifos:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(fleet serves {sorted(self._fifos)})")
        if session is not None and session.sid != sid:
            raise ValueError(f"ticket sid {sid!r} != session.sid "
                             f"{session.sid!r}")
        if sid in self._sids:
            raise ValueError(f"session {sid!r} already queued")
        if len(self._sids) >= self.max_pending:
            raise QueueFull(
                f"fleet admission queue full ({self.max_pending} pending); "
                "shed load upstream or raise max_pending")
        ticket = FleetTicket(sid=sid, priority=int(priority), seq=self._seq,
                             session=session,
                             submitted_at=time.monotonic(), mode=mode,
                             tenant=tenant, enqueued_round=self._round)
        self._seq += 1
        self._sids.add(sid)
        self._fifos[tenant].append(ticket)
        return ticket

    def cancel(self, sid: str) -> bool:
        """Withdraw a waiting request; False if it was not queued."""
        if sid not in self._sids:
            return False
        self._sids.discard(sid)
        for fifo in self._fifos.values():
            for ticket in fifo:
                if ticket.sid == sid:
                    fifo.remove(ticket)
                    return True
        return True

    def drain(self, admit: Callable[[FleetTicket], Session],
              has_room: Callable[[str], bool],
              budget: int | None = None) -> list[FleetTicket]:
        """Admit pending tickets weighted-fair until no tenant can take more.

        ``admit(ticket)`` makes the session live (a ``ValueError`` or
        ``CapacityError`` rejects the ticket, which is dropped and costs no
        budget); ``has_room(tenant)`` False freezes that tenant's FIFO for
        this drain; ``budget`` caps the admissions (None: unbounded).
        Returns the admitted tickets in order; raises
        :class:`DrainRejected` (both lists attached) after the drain if any
        ticket was refused.
        """
        self._round += 1
        admitted: list[FleetTicket] = []
        rejected: list[tuple[FleetTicket, Exception]] = []
        left = float("inf") if budget is None else int(budget)

        def _take(ticket: FleetTicket) -> None:
            nonlocal left
            self._fifos[ticket.tenant].popleft()
            self._sids.discard(ticket.sid)
            try:
                admit(ticket)
            except (ValueError, CapacityError) as err:
                rejected.append((ticket, err))
                return
            self._admitted[ticket.tenant] += 1
            admitted.append(ticket)
            left -= 1

        # Aging guard first: stale head tickets, oldest enqueue round first.
        while left > 0:
            stale = [f[0] for name, f in self._fifos.items()
                     if f and has_room(name)
                     and self._round - f[0].enqueued_round
                     >= self.aging_rounds]
            if not stale:
                break
            _take(min(stale, key=lambda t: (t.enqueued_round, t.seq)))

        # Weighted-fair: the eligible tenant with the lowest admitted/weight.
        while left > 0:
            eligible = [name for name, f in self._fifos.items()
                        if f and has_room(name)]
            if not eligible:
                break
            name = min(eligible,
                       key=lambda n: (self._admitted[n] / self.weights[n], n))
            _take(self._fifos[name][0])
        if rejected:
            raise DrainRejected(admitted, rejected)
        return admitted

    def oldest_wait_s(self, tenant: str | None = None,
                      now: float | None = None) -> float:
        """Head-of-line age (s): fleet-wide, or one tenant's own FIFO."""
        fifos = ([self._fifos[tenant]] if tenant is not None
                 else self._fifos.values())
        heads = [f[0].submitted_at for f in fifos if f]
        if not heads:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(0.0, now - min(heads))

    def waiting(self, tenant: str | None = None) -> list[FleetTicket]:
        """Pending tickets (one tenant's FIFO, or all tenants, FIFO order)."""
        if tenant is not None:
            return list(self._fifos[tenant])
        out = [t for f in self._fifos.values() for t in f]
        return sorted(out, key=lambda t: t.seq)

    def shares(self) -> dict[str, float]:
        """Cumulative admitted-capacity share per tenant (sums to 1.0)."""
        total = sum(self._admitted.values())
        if not total:
            return {name: 0.0 for name in self._admitted}
        return {name: n / total for name, n in self._admitted.items()}

    @property
    def depth(self) -> int:
        return len(self._sids)

    def depth_of(self, tenant: str) -> int:
        return len(self._fifos[tenant])

    def __len__(self) -> int:
        return len(self._sids)

    def __contains__(self, sid: str) -> bool:
        return sid in self._sids

    # -- persistence hooks (serve.persistence fleet snapshots) ---------------
    def state(self) -> dict:
        """Fairness ledger and round / seq cursors (tickets go apart)."""
        return {"admitted": dict(self._admitted), "round": self._round,
                "seq": self._seq}

    def load_state(self, state: dict) -> None:
        for name, n in (state.get("admitted") or {}).items():
            if name in self._admitted:
                self._admitted[name] = int(n)
        self._round = int(state.get("round", 0))
        self._seq = max(self._seq, int(state.get("seq", 0)))
