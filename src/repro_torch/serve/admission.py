"""Bounded priority admission for streaming sessions — port of
``repro.serve.admission`` (the single-engine queue; the fleet's
weighted-fair queue is not ported yet).

``submit`` records a request (sid, priority, optionally an evicted
:class:`Session` to re-attach); the engine drains the queue into free rows
at tick boundaries, highest priority first, FIFO within a priority.  At
``max_pending`` waiting requests ``submit`` raises :class:`QueueFull`.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

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

    def drain(self, store: SessionStore) -> list[Session]:
        """Admit waiting requests into free store rows, best-priority first.

        A ticket the store rejects is dropped without stopping the drain;
        :class:`DrainRejected` is raised once the drain has finished.
        """
        admitted: list[Session] = []
        rejected: list[tuple[Ticket, Exception]] = []
        while self._pending and len(store) < store.max_sessions:
            _, _, ticket = heapq.heappop(self._heap)
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

    def __len__(self) -> int:
        return len(self._pending)
