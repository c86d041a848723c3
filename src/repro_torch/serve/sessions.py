"""Per-session carried state for streaming serving — port of
``repro.serve.sessions``.

A session owns two things: its per-layer, per-chain carry — ``(h, c)``
for an LSTM layer, ``(h,)`` for a GRU layer — (tensors on the serving
device; ``c`` fp32 on the kernel backends, so a chunk boundary round-trips
it losslessly) and its ``(seed, rows)``
mask-stream coordinates, allocated once at admission from a monotone
allocator and never reused, so every chunk redraws the same masks.

Rows are host numpy uint32 arrays, allocated exactly as the reference
allocates them.  ``retire`` (the early-exit primitive) trims a session to a
prefix of its chains; the ids it drops stay burned.  ``grow`` is its
reverse and the student-escalation primitive: fresh rows from the
allocator, never a reused id.  A ``"student"`` session runs one
deterministic row whose id carries ``mcd.STUDENT_ROW_FLAG``, so the
kernels run it unmasked in the same launch as its MC neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import mcd as _mcd

#: Session serving modes: ``"mc"`` runs S Bayesian chains; ``"student"``
#: runs one deterministic (flagged) row decoded by the student heads.
MODES = ("mc", "student")


class CapacityError(RuntimeError):
    """Admission refused: the store already holds ``max_sessions`` sessions."""


@dataclasses.dataclass
class Session:
    """One monitored stream: mask coordinates + carried recurrent state."""

    sid: str
    rows: np.ndarray           # [s] uint32 mask-stream row ids, for life
    seed: Any                  # counter-PRNG base seed (engine-wide)
    state: list | None = None  # per-layer [(h [s,H], c [s,H]) | (h,), ...]
                               # or None while fresh
    steps: int = 0             # timesteps consumed so far
    chunks: int = 0            # chunks served so far
    mode: str = "mc"           # MODES; a student session carries exactly
                               # one flagged deterministic row

    @property
    def fresh(self) -> bool:
        return self.state is None


class SessionStore:
    """Capacity-bounded registry of live streaming sessions.

    ``n_samples`` is the chain ceiling: the default and maximum number of
    MC chains per session; ``admit`` may open a session with fewer.
    """

    def __init__(self, n_samples: int, seed=0, *, max_sessions: int = 64,
                 first_row: int = 0):
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        self.n_samples = int(n_samples)
        self.seed = seed
        self.max_sessions = int(max_sessions)
        self._next_row = int(first_row)
        self._sessions: dict[str, Session] = {}

    def admit(self, sid: str, *, n_samples: int | None = None,
              mode: str = "mc") -> Session:
        """Register a new stream; allocates its mask rows for life.

        ``mode="student"`` opens one deterministic row, ``student_row`` of
        the next base id (one id burned, so :meth:`grow` can escalate it
        to fresh MC rows without a collision); ``n_samples`` must then be
        None or 1.
        """
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} already admitted")
        if len(self._sessions) >= self.max_sessions:
            raise CapacityError(
                f"store full ({self.max_sessions} sessions); evict first")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "student":
            if n_samples not in (None, 1):
                raise ValueError(
                    f"session {sid!r}: student sessions run exactly one "
                    f"deterministic row, got n_samples={n_samples}")
            self._check_allocator(1)
            rows = np.asarray([_mcd.student_row(self._next_row)], np.uint32)
            self._next_row += 1
            sess = Session(sid=sid, rows=rows, seed=self.seed,
                           mode="student")
            self._sessions[sid] = sess
            return sess
        s = self.n_samples if n_samples is None else int(n_samples)
        if not 1 <= s <= self.n_samples:
            raise ValueError(
                f"session {sid!r} wants {s} MC chains, store ceiling is "
                f"{self.n_samples} (floor 1)")
        self._check_allocator(s)
        rows = np.arange(self._next_row, self._next_row + s, dtype=np.uint32)
        self._next_row += s
        sess = Session(sid=sid, rows=rows, seed=self.seed)
        self._sessions[sid] = sess
        return sess

    def _check_allocator(self, count: int) -> None:
        # Base row ids stay below the student-flag bit.
        if self._next_row + count > _mcd.STUDENT_ROW_FLAG:
            raise RuntimeError(
                f"row allocator exhausted ({self._next_row} ids burned; "
                f"ceiling {_mcd.STUDENT_ROW_FLAG})")

    def retire(self, sid: str, keep: int) -> int:
        """Shrink a live session to its first ``keep`` MC chains.

        Chains are independent trajectories, so keeping a *prefix* leaves
        the survivors' masks and carries untouched: the shrunk session
        streams on bit-identically to one that had those ``keep`` rows all
        along, and co-batched neighbours never notice.  The freed rows are
        released as batch capacity only — their ids stay burned in the
        allocator.  Returns the number of rows retired.
        """
        sess = self.get(sid)
        s_old = int(sess.rows.shape[0])
        keep = int(keep)
        if not 1 <= keep <= s_old:
            raise ValueError(
                f"session {sid!r}: keep={keep} must be in [1, {s_old}]")
        if keep == s_old:
            return 0
        sess.rows = sess.rows[:keep].copy()
        if sess.state is not None:
            sess.state = [tuple(part[:keep] for part in layer)
                          for layer in sess.state]
        return s_old - keep

    def grow(self, sid: str, n: int) -> int:
        """Grow a live session to ``n`` MC chains with fresh rows.

        The reverse of :meth:`retire` and the student-escalation
        primitive; fresh ids come from the monotone allocator.

        * An MC session gains ``n - s`` chains starting from zero carries,
          each part in its own dtype (h in the activation dtype, an LSTM's
          c in fp32).
        * A student session is replaced: its deterministic row retires and
          ``n`` fresh MC rows take over, each resuming a copy of the
          student's carry; its mode becomes ``"mc"``.  It then streams
          bit-identically to an MC session attached with those rows and
          that carry.

        Returns the number of fresh rows allocated (0 if already at ``n``).
        """
        sess = self.get(sid)
        s_old = int(sess.rows.shape[0])
        n = int(n)
        student = sess.mode == "student"
        if not (1 if student else s_old) <= n <= self.n_samples:
            raise ValueError(
                f"session {sid!r}: grow target {n} must be in "
                f"[{s_old}, {self.n_samples}]")
        count = n if student else n - s_old
        if count == 0:
            return 0
        self._check_allocator(count)
        fresh = np.arange(self._next_row, self._next_row + count,
                          dtype=np.uint32)
        self._next_row += count
        if student:
            sess.rows = fresh
            if sess.state is not None:
                sess.state = [tuple(part.repeat_interleave(n, dim=0)
                                    for part in layer)
                              for layer in sess.state]
            sess.mode = "mc"
        else:
            sess.rows = np.concatenate([sess.rows, fresh])
            if sess.state is not None:
                sess.state = [tuple(torch.cat([part, part.new_zeros(
                    (count,) + tuple(part.shape[1:]))]) for part in layer)
                    for layer in sess.state]
        return count

    def attach(self, session: Session) -> Session:
        """Re-admit a previously evicted :class:`Session` (same draw)."""
        if session.sid in self._sessions:
            raise ValueError(f"session {session.sid!r} already admitted")
        if len(self._sessions) >= self.max_sessions:
            raise CapacityError(
                f"store full ({self.max_sessions} sessions); evict first")
        if session.seed != self.seed:
            raise ValueError(
                f"session {session.sid!r} was drawn under seed "
                f"{session.seed!r}, store uses {self.seed!r} — reattaching "
                "would silently change its masks")
        if int(session.rows.shape[0]) > self.n_samples:
            raise ValueError(
                f"session {session.sid!r} carries "
                f"{int(session.rows.shape[0])} MC chains, store ceiling is "
                f"{self.n_samples}")
        attached = {int(r) for r in session.rows}
        for live in self._sessions.values():
            if attached & {int(r) for r in live.rows}:
                raise ValueError(
                    f"session {session.sid!r} rows collide with live "
                    f"session {live.sid!r} — same (seed, rows) would "
                    "correlate their Bayesian draws")
        self._next_row = max(self._next_row,
                             max(_mcd.base_row(r) for r in attached) + 1)
        self._sessions[session.sid] = session
        return session

    def get(self, sid: str) -> Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise KeyError(f"unknown session {sid!r} (admitted: "
                           f"{sorted(self._sessions)})") from None

    def evict(self, sid: str) -> Session:
        """Remove a finished stream; returns it (final carry + coordinates)."""
        self.get(sid)
        return self._sessions.pop(sid)

    @property
    def active(self) -> list[str]:
        return list(self._sessions)

    def sessions(self) -> list[Session]:
        """Live sessions in admission order (snapshot iteration order)."""
        return list(self._sessions.values())

    @property
    def active_chains(self) -> int:
        return sum(int(s.rows.shape[0]) for s in self._sessions.values())

    @property
    def next_row(self) -> int:
        return self._next_row

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, sid: str) -> bool:
        return sid in self._sessions
