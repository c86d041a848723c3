"""Durable session state: crash-safe snapshots of the streaming store —
port of ``repro.serve.persistence``.

A snapshot is a checkpoint in the reference's format
(:mod:`repro_torch.ckpt.checkpoint`), so either package restores what the
other wrote:

* arrays — each session's ``rows`` (host uint32) and per-layer carry
  parts (``(h, c)`` for an LSTM, ``(h,)`` for a GRU; bf16 h as the
  reference writes bf16) — go into the checkpoint tree, keyed by sid;
* everything structural — the allocator cursor, per-session step/chunk
  cursors, queue order/priorities, the engine's meta — rides as JSON
  ``meta`` in the same manifest, so arrays and bookkeeping commit in one
  ``os.replace``.

Restore is exact: masks are pure functions of ``(seed, rows)`` and are
recomputed in the kernels; carries round-trip bit for bit.  Carries are
written from the serving device and rebuilt on ``device`` (the engine's);
rows stay host numpy.  A queued re-attach (an evicted session waiting with
its carry) is state too, and so is a fresh ticket's chain count and mode.
Student sessions and tickets are restored as data: the engine decides
whether it can serve them.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.serve.admission import AdmissionQueue
from repro_torch.serve.sessions import Session, SessionStore

FORMAT_VERSION = 1

_KEY_RE = re.compile(r"[^\w.-]+")


def _tree_key(sid: str, used: set[str]) -> str:
    """A collision-free checkpoint key for a sid.

    Sids are free-form ('ward 3' and 'ward_3' may coexist) but leaf names
    are sanitized, so two sids could alias one leaf.  The key used is made
    unique here and recorded in the meta; restores address arrays by the
    recorded key, never by a re-derived name.
    """
    base = _KEY_RE.sub("_", sid).strip("_") or "sid"
    key, n = base, 1
    while key in used:
        key = f"{base}__{n}"
        n += 1
    used.add(key)
    return key


def _session_tree(sess: Session) -> dict:
    entry = {"rows": np.asarray(sess.rows, np.uint32)}
    if sess.state is not None:
        # Cell-agnostic: each layer's carry is a tuple of parts.
        entry["state"] = [list(layer) for layer in sess.state]
    return entry


def _session_meta(sess: Session) -> dict:
    meta = {"steps": int(sess.steps), "chunks": int(sess.chunks),
            "layers": None if sess.state is None else len(sess.state)}
    if sess.state is not None:
        meta["parts"] = len(sess.state[0])
    if sess.mode != "mc":
        # Written only off the default, as the reference writes it.
        meta["mode"] = sess.mode
    return meta


def _session_like(meta: dict) -> dict:
    like = {"rows": 0}
    if meta["layers"] is not None:
        parts = int(meta.get("parts", 2))   # pre-GRU snapshots: (h, c)
        like["state"] = [[0] * parts for _ in range(meta["layers"])]
    return like


def _rebuild_session(sid: str, meta: dict, arrays: dict, seed,
                     device) -> Session:
    state = None
    if meta["layers"] is not None:
        state = [tuple(ckpt.place(part, device) for part in layer)
                 for layer in arrays["state"]]
    return Session(sid=sid, rows=np.asarray(arrays["rows"], np.uint32),
                   seed=seed, state=state, steps=int(meta["steps"]),
                   chunks=int(meta["chunks"]), mode=meta.get("mode", "mc"))


def _store_tree_meta(store: SessionStore, used: set[str],
                     extra: dict | None = None) -> tuple[dict, dict]:
    """One store's checkpoint tree + structural meta (no queue, no save)."""
    tree: dict = {}
    meta: dict = {
        "format": FORMAT_VERSION,
        "n_samples": store.n_samples,
        "seed": store.seed,
        "max_sessions": store.max_sessions,
        "next_row": store.next_row,
        "sessions": {},
        "queue": [],
    }
    for sess in store.sessions():
        key = _tree_key(sess.sid, used)
        tree[key] = _session_tree(sess)
        meta["sessions"][sess.sid] = dict(_session_meta(sess), key=key)
    if extra is not None:
        meta["extra"] = extra
    return tree, meta


def _next_step(directory: str, step: int | None) -> int:
    if step is not None:
        return step
    latest = ckpt.latest_step(directory)
    return 0 if latest is None else latest + 1


def snapshot_store(directory: str, store: SessionStore, *,
                   step: int | None = None,
                   queue: AdmissionQueue | None = None,
                   extra: dict | None = None) -> str:
    """Atomically snapshot a store (and optionally its admission queue).

    ``step`` defaults to one past the latest snapshot in ``directory``
    (prune with ``ckpt.keep_last``).  ``extra`` is caller JSON riding in
    the manifest (the engine's meta).  Returns the snapshot path.
    """
    step = _next_step(directory, step)
    used: set[str] = set()
    tree, meta = _store_tree_meta(store, used, extra)
    if queue is not None:
        for ticket in queue.waiting():
            entry = {"sid": ticket.sid, "priority": ticket.priority,
                     "attached": ticket.session is not None}
            if ticket.n_samples is not None:
                entry["n_samples"] = int(ticket.n_samples)
            if ticket.mode is not None:
                entry["mode"] = ticket.mode
            if ticket.session is not None:
                key = _tree_key(ticket.sid, used)
                tree[key] = _session_tree(ticket.session)
                entry["session"] = dict(_session_meta(ticket.session),
                                        key=key)
            meta["queue"].append(entry)
    return ckpt.save(directory, step, tree, meta=meta)


def _resolve_step(directory: str, step: int | None) -> int:
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no snapshot under {directory!r}")
    return step


def load_snapshot_meta(directory: str, step: int | None = None) -> dict:
    """The snapshot's meta dict (resolving ``step=None`` to the latest)."""
    step = _resolve_step(directory, step)
    meta = ckpt.load_meta(directory, step)
    if meta is None or "sessions" not in meta:
        raise IOError(f"{directory!r} step {step} is not a session snapshot")
    if meta.get("format") != FORMAT_VERSION:
        raise IOError(f"snapshot format {meta.get('format')!r}, "
                      f"expected {FORMAT_VERSION}")
    meta["step"] = step
    return meta


def restore_store(directory: str, *, step: int | None = None,
                  sids: list[str] | None = None,
                  queue: AdmissionQueue | None = None,
                  max_sessions: int | None = None, device=None,
                  ) -> tuple[SessionStore, dict]:
    """Rebuild a :class:`SessionStore` from a snapshot, bit-identically.

    ``sids`` restores only a subset of the saved sessions — live, queued
    re-attach and fresh wait-list entries alike; the allocator cursor is
    restored either way, so unrestored sessions' rows are never re-drawn.
    ``queue``: an :class:`AdmissionQueue` to refill with the snapshotted
    wait-list (priorities and FIFO order kept; re-attach tickets get
    their sessions rebuilt).  ``device``: where the carries go (default
    CUDA; ``"cpu"`` when asked).  Returns ``(store, meta)``.
    """
    device = resolve_device(device)
    meta = load_snapshot_meta(directory, step)
    step = meta["step"]
    queued_attached = {e["sid"]: e for e in meta["queue"] if e["attached"]}
    queued_fresh = {e["sid"] for e in meta["queue"] if not e["attached"]}
    known = set(meta["sessions"]) | set(queued_attached) | queued_fresh
    want = known if sids is None else set(sids)
    if want - known:
        raise KeyError(f"snapshot has no session(s) {sorted(want - known)}")
    if queue is None and (lost := want - set(meta["sessions"])):
        raise ValueError(
            f"session(s) {sorted(lost)} are wait-list entries; pass queue= "
            "(or a sids= selection excluding them) — a restore must never "
            "silently drop a waiting stream")
    # Arrays are addressed by the snapshot's recorded keys, never by a
    # re-derived sid sanitization: aliasing sids never cross-contaminate.
    keys, like = {}, {}
    for sid in want - queued_fresh:
        smeta = (meta["sessions"].get(sid)
                 or queued_attached[sid]["session"])
        keys[sid] = smeta["key"]
        like[smeta["key"]] = _session_like(smeta)
    loaded = ckpt.restore(directory, step, like, partial=True) if like else {}
    arrays = {sid: loaded[key] for sid, key in keys.items()}

    # The cursor outlives the sessions: rows of unrestored streams stay
    # burned, so no later admission repeats a pre-crash Bayesian draw.
    store = SessionStore(meta["n_samples"], meta["seed"],
                         max_sessions=max_sessions or meta["max_sessions"],
                         first_row=int(meta["next_row"]))
    for sid, smeta in meta["sessions"].items():
        if sid not in want:
            continue
        store.attach(_rebuild_session(sid, smeta, arrays[sid], meta["seed"],
                                      device))
    if queue is not None:
        for entry in meta["queue"]:
            if entry["sid"] not in want:     # the sids filter selects the
                continue                     # wait-list too, both kinds
            sess = None
            if entry["attached"]:
                sess = _rebuild_session(entry["sid"], entry["session"],
                                        arrays[entry["sid"]], meta["seed"],
                                        device)
            queue.submit(entry["sid"], priority=entry["priority"],
                         session=sess, n_samples=entry.get("n_samples"),
                         mode=entry.get("mode"))
    return store, meta


# ---------------------------------------------------------------------------
# Fleet snapshots — every launch group under one atomic manifest
# ---------------------------------------------------------------------------

FLEET_FORMAT_VERSION = 1


def snapshot_fleet(directory: str, *, groups, tenants: dict, queue,
                   fair: dict, tick: int, step: int | None = None) -> str:
    """Atomically snapshot a whole fleet: N stores, one ``os.replace``.

    Args:
      groups: ``{group name: (SessionStore, engine meta dict)}``.
      tenants: JSON tenant table ``{name: {"group": ..., "weight": ...}}``.
      queue: the fleet's pending tickets (each with ``tenant``, ``sid``,
        ``priority``, ``session``, ``mode``); attached carries are
        serialized under their tenant's group.
      fair: the fairness ledger (JSON).
      tick: the fleet tick counter.
    """
    step = _next_step(directory, step)
    tree: dict = {}
    used_by_group: dict[str, set[str]] = {}
    meta: dict = {
        "fleet_format": FLEET_FORMAT_VERSION,
        "tick": int(tick),
        "tenants": dict(tenants),
        "fair": dict(fair),
        "groups": {},
        "queue": [],
    }
    for gname, (store, engine_meta) in groups.items():
        used = used_by_group.setdefault(gname, set())
        g_tree, g_meta = _store_tree_meta(store, used, engine_meta)
        tree[gname] = g_tree
        meta["groups"][gname] = g_meta
    for ticket in queue:
        tenant = ticket.tenant
        gname = tenants[tenant]["group"]
        entry = {"tenant": tenant, "sid": ticket.sid,
                 "priority": ticket.priority,
                 "attached": ticket.session is not None}
        if ticket.mode is not None:
            entry["mode"] = ticket.mode
        if ticket.session is not None:
            key = _tree_key(ticket.sid, used_by_group.setdefault(gname,
                                                                 set()))
            tree.setdefault(gname, {})[key] = _session_tree(ticket.session)
            entry["session"] = dict(_session_meta(ticket.session),
                                    key=key, group=gname)
        meta["queue"].append(entry)
    return ckpt.save(directory, step, tree, meta=meta)


def load_any_snapshot_meta(directory: str, step: int | None = None) -> dict:
    """Peek a snapshot's meta, fleet or single-engine layout alike
    (``"sessions"``: single engine; ``"groups"``: fleet)."""
    step = _resolve_step(directory, step)
    meta = ckpt.load_meta(directory, step)
    if meta is None or not ("sessions" in meta or "groups" in meta):
        raise IOError(f"{directory!r} step {step} is not a session or "
                      "fleet snapshot")
    meta["step"] = step
    return meta


def load_fleet_meta(directory: str, step: int | None = None) -> dict:
    """The fleet snapshot's meta dict (typed errors on the wrong layout)."""
    meta = load_any_snapshot_meta(directory, step)
    if "groups" not in meta:
        raise IOError(
            f"{directory!r} step {meta['step']} is a single-engine session "
            "snapshot, not a fleet snapshot — restore it through a "
            "one-tenant FleetEngine (or a StreamingEngine)")
    if meta.get("fleet_format") != FLEET_FORMAT_VERSION:
        raise IOError(f"fleet snapshot format {meta.get('fleet_format')!r}, "
                      f"expected {FLEET_FORMAT_VERSION}")
    for gname, g_meta in meta["groups"].items():
        if g_meta.get("format") != FORMAT_VERSION:
            raise IOError(f"group {gname!r} snapshot format "
                          f"{g_meta.get('format')!r}, "
                          f"expected {FORMAT_VERSION}")
    return meta


def restore_fleet(directory: str, step: int | None = None, *,
                  device=None) -> tuple[dict, dict]:
    """Rebuild every launch group's store from one fleet manifest.

    Returns ``(meta, {group name: (SessionStore, group meta)})``; queued
    re-attach carries are rebuilt onto their ``meta["queue"]`` entries as
    ``entry["session_obj"]`` (None for fresh wait-list entries).  Restores
    everything: partial restores are a single-engine feature.  Carries go
    to ``device`` (default CUDA).
    """
    device = resolve_device(device)
    meta = load_fleet_meta(directory, step)
    step = meta["step"]
    like: dict = {}
    for gname, g_meta in meta["groups"].items():
        g_like = {smeta["key"]: _session_like(smeta)
                  for smeta in g_meta["sessions"].values()}
        if g_like:
            like[gname] = g_like
    for entry in meta["queue"]:
        if entry["attached"]:
            smeta = entry["session"]
            like.setdefault(smeta["group"], {})[smeta["key"]] = \
                _session_like(smeta)
    loaded = ckpt.restore(directory, step, like, partial=True) if like else {}
    stores: dict = {}
    for gname, g_meta in meta["groups"].items():
        store = SessionStore(g_meta["n_samples"], g_meta["seed"],
                             max_sessions=g_meta["max_sessions"],
                             first_row=int(g_meta["next_row"]))
        for sid, smeta in g_meta["sessions"].items():
            store.attach(_rebuild_session(
                sid, smeta, loaded[gname][smeta["key"]], g_meta["seed"],
                device))
        stores[gname] = (store, g_meta)
    for entry in meta["queue"]:
        entry["session_obj"] = None
        if entry["attached"]:
            smeta = entry["session"]
            g_meta = meta["groups"][smeta["group"]]
            entry["session_obj"] = _rebuild_session(
                entry["sid"], smeta, loaded[smeta["group"]][smeta["key"]],
                g_meta["seed"], device)
    return meta, stores
