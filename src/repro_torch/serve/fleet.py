"""Multi-tenant fleet engine: heterogeneous Bayesian RNN workloads, one
tick — port of ``repro.serve.fleet``.

A monitoring fleet mixes models: LSTM ECG classifiers, GRU anomaly
autoencoders, cheap low-priority quantized tenants, each with its own S,
precision, priority and SLO.  A :class:`StreamingEngine` serves one
``(cell, task, H, S, precision)`` config; the fleet is the layer above:

* **Tenants** (:class:`TenantSpec`) declare a model config and params, a
  priority weight and a capacity.  Tenants that would run the same
  launches (the same params object, config, backend, precision, chunk
  policy, early-exit policy and student heads) fold into one **launch
  group**: one shared ``StreamingEngine`` whose tick batches the sessions
  of every member tenant into the same kernel launches.  S is not part of
  the signature: a group's chain ceiling is its largest member S, and a
  smaller tenant's sessions open at its own S.  A fleet tick is one engine
  tick a group with submissions, one after another.
* **Weighted-fair admission**: one bounded
  :class:`~repro_torch.serve.admission.WeightedFairQueue` for every
  tenant; with ``admit_per_tick`` set, each tick's admissions split by
  weight across the backlogged tenants.
* **Per-tenant metrics**: each tick emits one tenant-tagged
  :class:`~repro_torch.serve.scheduler.TickMetrics` a tenant that served
  (and a quiet one for a tenant with work waiting) into the fleet's sink;
  ``summarize()["tenants"]`` reads each tenant's own slice.
* **One atomic snapshot** of every group, the queue and the fairness
  ledger (``serve.persistence.snapshot_fleet``), restored bit-identically,
  in the reference's layout: either package restores the other's.

Each group engine is an unmodified ``StreamingEngine`` on its own CUDA
graphs, and a session's summaries and carries depend on its own rows only
(the kernels compute rows apart; the chain-axis reductions sum a session's
chains in an order fixed by its chain count), so a tenant served in a
shared fleet tick is bit-identical to the same sessions in an engine of
their own.

``device`` (the card unless ``"cpu"`` is asked for), ``graphs``,
``ladder`` and ``mesh`` / ``policy`` (``launch.rnn_shardings``) go to
every group engine.  On a mesh S stays in the launch-group signature:
sharded launches place whole sessions a shard, all at one S.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core import autoencoder as _ae, classifier as _clf
from repro_torch.core import rnn as _rnn
from repro_torch.serve import persistence as _persist
from repro_torch.serve.admission import (DrainRejected, FleetTicket,
                                         WeightedFairQueue)
from repro_torch.serve.controller import (carry_dtypes, convert_session,
                                          reshard_mesh)
from repro_torch.serve.scheduler import TickMetrics, summarize
from repro_torch.serve.sessions import Session
from repro_torch.serve.stream import (ChunkResult, MetricsSink,
                                      RingBufferSink, StreamingEngine)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the fleet: a model, its capacity and its priority.

    ``n_samples`` overrides ``cfg.mcd.n_samples``: the tenant's chain
    ceiling.  ``weight`` is its share of admissions under overload.
    ``max_sessions`` caps the tenant's live sessions even inside a shared
    launch group.  ``slo`` (an ``SLOPolicy``) is opaque to the engine: a
    ``FleetController`` reads it.  ``early_exit_threshold`` /
    ``min_samples`` and
    ``student`` / ``student_escalate_threshold`` are the engine's options
    of those names, part of the launch-group signature.
    """

    name: str
    cfg: Any                       # ClassifierConfig | AutoencoderConfig
    params: Any
    weight: float = 1.0
    n_samples: int | None = None
    precision: str | None = None
    backend: str = "cuda_seq"
    max_sessions: int = 64
    chunk_capacity: int | str | None = None
    slo: Any = None                # SLOPolicy, read by FleetController
    early_exit_threshold: float | None = None
    min_samples: int = 1
    student: Any = None
    student_escalate_threshold: float | None = None

    def __post_init__(self):
        if "/" in self.name:
            raise ValueError(f"tenant name {self.name!r} may not contain "
                             "'/' (reserved for fleet sid namespacing)")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name!r} weight must be > 0, "
                             f"got {self.weight}")
        if not isinstance(self.cfg, (_clf.ClassifierConfig,
                                     _ae.AutoencoderConfig)):
            raise TypeError(f"tenant {self.name!r}: unsupported config "
                            f"type {type(self.cfg).__name__}")

    def resolved_cfg(self):
        """The model config with the S override folded in."""
        if (self.n_samples is None
                or self.n_samples == self.cfg.mcd.n_samples):
            return self.cfg
        return dataclasses.replace(
            self.cfg, mcd=self.cfg.mcd.replace(n_samples=self.n_samples))


@dataclasses.dataclass
class _Group:
    """One launch group: a shared engine and the tenants folded into it."""

    name: str
    engine: StreamingEngine
    tenants: list[str]


class FleetEngine:
    """Serve heterogeneous tenants, one weighted-fair tick at a time.

    Args:
      tenants: the fleet's :class:`TenantSpec` table (names unique).
      max_pending: bound of the shared admission queue.
      aging_rounds: drain rounds after which a starved head-of-line ticket
        bypasses the weighted pick.
      admit_per_tick: the admissions a tick drains, split by weight (None:
        ``admit`` and ``close`` drain at once, and each tenant fills its
        own free rows).
      metrics_sink: where the tenant-tagged :class:`TickMetrics` go (each
        group engine keeps a small ring of its own).
      device: where every group serves (default CUDA; ``"cpu"`` runs the
        plain-PyTorch paths; ``mesh.home`` on a mesh).
      graphs, ladder, mesh, policy: forwarded to every group engine.

    Session ids are namespaced ``"tenant/sid"`` inside the groups; the
    public calls take (tenant, bare sid).
    """

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 max_pending: int = 256, aging_rounds: int = 16,
                 admit_per_tick: int | None = None,
                 metrics_window: int = 4096,
                 metrics_sink: MetricsSink | None = None,
                 device=None, mesh=None, policy=None, graphs: bool = True,
                 ladder=None):
        if not tenants:
            raise ValueError("a fleet needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self.device = _rnn.stack_device(device, mesh)
        self._graphs, self._ladder = graphs, ladder
        self._mesh, self._policy = mesh, policy
        self.specs: dict[str, TenantSpec] = {t.name: t for t in tenants}
        # Launch-group folding: the same weights object and the same
        # launches (the config with S set to 1, backend, precision, chunk
        # policy, early-exit policy, student heads) share one engine.  A
        # meshed fleet keeps S in the signature: sharded launches place
        # whole sessions a shard, all at one S.
        self.groups: dict[str, _Group] = {}
        self._tenant_group: dict[str, str] = {}
        self._group_seq = 0      # names never recycle: a reconfigured
        #                          tenant's new group must not take the
        #                          name of the one it empties
        by_sig: dict[tuple, list[TenantSpec]] = {}
        for spec in tenants:
            cfg = spec.resolved_cfg()
            cfg_key = cfg if mesh is not None else dataclasses.replace(
                cfg, mcd=cfg.mcd.replace(n_samples=1))
            sig = (id(spec.params), cfg_key, spec.backend,
                   spec.precision, spec.chunk_capacity,
                   spec.early_exit_threshold, spec.min_samples,
                   id(spec.student) if spec.student is not None else None,
                   spec.student_escalate_threshold)
            by_sig.setdefault(sig, []).append(spec)
        for members in by_sig.values():
            self._make_group([m.name for m in members])
        self.queue = WeightedFairQueue(
            {t.name: t.weight for t in tenants},
            max_pending=max_pending, aging_rounds=aging_rounds)
        self.admit_per_tick = admit_per_tick
        self.metrics_sink: MetricsSink = (metrics_sink
                                          or RingBufferSink(metrics_window))
        self.tick = 0
        self.dropped_admissions: list = []
        self._dropped_unreported: dict[str, int] = {n: 0 for n in names}

    def _resolved_s(self, tenant: str) -> int:
        """The tenant's chain ceiling (the spec's S override folded in)."""
        cfg = self.specs[tenant].resolved_cfg()
        return max(1, cfg.mcd.n_samples if cfg.mcd.any_bayesian else 1)

    def _engine(self, spec: TenantSpec, cfg, *, max_sessions: int,
                ceiling: int, **kw) -> StreamingEngine:
        kw.setdefault("mesh", self._mesh)
        return StreamingEngine(
            spec.params, cfg, backend=spec.backend,
            max_sessions=max_sessions, chunk_capacity=spec.chunk_capacity,
            ladder=self._ladder, metrics_sink=RingBufferSink(64),
            device=self.device, precision=spec.precision,
            early_exit_threshold=spec.early_exit_threshold,
            min_samples=min(spec.min_samples, ceiling),
            graphs=self._graphs, policy=self._policy, **kw)

    def _make_group(self, members: list[str],
                    engine: StreamingEngine | None = None) -> _Group:
        """Register a launch group for ``members`` (building its engine:
        its chain ceiling is the largest member S)."""
        gname = f"g{self._group_seq}"
        self._group_seq += 1
        if engine is None:
            lead = self.specs[members[0]]
            ceiling = max(self._resolved_s(m) for m in members)
            cfg = lead.resolved_cfg()
            if cfg.mcd.any_bayesian and cfg.mcd.n_samples != ceiling:
                cfg = dataclasses.replace(
                    cfg, mcd=cfg.mcd.replace(n_samples=ceiling))
            engine = self._engine(
                lead, cfg, ceiling=ceiling,
                max_sessions=sum(self.specs[m].max_sessions
                                 for m in members),
                student=lead.student,
                student_escalate_threshold=lead.student_escalate_threshold)
        group = _Group(name=gname, engine=engine, tenants=list(members))
        self.groups[gname] = group
        for m in members:
            self._tenant_group[m] = gname
        return group

    # -- addressing ----------------------------------------------------------
    def group_of(self, tenant: str) -> _Group:
        try:
            return self.groups[self._tenant_group[tenant]]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r} (fleet serves "
                           f"{sorted(self.specs)})") from None

    @staticmethod
    def _gsid(tenant: str, sid: str) -> str:
        return f"{tenant}/{sid}"

    def _live_count(self, tenant: str) -> int:
        prefix = tenant + "/"
        return sum(1 for sid in self.group_of(tenant).engine.store.active
                   if sid.startswith(prefix))

    def _has_room(self, tenant: str) -> bool:
        """Per-tenant admission eligibility (the drain's ``has_room``)."""
        return self._live_count(tenant) < self.specs[tenant].max_sessions

    # -- session lifecycle ---------------------------------------------------
    def admit(self, tenant: str, sid: str, *, priority: int = 0,
              session: Session | None = None,
              mode: str | None = None) -> Session | None:
        """Queue a stream for a tenant and, unless rate-limited, drain.

        Returns the live :class:`Session` if it went live in this drain,
        else None (queued; ``QueueFull`` beyond ``max_pending``).  With
        ``admit_per_tick`` set, submissions only queue and the budgeted
        drain runs at the next tick.  ``session`` re-attaches an evicted
        carry (its sid re-namespaced); ``mode="student"`` queues a
        distilled admission (the tenant's spec must carry heads).
        """
        engine = self.group_of(tenant).engine
        gsid = self._gsid(tenant, sid)
        if gsid in engine.store:
            raise ValueError(f"session {sid!r} already admitted "
                             f"for tenant {tenant!r}")
        if mode == "student" or (session is not None
                                 and session.mode == "student"):
            engine._check_student(gsid)
        if session is not None:
            if session.seed != engine.store.seed:
                raise ValueError(
                    f"session {sid!r} was drawn under seed "
                    f"{session.seed!r}, tenant {tenant!r} uses "
                    f"{engine.store.seed!r}")
            if int(session.rows.shape[0]) > self._resolved_s(tenant):
                raise ValueError(
                    f"session {sid!r} carries "
                    f"{int(session.rows.shape[0])} MC chains, tenant "
                    f"{tenant!r}'s ceiling is {self._resolved_s(tenant)}")
            if session.sid != gsid:
                session = dataclasses.replace(session, sid=gsid)
        self.queue.submit(tenant, gsid, priority=priority, session=session,
                          mode=mode)
        if self.admit_per_tick is not None:
            return None
        try:
            self.queue.drain(self._admit_ticket, self._has_room)
        except DrainRejected as err:
            # The caller's own ticket raises; others' rejects are recorded.
            mine = next((e for t, e in err.rejected if t.sid == gsid), None)
            self._record_drops([(t, e) for t, e in err.rejected
                                if t.sid != gsid])
            if mine is not None:
                raise mine from err
        store = engine.store
        return store.get(gsid) if gsid in store else None

    def close(self, tenant: str, sid: str) -> Session:
        """Evict a tenant's stream (the freed row feeds the queue); returns
        the final :class:`Session` with its bare sid, ready to re-admit."""
        sess = self.group_of(tenant).engine.store.evict(
            self._gsid(tenant, sid))
        if self.admit_per_tick is None:
            self._drain()
        return dataclasses.replace(sess, sid=sid)

    def _admit_ticket(self, ticket: FleetTicket) -> Session:
        """Route one drained ticket into its tenant's group: a fresh
        session opens at the tenant's ceiling (which may sit below the
        group's), a student ticket at one deterministic row."""
        store = self.group_of(ticket.tenant).engine.store
        if ticket.session is not None:
            return store.attach(ticket.session)
        if ticket.mode == "student":
            return store.admit(ticket.sid, mode="student")
        return store.admit(ticket.sid,
                           n_samples=self._resolved_s(ticket.tenant))

    def _record_drops(self, rejected: list) -> None:
        self.dropped_admissions.extend(rejected)
        del self.dropped_admissions[:-1024]
        for ticket, _ in rejected:
            self._dropped_unreported[ticket.tenant] += 1

    def _drain(self) -> list[FleetTicket]:
        """One weighted-fair drain; a rejected ticket is recorded against
        its tenant and serving goes on."""
        try:
            return self.queue.drain(self._admit_ticket, self._has_room,
                                    self.admit_per_tick)
        except DrainRejected as err:
            self._record_drops(err.rejected)
            return err.admitted

    def sessions_of(self, tenant: str) -> list[Session]:
        """A tenant's live sessions (namespaced sids), admission order."""
        prefix = tenant + "/"
        return [s for s in self.group_of(tenant).engine.store.sessions()
                if s.sid.startswith(prefix)]

    @property
    def active_sessions(self) -> dict[str, list[str]]:
        """tenant → live bare sids."""
        return {name: [s.sid[len(name) + 1:] for s in self.sessions_of(name)]
                for name in self.specs}

    @property
    def metrics(self) -> Sequence[TickMetrics]:
        return self.metrics_sink.window()

    def summarize(self) -> dict:
        return summarize(list(self.metrics))

    # -- serving -------------------------------------------------------------
    def step(self, chunks: Mapping[str, Mapping[str, Any]]
             ) -> dict[str, dict[str, ChunkResult]]:
        """One fleet tick: drain the shared queue, then one engine tick a
        group with submissions, one after another.

        ``chunks`` maps tenant → {bare sid → [t, input_dim] chunk}; every
        listed session must be live.  One tagged :class:`TickMetrics` a
        tenant that served lands in the fleet's sink (chain counts its
        sessions' own), and a quiet one for a tenant with queued or
        dropped work that served nothing.  Returns tenant → {bare sid →
        :class:`ChunkResult`}.
        """
        self._drain()
        waits = {name: self.queue.oldest_wait_s(name) for name in self.specs}
        by_group: dict[str, dict[str, Any]] = {}
        tenant_lens: dict[str, dict[str, int]] = {}
        for tenant, tchunks in chunks.items():
            group = self.group_of(tenant)          # raises on unknown tenant
            if not tchunks:
                continue
            gmap = by_group.setdefault(group.name, {})
            lens = tenant_lens.setdefault(tenant, {})
            for sid, chunk in tchunks.items():
                shape = getattr(chunk, "shape", None)
                if shape is None:
                    shape = np.shape(chunk)
                gsid = self._gsid(tenant, sid)
                lens[gsid] = shape[0] if len(shape) else 1
                gmap[gsid] = chunk

        results: dict[str, dict[str, ChunkResult]] = {
            t: {} for t in chunks if chunks[t]}
        group_metrics: dict[str, TickMetrics] = {}
        for gname, gmap in by_group.items():
            engine = self.groups[gname].engine
            res = engine.step(gmap)
            if engine.last_metrics is not None:
                group_metrics[gname] = engine.last_metrics
            for gsid, cr in res.items():
                tenant, sid = gsid.split("/", 1)
                results[tenant][sid] = dataclasses.replace(cr, sid=sid)

        for tenant, lens in tenant_lens.items():
            engine = self.group_of(tenant).engine
            gm = group_metrics.get(self._tenant_group[tenant])
            if gm is None:
                continue
            served = engine._last_served_chains
            chain_steps = sum(L * served.get(gsid, 0)
                              for gsid, L in lens.items())

            def mine(counts, lens=lens):
                return sum(n for gsid, n in counts.items() if gsid in lens)

            self.metrics_sink.emit(dataclasses.replace(
                gm, tick=self.tick, tenant=tenant,
                n_chunks=len(lens), live_rows=mine(served),
                live_steps=int(sum(lens.values())),
                live_chain_steps=chain_steps,
                tokens_per_sec=(chain_steps / gm.duration_s
                                if gm.duration_s > 0 else 0.0),
                queue_depth=self.queue.depth_of(tenant),
                queue_wait_s=waits[tenant],
                dropped=self._take_dropped(tenant),
                active_chains=self._active_chains(tenant),
                reclaimed_rows=mine(engine._last_reclaimed),
                student_rows=mine(engine._last_student_rows),
                escalations=mine(engine._last_escalated)))
        for tenant in self.specs:
            if tenant in tenant_lens:
                continue
            dropped = self._take_dropped(tenant)
            if not (dropped or self.queue.depth_of(tenant)):
                continue
            self.metrics_sink.emit(TickMetrics(
                tick=self.tick, capacity=0, n_chunks=0, live_rows=0,
                batch_rows=0, queue_depth=self.queue.depth_of(tenant),
                live_steps=0, live_chain_steps=0, padded_steps=0,
                pad_waste=0.0, duration_s=0.0, tokens_per_sec=0.0,
                queue_wait_s=waits[tenant], dropped=dropped,
                active_chains=self._active_chains(tenant),
                tenant=tenant))
        self.tick += 1
        return results

    def _active_chains(self, tenant: str) -> int:
        """Live MC chains across one tenant's sessions."""
        return sum(int(s.rows.shape[0]) for s in self.sessions_of(tenant))

    def _take_dropped(self, tenant: str) -> int:
        n, self._dropped_unreported[tenant] = \
            self._dropped_unreported[tenant], 0
        return n

    # -- reconfiguration (a fleet controller's apply path) -------------------
    def reconfigure_tenant(self, tenant: str, new) -> StreamingEngine:
        """Swap one tenant to a new serving config, sessions intact.

        ``new`` is a :class:`~repro_torch.serve.controller.ServingConfig`
        (or anything with ``n_samples`` / ``precision`` /
        ``chunk_capacity``).  The tenant's sessions are converted
        (``convert_session``: a downshift keeps the first S' chains
        bit-exactly, an upshift appends fresh rows) into a new group of
        its own; its former group-mates are untouched.  Both stores' row
        cursors advance past every row the transfer drew.  The new engine,
        as the reference's, takes no student heads, and has no captured
        graph yet: its first tick captures one
        (``FleetController`` prewarms it first).  ``new.shards`` (the
        tenant's engine's own count when ``new`` has none) sets its mesh:
        kept when unchanged, none at 1, else a data mesh of that many
        entries over the old engine's devices (:func:`~repro_torch.serve.
        controller.reshard_mesh`, which raises where there are too few).
        """
        spec = self.specs[tenant]
        old_ceiling = self._resolved_s(tenant)
        old_group = self.group_of(tenant)
        old_engine = old_group.engine
        # Before anything moves: a mesh that cannot be built leaves the
        # fleet as it was.
        mesh = reshard_mesh(old_engine, getattr(new, "shards",
                                                old_engine._shards))
        new_spec = dataclasses.replace(
            spec, n_samples=int(new.n_samples),
            precision=getattr(new, "precision", spec.precision),
            chunk_capacity=(getattr(new, "chunk_capacity", 0)
                            or spec.chunk_capacity))
        self.specs[tenant] = new_spec

        moved = self.sessions_of(tenant)
        for sess in moved:
            old_engine.store.evict(sess.sid)
        old_group.tenants.remove(tenant)

        new_ceiling = max(1, int(new.n_samples))
        engine = self._engine(new_spec, new_spec.resolved_cfg(),
                              max_sessions=new_spec.max_sessions,
                              ceiling=new_ceiling, mesh=mesh)
        cursor = old_engine.store.next_row
        part_dtypes = carry_dtypes(engine.cell, new_spec.precision,
                                   engine.backend)
        for sess in moved:
            extra = None
            s_i = int(sess.rows.shape[0])
            # A session at the old ceiling follows the new one; one early
            # exit already shrank keeps its smaller S (capped).
            target = (engine.n_samples if s_i == old_ceiling
                      else min(s_i, engine.n_samples))
            missing = target - s_i
            if missing > 0:
                extra = np.arange(cursor, cursor + missing, dtype=np.uint32)
                cursor += missing
            engine.store.attach(convert_session(
                sess, n_samples=target, part_dtypes=part_dtypes,
                extra_rows=extra))
        engine.store._next_row = max(engine.store.next_row, cursor)
        old_engine.store._next_row = max(old_engine.store.next_row, cursor)
        engine.tick = old_engine.tick
        group = self._make_group([tenant], engine=engine)
        if not old_group.tenants:
            del self.groups[old_group.name]
        return group.engine

    # -- durability ----------------------------------------------------------
    def snapshot(self, directory: str, *, step: int | None = None) -> str:
        """One atomic manifest of every tenant: each group's sessions and
        engine meta, the tenant table, the queue's tickets (attached
        carries too) and the fairness ledger, in one ``os.replace``."""
        groups = {g.name: (g.engine.store, g.engine._engine_meta())
                  for g in self.groups.values()}
        tenants = {
            name: {"group": self._tenant_group[name],
                   "weight": self.specs[name].weight,
                   "n_samples": self._resolved_s(name),
                   "precision": self.specs[name].precision,
                   "backend": self.specs[name].backend}
            for name in self.specs}
        return _persist.snapshot_fleet(
            directory, groups=groups, tenants=tenants,
            queue=self.queue.waiting(), fair=self.queue.state(),
            tick=self.tick, step=step)

    def restore(self, directory: str, *, step: int | None = None) -> dict:
        """Resume a whole fleet from one manifest (fresh fleet only).

        Takes a fleet snapshot (every tenant, the queue and the fairness
        ledger), or, into a one-tenant fleet, a single-engine snapshot
        whose sessions are adopted under the tenant's namespace.  Carries
        go to the fleet's device.  Returns the fleet meta.
        """
        for g in self.groups.values():
            if g.engine.store.sessions() or len(self.queue):
                raise RuntimeError("restore() needs a fresh fleet: live or "
                                   "queued sessions would collide")
        peek = _persist.load_any_snapshot_meta(directory, step)
        if "sessions" in peek:          # single-engine layout
            return self._restore_single(directory, step=peek["step"])
        meta, stores = _persist.restore_fleet(directory, step=peek["step"],
                                              device=self.device)
        snap_tenants = meta["tenants"]
        if set(snap_tenants) != set(self.specs):
            raise ValueError(
                f"fleet snapshot serves tenants "
                f"{sorted(snap_tenants)}, this fleet serves "
                f"{sorted(self.specs)}")
        # The snapshot's groups came from the same folding rule: other
        # membership means other specs.
        for name, t_meta in snap_tenants.items():
            mine = sorted(self.group_of(name).tenants)
            theirs = sorted(n for n, m in snap_tenants.items()
                            if m["group"] == t_meta["group"])
            if mine != theirs:
                raise ValueError(
                    f"tenant {name!r} shares a launch group with {theirs} "
                    f"in the snapshot but {mine} in this fleet — the specs "
                    "diverge")
        for gname_s, (store, g_meta) in stores.items():
            members = [n for n, m in snap_tenants.items()
                       if m["group"] == gname_s]
            group = self.group_of(members[0])
            engine_meta = group.engine._check_restore_meta(g_meta)
            store.max_sessions = group.engine.max_sessions
            group.engine._adopt(store, group.engine.queue, engine_meta)
        self.queue.load_state(meta.get("fair") or {})
        for entry in meta["queue"]:
            self.queue.submit(entry["tenant"], entry["sid"],
                              priority=entry["priority"],
                              session=entry.get("session_obj"),
                              mode=entry.get("mode"))
        self.tick = int(meta.get("tick", 0))
        return meta

    def _restore_single(self, directory: str, *, step: int) -> dict:
        """Adopt a single-engine snapshot as a one-tenant fleet."""
        if len(self.specs) != 1:
            raise ValueError(
                f"snapshot is a single-engine layout; this fleet serves "
                f"{len(self.specs)} tenants ({sorted(self.specs)}) — only "
                "a one-tenant fleet can adopt it")
        (tenant,) = self.specs
        engine = self.group_of(tenant).engine
        extra = engine.restore(directory, step=step)
        prefix = tenant + "/"
        for sess in list(engine.store.sessions()):
            if sess.sid.startswith(prefix):
                continue
            engine.store.evict(sess.sid)
            engine.store.attach(dataclasses.replace(
                sess, sid=self._gsid(tenant, sess.sid)))
        for ticket in engine.queue.waiting():
            engine.queue.cancel(ticket.sid)
            sess = ticket.session
            if sess is not None and not sess.sid.startswith(prefix):
                sess = dataclasses.replace(
                    sess, sid=self._gsid(tenant, sess.sid))
            self.queue.submit(tenant, self._gsid(tenant, ticket.sid),
                              priority=ticket.priority, session=sess,
                              mode=ticket.mode)
        self.tick = engine.tick
        return {"tenants": {tenant: {"group": self._tenant_group[tenant]}},
                "tick": self.tick, "extra": extra}

