"""The port's sharded recurrent stack (``launch.mesh``,
``launch.rnn_shardings``) against itself and against the JAX package.

The port of ``tests/test_rnn_sharding.py``, on meshes that list the CPU
device more than once (the counterpart of the reference's forced host
devices, which the suite's run does not set):

* ``run_stack(mesh=...)`` bit-equal to the unsharded run at 1, 2 and 8
  data shards, both cells, the three port backends; the ``"gspmd"``
  strategy (H over a ``model`` axis of 2, and of 4 at H = 32, where a
  slice's activations would take another vector path unsliced) bit-equal
  to the unsharded ``reference`` backend; chunked == unchunked through a
  mesh; the reference backend routed to gspmd; host numpy masks; ``mesh=``
  needs ``rows``; the policy; the specs, each the tuple of JAX's
  ``PartitionSpec`` for the same mesh sizes; the shard-pad floor.
* ``StreamingEngine`` on a mesh bit-equal to the unsharded engine over
  ragged ticks (dynamic and fixed shapes, both models); snapshots N -> 1
  -> N; slot padding that keeps whole sessions a shard.
* The fleet on a mesh equal to the fleet without; ``reconfigure_tenant``
  and ``apply_config`` to ``shards=2`` and back, bit-equal to a twin
  engine; ``launch.stream --shards 2 --device cpu``; the launch device
  guard (``kernels.common.launch_c`` runs the entry with the operands'
  card current).
* Against JAX: the port's 1-, 2- and 8-shard stacks and engines within
  ATOL of JAX's unsharded run and of JAX's ``make_data_mesh(1)`` run
  (JAX's ``reference`` backend); the integer ``TickMetrics`` fields and
  the snapshot manifest equal to JAX's at one shard.

The JAX work is small (B 7, T 5, H 8, NL 3 as in the reference's
``_stack``) and runs once, in module fixtures.
"""

import contextlib
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cells as jcells, classifier as jclf  # noqa: E402
from repro.core import mcd as jmcd, rnn as jrnn  # noqa: E402
from repro.launch import mesh as jmesh, rnn_shardings as jrs  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import classifier as tclf, mcd as tmcd  # noqa: E402
from repro_torch.core import rnn as trnn  # noqa: E402
from repro_torch.kernels import common as tcommon, ops as tops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import rnn_shardings as rs  # noqa: E402
from repro_torch.launch import stream as tlaunch  # noqa: E402
from repro_torch.serve import (FleetEngine, StreamingEngine,  # noqa: E402
                               TenantSpec, persistence, prewarm)
from repro_torch.serve import controller as tctl  # noqa: E402

DEVICE_COUNTS = (1, 2, 8)
CELLS = ("lstm", "gru")
BACKENDS = tops.LSTM_BACKENDS
ATOL = 1e-5         # the port's fp32 gate against JAX
B, T, H, NL = 7, 5, 8, 3
INT_FIELDS = ("tick", "capacity", "n_chunks", "live_rows", "batch_rows",
              "queue_depth", "live_steps", "live_chain_steps",
              "padded_steps", "shards", "dropped", "active_chains",
              "reclaimed_rows", "student_rows", "escalations")


def _mesh(n_data, model=1):
    return tmesh.make_data_mesh(n_data, model=model, device="cpu")


def _cfg(mod, seed=0):
    return mod.MCDConfig(p=0.125, placement="YNY", n_samples=2, seed=seed)


def _stack(cell, *, T=T, H=H, NL=NL):
    """Port weights, input, rows and ragged lengths (``_stack`` of the
    reference's test: B 7, T 5, H 8, NL 3)."""
    params = trnn.init_stack(torch.Generator().manual_seed(0), 1, (H,) * NL,
                             cell=cell, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, 1)).astype(np.float32))
    rows = torch.arange(B)
    lengths = torch.tensor([(i % T) + 1 for i in range(B)],
                           dtype=torch.int32)
    return params, x, rows, lengths


def _masks(cell, backend, rows, H=H, NL=NL):
    cfg = _cfg(tmcd)
    if backend == "reference":
        return trnn.sample_stack_masks(cfg, rows, 1, (H,) * NL, cell=cell)
    return trnn.stack_mask_plan(cfg, NL)


def _run(params, x, masks, cell, backend, rows, lengths=None, **kw):
    return trnn.run_stack(params, x, masks, 0.125, backend=backend,
                          rows=rows, seed=0, lengths=lengths,
                          return_all_states=True, cell=cell, device="cpu",
                          **kw)


def _same_tree(got, want):
    for la, lb in zip(got, want, strict=True):
        for a, b in zip(la, lb, strict=True):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)


def _same(got, want):
    assert torch.equal(got[0], want[0])
    _same_tree(got[1], want[1])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_dev", DEVICE_COUNTS)
@pytest.mark.parametrize("cell", CELLS)
def test_data_strategy_bit_identical(cell, n_dev, backend):
    params, x, rows, lengths = _stack(cell)
    masks = _masks(cell, backend, rows)
    want = _run(params, x, masks, cell, backend, rows, lengths)
    got = _run(params, x, masks, cell, backend, rows, lengths,
               mesh=_mesh(n_dev),
               policy=rs.StackShardingPolicy(strategy="data"))
    _same(got, want)


@pytest.mark.parametrize("n_dev", DEVICE_COUNTS)
@pytest.mark.parametrize("cell", CELLS)
def test_gspmd_strategy_bit_identical(cell, n_dev):
    """H over a model axis of 2, the masks of the kernel backend's plan
    drawn from (seed, layer, rows): the unsharded reference backend's
    bits, carries included."""
    params, x, rows, lengths = _stack(cell)
    want = _run(params, x, _masks(cell, "reference", rows), cell,
                "reference", rows, lengths)
    got = _run(params, x, _masks(cell, "cuda_seq", rows), cell, "cuda_seq",
               rows, lengths, mesh=_mesh(n_dev, 2),
               policy=rs.StackShardingPolicy(strategy="gspmd"))
    _same(got, want)


@pytest.mark.parametrize("cell", CELLS)
def test_gspmd_slices_keep_the_unsliced_activation_path(cell):
    """At H = 32 over 4 model entries each entry's 8 columns are evaluated
    at their columns of a full-width row (``common.rowwise``'s span): on
    an AVX-512 CPU a row of 32 runs PyTorch's vector loop and a row of 8
    its scalar loop, whose ``exp`` / ``tanh`` differ in the last bit."""
    params, x, rows, lengths = _stack(cell, H=32, NL=2)
    x = x * 3
    masks = _masks(cell, "reference", rows, H=32, NL=2)
    want = _run(params, x, masks, cell, "reference", rows, lengths)
    mesh = _mesh(2, 4)
    assert [sp.wh for sp in rs.stack_param_specs(
        params, mesh, strategy="gspmd")] == [(None, None, "model")] * 2
    _same(_run(params, x, masks, cell, "reference", rows, lengths,
               mesh=mesh), want)


@pytest.mark.parametrize("cell", CELLS)
def test_chunked_equals_unchunked_through_mesh(cell):
    params, x, rows, _ = _stack(cell, T=6)
    full = torch.full((B,), 6, dtype=torch.int32)
    masks = _masks(cell, "cuda_seq", rows)
    _, want = _run(params, x, masks, cell, "cuda_seq", rows, full)
    mesh = _mesh(8)
    _, s1 = _run(params, x[:, :3], masks, cell, "cuda_seq", rows,
                 torch.full((B,), 3, dtype=torch.int32), mesh=mesh)
    _, got = _run(params, x[:, 3:], masks, cell, "cuda_seq", rows, full - 3,
                  initial_state=s1, mesh=mesh)
    _same_tree(got, want)


def test_reference_backend_routes_to_gspmd():
    params, x, rows, lengths = _stack("lstm")
    mesh = _mesh(1)
    assert rs.resolve_strategy(mesh, rs.DEFAULT_POLICY, "reference",
                               [H]) == "gspmd"
    masks = _masks("lstm", "reference", rows)
    want = _run(params, x, masks, "lstm", "reference", rows, lengths)
    _same(_run(params, x, masks, "lstm", "reference", rows, lengths,
               mesh=mesh), want)


def test_host_numpy_masks_accepted():
    params, x, rows, lengths = _stack("lstm")
    masks = _masks("lstm", "reference", rows)
    host = [tuple(None if m is None else m.numpy() for m in pair)
            for pair in masks]
    want = _run(params, x, masks, "lstm", "reference", rows, lengths)
    for n_dev in (1, 2):
        _same(_run(params, x, host, "lstm", "reference", rows, lengths,
                   mesh=_mesh(n_dev)), want)


def test_mesh_requires_rows():
    params, x, _, lengths = _stack("lstm")
    with pytest.raises(ValueError, match="rows"):
        trnn.run_stack(params, x, trnn.stack_mask_plan(_cfg(tmcd), NL),
                       0.125, backend="cuda_seq", lengths=lengths,
                       device="cpu", mesh=_mesh(1))


def test_unsharded_lengths_are_made_up_and_contracts_kept():
    """Without ``lengths`` the sharded run passes full-T lengths; without
    ``return_all_states`` it keeps ``run_stack``'s last-layer contract
    (c in the input dtype on the kernel backends)."""
    params, x, rows, _ = _stack("lstm")
    masks = _masks("lstm", "cuda_seq", rows)
    full = torch.full((B,), T, dtype=torch.int32)
    for kw in ({}, {"return_sequence": False}):
        want = trnn.run_stack(params, x, masks, 0.125, backend="cuda_seq",
                              rows=rows, lengths=full, device="cpu", **kw)
        got = trnn.run_stack(params, x, masks, 0.125, backend="cuda_seq",
                             rows=rows, device="cpu", mesh=_mesh(2), **kw)
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            assert torch.equal(got[0], want[0])
        _same_tree([got[1]], [want[1]])


def test_mesh_device_must_be_its_home():
    params, x, rows, lengths = _stack("lstm")
    with pytest.raises(ValueError, match="first device"):
        tmesh_dev = tmesh.Mesh(["meta", "cpu"])
        trnn.run_stack(params, x, _masks("lstm", "cuda_seq", rows), 0.125,
                       backend="cuda_seq", rows=rows, device="cpu",
                       mesh=tmesh_dev)


def test_weights_placed_once_a_version():
    """gspmd's column slices are made once a (device, slice) and kept on
    the mesh until the weight changes in place."""
    params, x, rows, lengths = _stack("lstm")
    masks = _masks("lstm", "reference", rows)
    mesh = _mesh(1, 2)
    want = _run(params, x, masks, "lstm", "reference", rows, lengths,
                mesh=mesh)
    placed = {k: v[2] for k, v in mesh._placed.items()}
    assert len(placed) == 3 * NL * 2          # wx, wh, b; 2 slices a layer
    _run(params, x, masks, "lstm", "reference", rows, lengths, mesh=mesh)
    assert all(mesh._placed[k][2] is v for k, v in placed.items())
    params[0].wx.mul_(1.0)                    # an in-place write
    _same(_run(params, x, masks, "lstm", "reference", rows, lengths,
               mesh=mesh), want)
    assert sum(mesh._placed[k][2] is not v for k, v in placed.items()) == 2


# ---------------------------------------------------------------------------
# Policy, specs, meshes
# ---------------------------------------------------------------------------

def test_resolve_strategy():
    mesh = _mesh(1)
    po = rs.DEFAULT_POLICY
    assert rs.resolve_strategy(mesh, po, "reference", [8]) == "gspmd"
    assert rs.resolve_strategy(mesh, po, "cuda_seq", [8]) == "data"
    assert rs.resolve_strategy(mesh, po, "cuda_seq", [4096]) == "data"
    mesh2 = _mesh(1, 2)
    assert rs.resolve_strategy(mesh2, po, "cuda_seq", [4096]) == "gspmd"
    assert rs.resolve_strategy(mesh2, po, "cuda_step", [8]) == "data"
    forced = rs.StackShardingPolicy(strategy="gspmd")
    assert rs.resolve_strategy(mesh, forced, "cuda_seq", [8]) == "gspmd"
    with pytest.raises(ValueError, match="strategy"):
        rs.StackShardingPolicy(strategy="banana")
    assert rs.STRATEGIES == jrs.STRATEGIES
    assert rs.WIDE_H_DEFAULT == jrs.WIDE_H_DEFAULT
    assert dataclasses.asdict(rs.DEFAULT_POLICY) == dataclasses.asdict(
        jrs.DEFAULT_POLICY)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (4, 2), (8, 1)])
def test_specs_equal_jax_partition_specs(shape):
    """Each spec is the tuple of JAX's ``PartitionSpec`` for the same mesh
    sizes (JAX's builders read only ``axis_names`` and ``devices.shape``,
    so the port's mesh stands in for a JAX mesh of that shape): only the
    H output dim splits, only under gspmd, only where it divides."""
    mesh = _mesh(*shape)
    ms = shape[1]
    for cell in CELLS:
        for hiddens in ((8, 8), (7, 8)):
            params = trnn.init_stack(torch.Generator(), 1, hiddens,
                                     cell=cell, device="cpu")
            jparams = [(jcells.GRUParams if cell == "gru"
                        else jcells.LSTMParams)(
                *(jnp.asarray(t.numpy()) for t in lp)) for lp in params]
            for strategy in ("data", "gspmd"):
                got = rs.stack_param_specs(params, mesh, strategy=strategy)
                want = jrs.stack_param_specs(jparams, mesh,
                                             strategy=strategy)
                assert [tuple(tuple(s) for s in sp) for sp in want] == \
                    [tuple(sp) for sp in got]
                for sp, h in zip(got, hiddens):
                    split = strategy == "gspmd" and ms > 1 and h % ms == 0
                    assert sp.wh == (None, None, "model" if split else None)
                    assert sp.wh[1] is None    # never a contraction dim
        assert [tuple(tuple(p) for p in layer) for layer in jrs.carry_specs(
            NL, mesh, cell=cell)] == rs.carry_specs(NL, mesh, cell=cell)
    assert {k: tuple(v) for k, v in jrs.batch_specs(mesh).items()} == \
        rs.batch_specs(mesh)
    assert rs.data_axes(mesh) == jrs.data_axes(mesh) == ("data",)
    assert rs.data_size(mesh) == jrs.data_size(mesh) == shape[0]
    assert rs.model_size(mesh) == jrs.model_size(mesh) == shape[1]
    assert tmesh.axis_sizes(mesh) == jmesh.axis_sizes(mesh)
    assert tmesh.dp_axes(mesh) == jmesh.dp_axes(mesh)


def test_shard_pad_floor():
    assert rs._shard_pad(7, 1) == 0       # 1 device = exact unsharded run
    assert rs._shard_pad(7, 2) == 1       # even split
    assert rs._shard_pad(8, 8) == 8       # 2-row floor per shard
    assert rs._shard_pad(16, 8) == 0
    for b in range(1, 40):
        for n in (1, 2, 3, 4, 8):
            assert rs._shard_pad(b, n) == jrs._shard_pad(b, n)


def test_meshes_and_their_refusals(monkeypatch):
    assert _mesh(2, 2).device_list == [torch.device("cpu")] * 4
    host = tmesh.make_host_mesh()
    assert tmesh.axis_sizes(host) == {"data": 1, "model": 1}
    pod = tmesh.Mesh(["cpu"] * 8, ("pod", "data", "model"), (2, 2, 2))
    assert tmesh.dp_axes(pod) == ("pod", "data")
    assert rs.data_size(pod) == 4 and rs.model_size(pod) == 2
    assert [len(r) for r in rs.shard_devices(pod)] == [2] * 4
    listed = tmesh.make_data_mesh(2, devices=["cpu", "cpu"])
    assert listed.shape == (2, 1)
    with pytest.raises(ValueError, match="needs 4"):
        tmesh.make_data_mesh(2, model=2, devices=["cpu"] * 3)
    # The pod meshes (the planning stack's): the reference's 16 x 16 and
    # 2 x 16 x 16 grids over one abstract device.
    pod1, pod2 = (tmesh.make_production_mesh(multi_pod=m)
                  for m in (False, True))
    assert (pod1.shape, pod1.axis_names) == ((16, 16), ("data", "model"))
    assert (pod2.shape, pod2.axis_names) == ((2, 16, 16),
                                             ("pod", "data", "model"))
    assert {str(d) for d in pod2.device_list} == {"meta"}
    assert tmesh.dp_axes(pod2) == ("pod", "data") and pod2.size == 512
    # A CUDA mesh takes that many cards and never shrinks to what there is.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_data_mesh(2, device="cuda:0")
    assert tmesh.make_data_mesh(1, device="cuda:0").home == \
        torch.device("cuda", 0)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.data_mesh_like(2, device="cuda:0")
    assert tmesh.data_mesh_like(3, mesh=_mesh(2)).device_list == \
        [torch.device("cpu")] * 3


def test_launch_runs_under_the_operands_card(monkeypatch):
    """``launch_c`` calls the kernel's entry with the operands' card made
    current (a ``<<<>>>`` launch goes to the current device); no run has
    two cards, so the guard is checked here by recording it."""
    entered, calls = [], []

    @contextlib.contextmanager
    def guard(device):
        entered.append(torch.device(device))
        yield
        entered.append(None)

    def entry(*args):
        calls.append(entered[-1])
        return 0

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(tcommon, "c_entry", lambda *a: entry)
    monkeypatch.setattr(tcommon, "stream", lambda dev: 0)

    def wrapper():
        pass

    wrapper.launches = 0
    tcommon.launch_c(wrapper, "lib", (), (), "test",
                     device=torch.device("cuda", 3))
    fake = types.SimpleNamespace(device=torch.device("cuda", 5),
                                 data_ptr=lambda: 0)
    tcommon.launch(wrapper, (fake,), (1,), [1, 2], 2, 0.0, "test")
    assert calls == [torch.device("cuda", 3), torch.device("cuda", 5)]
    assert entered[-1] is None and wrapper.launches == 2


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stacks():
    """JAX's reference backend on each cell: unsharded and on JAX's
    one-device ``make_data_mesh(1)`` (its gspmd path)."""
    out = {}
    for cell in CELLS:
        params, x, rows, lengths = _stack(cell)
        cls = jcells.GRUParams if cell == "gru" else jcells.LSTMParams
        jp = [cls(*(jnp.asarray(t.numpy()) for t in lp)) for lp in params]
        jrows = jnp.asarray(rows.numpy().astype(np.uint32))
        masks = jrnn.sample_stack_masks(_cfg(jmcd), jrows, 1, (H,) * NL,
                                        cell=cell)
        kw = dict(backend="reference", rows=jrows,
                  lengths=jnp.asarray(lengths.numpy()),
                  return_all_states=True, cell=cell)
        out[cell] = [jax.tree.map(np.asarray, jrnn.run_stack(
            jp, jnp.asarray(x.numpy()), masks, 0.125, mesh=mesh, **kw))
            for mesh in (None, jmesh.make_data_mesh(1))]
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sharded_stack_within_atol_of_jax(jax_stacks, cell, backend):
    params, x, rows, lengths = _stack(cell)
    masks = _masks(cell, backend, rows)
    for n_dev in DEVICE_COUNTS:
        out, states = _run(params, x, masks, cell, backend, rows, lengths,
                           mesh=_mesh(n_dev))
        for want_out, want_states in jax_stacks[cell]:
            _close(want_out, out)
            for lw, lg in zip(want_states, states, strict=True):
                for w, g in zip(lw, lg, strict=True):
                    _close(w, g)


def _clf_cfg(clf_mod, mcd_mod, cell="lstm", s=2):
    return clf_mod.ClassifierConfig(
        hidden=8, num_layers=2, cell=cell,
        mcd=mcd_mod.MCDConfig(p=0.125, placement="YN", n_samples=s, seed=3))


SIGS = {f"s{k}": np.random.default_rng(k).standard_normal(
    (16, 1)).astype(np.float32) for k in range(3)}
RAGGED = ((9, 4, 7), (3, 9, 1))      # chunk lengths a session a tick


def _serve(eng, to=lambda a: a):
    for sid in SIGS:
        eng.open_session(sid)
    ticks, pos = [], {sid: 0 for sid in SIGS}
    for lens in RAGGED:
        chunks = {}
        for (sid, sig), n in zip(SIGS.items(), lens):
            chunks[sid] = to(sig[pos[sid]:pos[sid] + n])
            pos[sid] += n
        ticks.append(eng.step(chunks))
    return ticks


@pytest.fixture(scope="module")
def jax_engines(tmp_path_factory):
    """The reference's sharded-engine scenario on JAX's reference backend,
    unsharded and on ``make_data_mesh(1)``: every tick's class
    probabilities, the metrics, and the mesh engine's snapshot meta."""
    jcfg = _clf_cfg(jclf, jmcd)
    jparams = jclf.init(jax.random.key(0), jcfg)
    out = {"params": jax.tree.map(np.asarray, jparams)}
    for name, mesh in (("plain", None), ("mesh1", jmesh.make_data_mesh(1))):
        eng = JaxEngine(jparams, jcfg, backend="reference", max_sessions=3,
                        mesh=mesh)
        ticks = _serve(eng, jnp.asarray)
        path = tmp_path_factory.mktemp(f"jax_{name}")
        eng.snapshot(str(path))
        out[name] = {
            "probs": [{sid: np.asarray(r.summary.probs)
                       for sid, r in res.items()} for res in ticks],
            "metrics": [{f: getattr(m, f) for f in INT_FIELDS}
                        for m in eng.metrics],
            "meta": persistence.load_snapshot_meta(str(path))}
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_engine_within_atol_of_jax(jax_engines, backend, tmp_path):
    tcfg = _clf_cfg(tclf, tmcd)
    tparams = bridge.from_numpy_params(jax_engines["params"], device="cpu")
    for n_dev in DEVICE_COUNTS:
        eng = StreamingEngine(tparams, tcfg, backend=backend,
                              max_sessions=3, mesh=_mesh(n_dev))
        ticks = _serve(eng)
        for name in ("plain", "mesh1"):
            for res, want in zip(ticks, jax_engines[name]["probs"],
                                 strict=True):
                for sid, probs in want.items():
                    _close(probs, res[sid].summary.probs)
        assert [m.shards for m in eng.metrics] == [n_dev] * len(RAGGED)
        if n_dev == 1:
            got = [{f: getattr(m, f) for f in INT_FIELDS}
                   for m in eng.metrics]
            assert got == jax_engines["plain"]["metrics"] == \
                jax_engines["mesh1"]["metrics"]
            eng.snapshot(str(tmp_path))
            meta = persistence.load_snapshot_meta(str(tmp_path))
            want = jax_engines["mesh1"]["meta"]
            meta["extra"]["backend"] = want["extra"]["backend"]
            assert meta == want
            assert meta["extra"]["data_shards"] == 1


# ---------------------------------------------------------------------------
# The engine, inside the port
# ---------------------------------------------------------------------------

def _port_engine(cell, mesh, *, s=2, max_sessions=3, backend="cuda_seq",
                 kind="classifier", **kw):
    if kind == "classifier":
        cfg = _clf_cfg(tclf, tmcd, cell, s)
        params = tclf.init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    else:
        cfg = tae.AutoencoderConfig(
            hidden=8, num_layers=2, cell=cell, heteroscedastic=True,
            mcd=tmcd.MCDConfig(p=0.125, placement="YNYN", n_samples=s,
                               seed=3))
        params = tae.init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    kw.setdefault("device", None if mesh is not None else "cpu")
    if kw.get("chunk_capacity") == "auto":
        kw.setdefault("ladder", (4, 9))
    return StreamingEngine(params, cfg, backend=backend,
                           max_sessions=max_sessions, mesh=mesh, **kw)


def _same_ticks(a, b):
    for ra, rb in zip(a, b, strict=True):
        assert ra.keys() == rb.keys()
        for sid in ra:
            for x, y in zip(ra[sid].summary, rb[sid].summary, strict=True):
                assert torch.equal(x, y)


def _same_carries(ea, eb, sids):
    for sid in sids:
        _same_tree(ea.store.get(sid).state, eb.store.get(sid).state)


@pytest.mark.parametrize("kind,cell,backend,capacity", [
    ("classifier", "lstm", "cuda_seq", None),
    ("classifier", "gru", "cuda_step", 9),
    ("classifier", "lstm", "reference", 9),
    ("autoencoder", "gru", "cuda_seq", "auto"),
    ("autoencoder", "lstm", "cuda_step", None)])
def test_mesh_engine_serves_bit_identically(kind, cell, backend, capacity):
    plain = _port_engine(cell, None, kind=kind, backend=backend,
                         chunk_capacity=capacity)
    want = _serve(plain)
    for n_dev in (1, 8):
        meshy = _port_engine(cell, _mesh(n_dev), kind=kind, backend=backend,
                             chunk_capacity=capacity)
        if capacity is not None:
            prewarm(meshy)
        _same_ticks(_serve(meshy), want)
        _same_carries(meshy, plain, SIGS)
        assert meshy.last_metrics.shards == n_dev
        assert meshy.last_metrics.batch_rows % (n_dev * 2) == 0
        assert sum(m.compiles for m in meshy.metrics) == 0
    assert plain.last_metrics.shards == 1


def test_snapshot_is_mesh_portable(tmp_path):
    """N shards -> snapshot -> 1 shard, and 1 -> N: every continuation
    bit-equal to the uninterrupted unsharded run; the manifest records
    the shard count."""
    sig = np.random.default_rng(9).standard_normal((12, 1)).astype(
        np.float32)
    base = _port_engine("lstm", None)
    base.open_session("p")
    base.step({"p": sig[:5]})
    want = base.step({"p": sig[5:]})["p"]
    for first, second, n_snap in ((_mesh(8), None, 8), (None, _mesh(8), 1),
                                  (_mesh(2), _mesh(8), 2)):
        path = tmp_path / f"snap{n_snap}_{second is None}"
        eng = _port_engine("lstm", first)
        eng.open_session("p")
        eng.step({"p": sig[:5]})
        eng.snapshot(str(path))
        assert persistence.load_snapshot_meta(str(path))["extra"][
            "data_shards"] == n_snap
        fresh = _port_engine("lstm", second)
        fresh.restore(str(path))
        got = fresh.step({"p": sig[5:]})["p"]
        assert torch.equal(got.summary.probs, want.summary.probs)
        assert got.steps_total == want.steps_total
        _same_carries(fresh, base, ["p"])


def test_slot_padding_keeps_whole_sessions_per_shard():
    meshy = _port_engine("lstm", _mesh(2), s=3, max_sessions=3,
                         chunk_capacity=6)
    plain = _port_engine("lstm", None, s=3, max_sessions=3,
                         chunk_capacity=6)
    sig = np.random.default_rng(2).standard_normal((6, 1)).astype(
        np.float32)
    for eng in (meshy, plain):
        eng.open_session("a")
        eng.step({"a": sig})
    m = meshy.last_metrics
    assert m.batch_rows % (2 * 3) == 0 and m.batch_rows == 12
    assert plain.last_metrics.batch_rows == 9
    _same_carries(meshy, plain, ["a"])
    # Sharded engines serve one S: a sub-ceiling admission is refused.
    with pytest.raises(ValueError, match="uniform"):
        meshy.open_session("b", n_samples=2)
    with pytest.raises(ValueError, match="uniform"):
        meshy.admit("c", n_samples=1)


def test_graphs_need_one_device():
    """A mesh naming only the engine's device keeps the tick steps; a
    mesh over other devices serves eagerly (a graph holds one card)."""
    one = _port_engine("lstm", _mesh(4), chunk_capacity=9)
    assert one._graphs == {}
    two = _port_engine("lstm", tmesh.Mesh(["cpu", "meta"]),
                       chunk_capacity=9)
    assert two._graphs is None


def test_fleet_on_a_mesh_equals_the_fleet_without():
    cfg = _clf_cfg(tclf, tmcd)
    params = tclf.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    gcfg = _clf_cfg(tclf, tmcd, "gru")
    gparams = tclf.init(torch.Generator().manual_seed(1), gcfg,
                        device="cpu")

    def fleet(mesh):
        return FleetEngine([
            TenantSpec(name="a", cfg=cfg, params=params, max_sessions=2,
                       chunk_capacity=9),
            TenantSpec(name="b", cfg=gcfg, params=gparams, max_sessions=2,
                       backend="cuda_step")],
            device="cpu" if mesh is None else None, mesh=mesh)

    runs = []
    for mesh in (None, _mesh(2)):
        f = fleet(mesh)
        for t in ("a", "b"):
            for sid in ("x", "y"):
                f.admit(t, sid)
        ticks = []
        for lens in ((9, 4), (3, 9)):
            ticks.append(f.step({t: {sid: SIGS[f"s{k}"][:n] for k, (sid, n)
                                     in enumerate(zip(("x", "y"), lens))}
                                 for t in ("a", "b")}))
        runs.append((f, ticks))
    (f0, t0), (f1, t1) = runs
    assert {g.engine._shards for g in f1.groups.values()} == {2}
    for ra, rb in zip(t0, t1, strict=True):
        for t in ra:
            for sid in ra[t]:
                for x, y in zip(ra[t][sid].summary, rb[t][sid].summary,
                                strict=True):
                    assert torch.equal(x, y)
    for t in ("a", "b"):
        for sa, sb in zip(f0.sessions_of(t), f1.sessions_of(t)):
            _same_tree(sa.state, sb.state)
    assert [m.shards for m in f1.metrics] == [2] * len(f1.metrics)


def _twin(params, cfg, sessions, mesh, **kw):
    """An engine built at the new config, fed the converted sessions."""
    eng = StreamingEngine(params, cfg, mesh=mesh,
                          device=None if mesh is not None else "cpu", **kw)
    part_dtypes = tctl.carry_dtypes(eng.cell, None, eng.backend)
    for s in sessions:
        eng.attach_session(tctl.convert_session(
            s, n_samples=eng.n_samples, part_dtypes=part_dtypes))
    return eng


def test_apply_config_to_two_shards_and_back_equals_a_twin():
    cfg = _clf_cfg(tclf, tmcd, s=4)
    params = tclf.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = StreamingEngine(params, cfg, backend="cuda_seq", max_sessions=2,
                          chunk_capacity=9, device="cpu")
    c = tctl.CoDesignController(eng, tctl.SLOPolicy(p95_tick_s=1.0))
    for sid in ("a", "b"):
        eng.open_session(sid)
    eng.step({"a": SIGS["s0"][:4], "b": SIGS["s1"][:6]})
    for shards, s in ((2, 2), (1, 2), (2, 2)):
        old = [dataclasses.replace(x) for x in c.engine.store.sessions()]
        new = c.apply_config(tctl.ServingConfig(n_samples=s, shards=shards))
        assert new._shards == shards and new.last_metrics is not None
        twin_cfg = dataclasses.replace(cfg, mcd=cfg.mcd.replace(n_samples=s))
        twin = _twin(params, twin_cfg, old,
                     _mesh(2) if shards > 1 else None, backend="cuda_seq",
                     max_sessions=2, chunk_capacity=9)
        chunks = {"a": SIGS["s2"][:5], "b": SIGS["s0"][:3]}
        _same_ticks([new.step(chunks)], [twin.step(chunks)])
        _same_carries(new, twin, ["a", "b"])
        assert new.last_metrics.shards == shards
        assert new.last_metrics.compiles == 0


def test_reconfigure_tenant_to_two_shards_and_back_equals_a_twin():
    cfg = _clf_cfg(tclf, tmcd, s=4)
    params = tclf.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    fleet = FleetEngine([TenantSpec(name="t", cfg=cfg, params=params,
                                    max_sessions=2, chunk_capacity=9),
                         TenantSpec(name="u", cfg=cfg, params=params,
                                    max_sessions=2, chunk_capacity=9)],
                        device="cpu")
    for t in ("t", "u"):
        fleet.admit(t, "a")
    fleet.step({"t": {"a": SIGS["s0"][:4]}, "u": {"a": SIGS["s1"][:4]}})
    for shards in (2, 1):
        old = [dataclasses.replace(x) for x in fleet.sessions_of("t")]
        eng = fleet.reconfigure_tenant(
            "t", tctl.ServingConfig(n_samples=2, shards=shards))
        assert eng._shards == shards
        twin_cfg = dataclasses.replace(cfg, mcd=cfg.mcd.replace(n_samples=2))
        twin = _twin(params, twin_cfg, old,
                     _mesh(2) if shards > 1 else None, backend="cuda_seq",
                     max_sessions=2, chunk_capacity=9)
        got = fleet.step({"t": {"a": SIGS["s2"][:5]}})
        want = twin.step({"t/a": SIGS["s2"][:5]})
        for x, y in zip(got["t"]["a"].summary, want["t/a"].summary,
                        strict=True):
            assert torch.equal(x, y)
        _same_tree(fleet.sessions_of("t")[0].state,
                   twin.store.get("t/a").state)


def test_stream_launcher_shards(capsys):
    agg = tlaunch.main(["--device", "cpu", "--sessions", "3",
                        "--samples", "2", "--beats", "1", "--chunk-len",
                        "70", "--ragged", "--shards", "2"])
    assert agg["ticks"] >= 2 and agg["launches"] == 0
    assert "sharding launches over 2 devices" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--shards", "2",
                      "--early-exit-threshold", "0.1"])
