"""The sharded serving path on the card: ``StreamingEngine(mesh=...)`` and
``run_stack``'s gspmd strategy against the same work unsharded.

Marked ``cuda``: each test skips (in a fixture, at run time) where there
is no GPU; run them on a GPU machine with
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda_sharding.py``.

* A one-entry mesh serves the classifier LSTM on ``cuda_seq`` bit-equal to
  no mesh, through the tick graphs.
* A mesh listing the card 4 times (the card is one device; the mesh proves
  the partition and its launches there): the classifier LSTM and the
  autoencoder GRU on ``cuda_seq`` and the classifier GRU on ``cuda_step``
  bit-equal to the unsharded engine in summaries and carries, with
  ``TickMetrics.shards`` 4, ``batch_rows`` a multiple of 4 x S, the
  kernel launched layers x shards times a tick (x T on ``cuda_step``) and
  no capture after ``prewarm``.
* Where the machine has two cards or more, a mesh over real cards serves
  eagerly, bit-equal to no mesh.
* The gspmd strategy on a (2 data x 2 model) mesh of the card, at the
  classifier's widths, bit-equal to the unsharded ``reference`` backend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import autoencoder as ae  # noqa: E402
from repro_torch.core import classifier as clf, mcd, rnn  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import rnn_shardings as rs  # noqa: E402
from repro_torch.serve import StreamingEngine, prewarm  # noqa: E402

pytestmark = pytest.mark.cuda

S, SESSIONS, CAP, TICKS = 4, 8, 12, 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _model(model, cell, dev):
    if model == "classifier":
        cfg = clf.ClassifierConfig(
            hidden=8, num_layers=3, num_classes=4, cell=cell,
            mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S,
                              seed=3))
        return cfg, clf.init(torch.Generator().manual_seed(0), cfg,
                             device=dev), cfg.num_layers
    cfg = ae.AutoencoderConfig(
        input_dim=1, hidden=16, num_layers=2, cell=cell,
        heteroscedastic=True,
        mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S, seed=3))
    return (cfg, ae.init(torch.Generator().manual_seed(0), cfg, device=dev),
            2 * cfg.num_layers)


def _serve(params, cfg, dev, backend, mesh, graphs=True):
    eng = StreamingEngine(params, cfg, backend=backend,
                          max_sessions=SESSIONS, chunk_capacity=CAP,
                          device=dev, mesh=mesh, graphs=graphs)
    if graphs:
        prewarm(eng)
    rng = np.random.default_rng(4)
    sigs = rng.standard_normal((SESSIONS, CAP * TICKS, 1)).astype(
        np.float32)
    lens = rng.integers(1, CAP + 1, size=(TICKS, SESSIONS))
    sids = [f"s{k}" for k in range(SESSIONS)]
    for sid in sids:
        eng.open_session(sid)
    ticks = []
    for t in range(TICKS):
        ticks.append(eng.step({
            sid: sigs[k, eng.store.get(sid).steps:][:lens[t, k]]
            for k, sid in enumerate(sids)}))
    torch.cuda.synchronize()
    return eng, ticks, sids


def _same(a, b):
    ea, ta, sids = a
    eb, tb, _ = b
    for ra, rb in zip(ta, tb, strict=True):
        for sid in sids:
            for x, y in zip(ra[sid].summary, rb[sid].summary, strict=True):
                assert torch.equal(x, y)
    for sid in sids:
        for la, lb in zip(ea.store.get(sid).state, eb.store.get(sid).state,
                          strict=True):
            for x, y in zip(la, lb, strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_one_entry_mesh_equals_no_mesh(dev):
    cfg, params, _ = _model("classifier", "lstm", dev)
    plain = _serve(params, cfg, dev, "cuda_seq", None)
    one = _serve(params, cfg, dev, "cuda_seq",
                 tmesh.make_data_mesh(1, device=dev))
    _same(one, plain)
    assert [m.shards for m in one[0].metrics] == [1] * TICKS
    assert sum(m.compiles for m in one[0].metrics) == 0


@pytest.mark.parametrize("model,cell,backend", [
    ("classifier", "lstm", "cuda_seq"), ("autoencoder", "gru", "cuda_seq"),
    ("classifier", "gru", "cuda_step")])
def test_repeated_card_mesh_equals_no_mesh(dev, model, cell, backend):
    cfg, params, layers = _model(model, cell, dev)
    plain = _serve(params, cfg, dev, backend, None)
    mesh = tmesh.make_data_mesh(4, devices=[dev] * 4)
    four = _serve(params, cfg, dev, backend, mesh)
    _same(four, plain)
    eng = four[0]
    assert eng._graphs and all(e.step.graph is not None
                               for e in eng._graphs.values())
    for m, p in zip(eng.metrics, plain[0].metrics, strict=True):
        assert m.shards == 4 and m.batch_rows % (4 * S) == 0
        per_tick = layers * 4 * (1 if backend == "cuda_seq" else m.capacity)
        assert m.launches == per_tick == 4 * p.launches
        assert m.compiles == 0


def test_real_cards_mesh_equals_no_mesh(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, the machine has {n}")
    cfg, params, layers = _model("classifier", "lstm", dev)
    plain = _serve(params, cfg, dev, "cuda_seq", None)
    mesh = tmesh.make_data_mesh(min(n, 4), device=dev)
    cards = _serve(params, cfg, dev, "cuda_seq", mesh, graphs=False)
    _same(cards, plain)
    assert cards[0]._graphs is None
    assert all(m.launches == layers * mesh.size for m in cards[0].metrics)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_gspmd_on_the_card(dev, cell):
    B, T, H, NL = 16, 6, 8, 3
    params = rnn.init_stack(torch.Generator().manual_seed(0), 1, (H,) * NL,
                            cell=cell, device=dev)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((B, T, 1)).astype(
        np.float32)).to(dev)
    rows = torch.arange(B, device=dev)
    lengths = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(
        np.int32)).to(dev)
    cfg = mcd.MCDConfig(p=0.125, placement="YNY", seed=0)
    kw = dict(rows=rows, lengths=lengths, return_all_states=True, cell=cell,
              device=dev)
    want = rnn.run_stack(params, x, rnn.sample_stack_masks(
        cfg, rows, 1, (H,) * NL, cell=cell), cfg.p, backend="reference",
        **kw)
    mesh = tmesh.make_data_mesh(2, model=2, devices=[dev] * 4)
    got = rnn.run_stack(params, x, rnn.stack_mask_plan(cfg, NL), cfg.p,
                        backend="cuda_seq", mesh=mesh,
                        policy=rs.StackShardingPolicy(strategy="gspmd"),
                        **kw)
    assert torch.equal(got[0], want[0])
    for la, lb in zip(got[1], want[1], strict=True):
        for a, b in zip(la, lb, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
