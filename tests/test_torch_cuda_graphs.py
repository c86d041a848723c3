"""The captured serving steps on the card: the ECG tick graph of
``StreamingEngine`` and the decode graph of ``BayesianEngine``, each
against the same engine served eagerly (``graphs=False``).

Marked ``cuda``: each test skips (in a fixture, at run time) where there
is no GPU; run them on a GPU machine with
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda_graphs.py``.

* Every kernel backend and precision: the replayed tick gives the eager
  tick's carries and summaries bit for bit, with the same launches a
  tick; after ``prewarm`` no tick captures (``compiles == 0``).
* qwen3 as an encoder–decoder and as a VLM (REDUCED): the decode graph
  bit-equal to eager over two ``generate`` calls with other frames or
  patches, whose prefill refills the graph's static cross K/V.
* qwen3, mamba2, olmoe, deepseek and jamba (REDUCED; the MoE archs at a
  capacity that drops routes): the decode graph gives the eager decode's
  tokens, logits, entropy and mutual information bit for bit and the
  same launch counts, over two ``generate`` calls on one engine; the MoE
  FFN twice bitwise equal on the card, its routing integers the CPU's;
  jamba's decode graph, its experts widened one at a time, the same bits
  from two engines.
* The bf16 ``mcd_matmul`` on the tensor cores: a captured call replays
  bitwise equal to eager calls.
* Kill -> snapshot -> restore: an engine restored after prewarm replays
  the uninterrupted engine's bits with no capture; early exit through the
  tick graph leaves every stream it never touched bit-equal to an engine
  without it.
* Distilled students: co-batched student and MC ticks (escalations
  included) replayed from the graph equal eager, the students riding the
  same launches; an escalated session equals its attached MC twin; the
  AdamW step on the card within an ulp of the CPU.
* The fleet: group engines replaying their graphs equal the same fleet
  served eagerly, and every tenant equals an engine of its own holding
  its sessions on the same rows, bit for bit.
* The co-design controller: a swap's prewarmed engine captures nothing
  after it and equals the converted-attach twin bit for bit.
* A capture that fails raises, and leaves the launch counts as they were.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import autoencoder as ae  # noqa: E402
from repro_torch.core import classifier as clf, mcd  # noqa: E402
from repro_torch.kernels import (bernoulli_mask, decode_attn,  # noqa: E402
                                 mcd_lstm_seq, mcd_matmul, ssd_chunk)
from repro_torch.models import backbone  # noqa: E402
from repro_torch.serve import (StaticStep, StreamingEngine, prewarm,  # noqa: E402
                               summarize)
from repro_torch.serve.engine import BayesianEngine  # noqa: E402
from repro_torch.serve.stream import stack_launch_count  # noqa: E402

pytestmark = pytest.mark.cuda

S = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(model, cell, dev):
    if model == "classifier":
        cfg = clf.ClassifierConfig(
            hidden=8, num_layers=3, num_classes=4, cell=cell,
            mcd=mcd.MCDConfig(p=0.125, placement="YNY", n_samples=S,
                              seed=3))
        return cfg, clf.init(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    cfg = ae.AutoencoderConfig(
        input_dim=1, hidden=16, num_layers=2, cell=cell,
        heteroscedastic=True,
        mcd=mcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S, seed=3))
    return cfg, ae.init(torch.Generator().manual_seed(0), cfg, device=dev)


def _serve(eng, sigs, plan):
    sids = [f"s{k}" for k in range(len(sigs))]
    for sid in sids:
        eng.open_session(sid)
    out = []
    for lens in plan:
        out.append(eng.step({sid: sigs[k][eng.store.get(sid).steps:][
            :int(n)] for k, (sid, n) in enumerate(zip(sids, lens)) if n}))
    return out


@pytest.mark.parametrize("capacity", [12, "auto"])
@pytest.mark.parametrize("precision", [None, "bf16", "int8", "int4"])
@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
@pytest.mark.parametrize("model,cell", [("classifier", "lstm"),
                                        ("classifier", "gru"),
                                        ("autoencoder", "gru")])
def test_tick_graph_equals_eager(dev, model, cell, backend, precision,
                                 capacity):
    cfg, params = _model(model, cell, dev)
    rng = np.random.default_rng(0)
    sigs = [rng.standard_normal((48, 1)).astype(np.float32)
            for _ in range(5)]
    plan = rng.integers(0, 13, (6, 5))
    plan[0] = np.maximum(plan[0], 1)
    kw = dict(backend=backend, precision=precision, max_sessions=6,
              chunk_capacity=capacity, ladder=(4, 8, 12), device=dev)
    g = StreamingEngine(params, cfg, **kw)
    e = StreamingEngine(params, cfg, graphs=False, **kw)
    caps = prewarm(g)
    assert caps == ([4, 8, 12] if capacity == "auto" else [12])
    assert all(entry.step.graph is not None for entry in g._graphs.values())
    rg, re = _serve(g, sigs, plan), _serve(e, sigs, plan)
    for sid in g.active_sessions:
        for la, lb in zip(g.store.get(sid).state, e.store.get(sid).state,
                          strict=True):
            for a, b in zip(la, lb, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    for ta, tb in zip(rg, re, strict=True):
        for sid in ta:
            for a, b in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(a, b)
    assert [m.launches for m in g.metrics] == [m.launches for m in e.metrics]
    assert all(m.launches > 0 for m in g.metrics)
    assert summarize(g.metrics)["compiles"] == 0


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_wide_tick_graph_equals_eager(dev, cell, backend, precision):
    """A wide classifier (H = 2048, two layers: the sequence kernels'
    cluster path, the step kernels' split path) captured in the tick's
    graph replays the eager ticks bit for bit, with the same launches."""
    cfg = clf.ClassifierConfig(
        hidden=2048, num_layers=2, num_classes=4, cell=cell,
        mcd=mcd.MCDConfig(p=0.125, placement="YN", n_samples=2, seed=3))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(1)
    sigs = [rng.standard_normal((12, 1)).astype(np.float32)
            for _ in range(3)]
    plan = [[3, 2, 4], [4, 1, 3], [2, 5, 1]]
    kw = dict(backend=backend, precision=precision, max_sessions=4,
              chunk_capacity=6, device=dev)
    g = StreamingEngine(params, cfg, **kw)
    e = StreamingEngine(params, cfg, graphs=False, **kw)
    prewarm(g)
    rg, re = _serve(g, sigs, plan), _serve(e, sigs, plan)
    for sid in g.active_sessions:
        for la, lb in zip(g.store.get(sid).state, e.store.get(sid).state,
                          strict=True):
            for a, b in zip(la, lb, strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    for ta, tb in zip(rg, re, strict=True):
        for sid in ta:
            for a, b in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(a, b)
    assert [m.launches for m in g.metrics] == [m.launches for m in e.metrics]
    assert summarize(g.metrics)["compiles"] == 0


def test_first_tick_captures_and_counts_its_launches(dev):
    cfg, params = _model("classifier", "lstm", dev)
    eng = StreamingEngine(params, cfg, max_sessions=2, chunk_capacity=8,
                          device=dev)
    eng.open_session("a")
    x = np.ones((8, 1), np.float32)
    before = mcd_lstm_seq.mcd_lstm_seq.launches
    for n in (5, 8, 3):
        eng.step({"a": x[:n]})
    assert [m.compiles for m in eng.metrics] == [1, 0, 0]
    assert [m.launches for m in eng.metrics] == [cfg.num_layers] * 3
    assert mcd_lstm_seq.mcd_lstm_seq.launches - before == 3 * cfg.num_layers


_DECODE_ARCHS = [("qwen3-1.7b", 6), ("mamba2-370m", 40),
                 ("olmoe-1b-7b", 6), ("deepseek-v2-lite-16b", 6),
                 ("jamba-1.5-large-398b", 40)]


@pytest.mark.parametrize("arch,prompt_len", _DECODE_ARCHS)
def test_decode_graph_equals_eager(dev, arch, prompt_len):
    _decode_graph_check(dev, arch, prompt_len, torch.float32)


@pytest.mark.parametrize("arch,prompt_len", _DECODE_ARCHS)
def test_bf16_decode_graph_equals_eager(dev, arch, prompt_len):
    """At bf16: the graph captures the bf16 step (a bf16 KV cache, or a
    bf16 conv state beside the fp32 SSM state) and replays it bit for bit
    as eager, with fp32's launch counts."""
    counts = _decode_graph_check(dev, arch, prompt_len, torch.bfloat16)
    assert counts == _decode_graph_check(dev, arch, prompt_len,
                                         torch.float32)


def _decode_graph_check(dev, arch, prompt_len, dtype):
    """An engine's decode graph against the same engine served eagerly, at
    ``dtype``: tokens, logits, entropy and MI bitwise equal, the same
    launch counts (returned).  A MoE arch runs at capacity factor 0.5, so
    its decode steps drop routes inside the graph too."""
    cfg = configs.get_config(arch, reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=S))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=dtype)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (2, prompt_len))
    names = (bernoulli_mask.masked_activation, mcd_matmul.mcd_matmul,
             decode_attn.decode_attention, ssd_chunk.ssd_chunk_scan)
    kw = dict(max_len=prompt_len + 6, seed=1, device=dev)
    g = BayesianEngine(params, cfg, **kw)
    e = BayesianEngine(params, cfg, graphs=False, **kw)
    counts = []
    for eng in (e, g, g):
        for fn in names:
            fn.launches = 0
        res = eng.generate(prompts, 5, keep_logits=True)
        counts.append([fn.launches for fn in names])
        if eng is e:
            want = res
            continue
        for a, b in ((res.tokens, want.tokens), (res.logits, want.logits),
                     (res.predictive_entropy, want.predictive_entropy),
                     (res.mutual_information, want.mutual_information)):
            assert torch.equal(a, b)
    assert counts[0] == counts[1] == counts[2] and counts[0][0] > 0
    (entry,) = g._graphs.values()
    assert entry.step.graph is not None
    assert int(entry.state.pos) == prompt_len + 5
    cache = entry.state.caches[0][0][0]
    if arch == "mamba2-370m":
        assert (cache.conv.dtype, cache.ssm.dtype) == (dtype, torch.float32)
    else:
        assert cache[0].dtype == dtype
    if arch == "jamba-1.5-large-398b":     # (k, v) and Mamba states
        for state in entry.state.caches[0][0][1:]:
            assert (state.conv.dtype, state.ssm.dtype) == (dtype,
                                                           torch.float32)
    return counts[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_encdec_decode_graph_equals_eager(dev, family, dtype):
    """qwen3 REDUCED as an encoder–decoder (2 ``enc_attn.mlp`` encoder
    layers over 12 frames, 2 ``dec_attn.cross.mlp`` decoder layers) or a
    VLM (5 patches): one engine's decode graph against an eager engine
    over two ``generate`` calls with other frames (patches), bit for bit
    with the same launches: the second prefill refills the graph's
    static cross K/V."""
    from repro_torch.models.config import Stage
    base = configs.get_config("qwen3-1.7b", reduced=True)
    if family == "audio":
        cfg = base.replace(family="audio",
                           stages=(Stage(("dec_attn.cross.mlp",), 2),),
                           encoder_stages=(Stage(("enc_attn.mlp",), 2),),
                           encoder_seq=12)
        name, n = "frames", 12
    else:
        cfg = base.replace(family="vlm", num_patches=5)
        name, n = "patches", 5
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=S))
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=dtype)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6))
    requests = [{name: torch.as_tensor(rng.standard_normal(
        (2, n, cfg.d_model)), dtype=dtype, device=dev)} for _ in range(2)]
    kw = dict(max_len=6 + 5 + cfg.num_patches, seed=1, device=dev)
    g = BayesianEngine(params, cfg, **kw)
    e = BayesianEngine(params, cfg, graphs=False, **kw)
    names = (bernoulli_mask.masked_activation, mcd_matmul.mcd_matmul,
             decode_attn.decode_attention)
    logits = []
    for req in requests:
        runs, counts = [], []
        for eng in (e, g):
            for fn in names:
                fn.launches = 0
            runs.append(eng.generate(prompts, 5, keep_logits=True, **req))
            counts.append([fn.launches for fn in names])
        want, res = runs
        for a, b in ((res.tokens, want.tokens), (res.logits, want.logits),
                     (res.predictive_entropy, want.predictive_entropy),
                     (res.mutual_information, want.mutual_information)):
            assert torch.equal(a, b)
        assert counts[0] == counts[1] and counts[0][2] == 2 * 5
        logits.append(res.logits)
    assert not torch.equal(*logits)
    (entry,) = g._graphs.values()
    assert entry.step.graph is not None
    assert (entry.state.cross is None) == (family == "vlm")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jamba_decode_graph_is_deterministic(dev, dtype, monkeypatch):
    """jamba REDUCED (one period: attention, mamba and MoE blocks in one
    stage) with its bf16 experts widened one at a time
    (``moe.WIDEN_BYTES``, as at full width): two engines' decode graphs,
    each replayed over two ``generate`` calls, give the same tokens,
    logits, entropy and MI bit for bit, and the SSD scan and the decode
    attention both launch."""
    from repro_torch.models import moe
    cfg = configs.get_config("jamba-1.5-large-398b", reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=S))
    monkeypatch.setattr(moe, "WIDEN_BYTES", 1)
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=dtype)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    runs = []
    for _ in range(2):
        eng = BayesianEngine(params, cfg, max_len=46, seed=2, device=dev)
        for _ in range(2):
            ssd_chunk.ssd_chunk_scan.launches = 0
            decode_attn.decode_attention.launches = 0
            runs.append(eng.generate(prompts, 5, keep_logits=True))
            assert ssd_chunk.ssd_chunk_scan.launches == 7
            assert decode_attn.decode_attention.launches == 5
        assert len(eng._graphs) == 1
    for res in runs[1:]:
        for a, b in ((res.tokens, runs[0].tokens),
                     (res.logits, runs[0].logits),
                     (res.predictive_entropy, runs[0].predictive_entropy),
                     (res.mutual_information, runs[0].mutual_information)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_moe_forward_on_the_card_is_deterministic(dev, arch):
    """``moe_forward`` on the card at a dropping capacity: two calls
    bitwise equal (no float atomics in the combine), and the routing's
    integers (``_dispatch``: slots, counts) equal to the CPU's on the same
    inputs, the output within 1e-5 of it."""
    from repro_torch.models import layers, moe
    cfg = configs.get_config(arch, reduced=True)
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, mcfg,
                     torch.float32, "cpu")
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    ctx = layers.Ctx(mcd.sample_rows(2, 2, device=dev), 3, cfg.mcd)
    m = layers.site_mask(ctx, True, 1, layers.SITE_MLP)
    pc = moe.MoEParams(*(t if t is None or isinstance(t, tuple)
                         else t.to(dev) for t in p))
    if pc.shared is not None:
        pc = pc._replace(shared=type(pc.shared)(*(t.to(dev)
                                                  for t in pc.shared)))
    a = moe.moe_forward(pc, x.to(dev), mcfg, m, 0.1, "cuda")
    b = moe.moe_forward(pc, x.to(dev), mcfg, m, 0.1, "cuda")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cctx = layers.Ctx(mcd.sample_rows(2, 2), 3, cfg.mcd)
    want = moe.moe_forward(p, x, mcfg, layers.site_mask(
        cctx, True, 1, layers.SITE_MLP), 0.1, "cuda")
    assert (a[0].cpu() - want[0]).abs().max() <= 1e-5
    flat = x.reshape(-1, cfg.d_model)
    C = moe.capacity(flat.shape[0], mcfg)
    got = moe._dispatch(flat.to(dev), flat.to(dev), pc.router, mcfg, C)
    ref = moe._dispatch(flat, flat, p.router, mcfg, C)
    assert torch.equal(got[1].cpu(), ref[1])
    assert torch.equal(got[3].cpu(), ref[3])
    assert int((ref[3] - C).clamp(min=0).sum()) > 0       # routes dropped


@pytest.mark.parametrize("M", [64, 8192])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_mcd_matmul_tensor_cores_graph_replay_equals_eager(dev, M, out):
    """The bf16 product on the tensor cores captured in a CUDA graph (its
    TMA tensor maps baked into the graph's launch, its keep-bit scratch
    from the graph's pool) replays bitwise equal to eager calls on new x
    values copied into the captured input, at the decode and the prefill
    tile."""
    K, N = 2048, 12288
    assert mcd_matmul.matmul_plan(M, N, K, 2)["path"] == "tensor_cores"
    g = torch.Generator(device=dev).manual_seed(M)
    w = (torch.randn((K, N), generator=g, device=dev)
         * K ** -0.5).bfloat16()
    rows = torch.arange(M, dtype=torch.int64)
    rows[5::16] |= 1 << 31                       # masked like any other row
    rows = rows.to(torch.int32).to(dev)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # build and warm up
        mcd_matmul.mcd_matmul(x, w, rows, 7, 0.1, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = mcd_matmul.mcd_matmul(x, w, rows, 7, 0.1, out)
    before = mcd_matmul.mcd_matmul.launches
    for _ in range(2):
        x.copy_(torch.randn((M, K), generator=g, device=dev).bfloat16())
        graph.replay()
        want = mcd_matmul.mcd_matmul(x, w, rows, 7, 0.1, out)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert mcd_matmul.mcd_matmul.launches == before + 2     # eager calls


@pytest.mark.parametrize("model,cell,backend,precision", [
    ("classifier", "lstm", "cuda_seq", None),
    ("classifier", "gru", "cuda_step", "bf16"),
    ("autoencoder", "gru", "cuda_seq", "int4"),
    ("classifier", "lstm", "cuda_step", "int8")])
def test_kill_restore_graph_bit_identical(dev, model, cell, backend,
                                          precision, tmp_path):
    """Kill -> snapshot -> restore on the card: the tick graphs of an
    engine restored after prewarm (another capacity policy) give the
    uninterrupted engine's carries and summaries bit for bit, with the
    same launches a tick and no capture."""
    cfg, params = _model(model, cell, dev)
    rng = np.random.default_rng(1)
    sigs = [rng.standard_normal((48, 1)).astype(np.float32)
            for _ in range(4)]
    plan = rng.integers(1, 13, (6, 4))
    kw = dict(backend=backend, precision=precision, max_sessions=5,
              ladder=(4, 8, 12), device=dev)
    gold = StreamingEngine(params, cfg, chunk_capacity=12, **kw)
    victim = StreamingEngine(params, cfg, chunk_capacity=12, **kw)
    want = _serve(gold, sigs, plan)
    _serve(victim, sigs, plan[:3])
    victim.snapshot(str(tmp_path))
    del victim
    revived = StreamingEngine(params, cfg, chunk_capacity="auto", **kw)
    prewarm(revived)
    revived.restore(str(tmp_path))
    assert revived.tick == 3
    got = [revived.step({sid: sigs[k][revived.store.get(sid).steps:][
        :int(n)] for k, (sid, n) in enumerate(zip(sorted(
            revived.active_sessions), lens))}) for lens in plan[3:]]
    for ta, tb in zip(got, want[3:], strict=True):
        for sid in tb:
            for a, b in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(a, b)
    for sid in gold.active_sessions:
        for la, lb in zip(revived.store.get(sid).state,
                          gold.store.get(sid).state, strict=True):
            for a, b in zip(la, lb, strict=True):
                assert a.device == b.device and a.dtype == b.dtype
                assert torch.equal(a, b)
    assert [m.launches for m in revived.metrics] == \
        [m.launches for m in gold.metrics[3:]]
    assert summarize(revived.metrics)["compiles"] == 0


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_early_exit_on_the_graph_path(dev, backend, tmp_path):
    """Flat streams halve to the floor through the tick graph; every
    stream early exit never touched keeps the bits of an engine without
    early exit; a snapshot after the retirements restores each S."""
    cfg, params = _model("classifier", "lstm", dev)
    rng = np.random.default_rng(2)
    sigs = [rng.standard_normal((48, 1)).astype(np.float32) * (k % 2)
            for k in range(6)]                      # even streams flat
    plan = np.full((4, 6), 12)
    kw = dict(backend=backend, max_sessions=6, chunk_capacity=12,
              device=dev)
    ee = StreamingEngine(params, cfg, early_exit_threshold=0.0,
                         min_samples=1, **kw)
    off = StreamingEngine(params, cfg, **kw)
    got, want = _serve(ee, sigs, plan), _serve(off, sigs, plan)
    assert [m.reclaimed_rows for m in ee.metrics] == [6, 3, 0, 0]
    kept = [sid for sid in ee.active_sessions
            if ee.store.get(sid).rows.shape[0] == S]
    assert len(kept) == 3 and all(
        ee.store.get(f"s{k}").rows.shape[0] == 1 for k in (0, 2, 4))
    for ta, tb in zip(got, want, strict=True):
        for sid in kept:
            for a, b in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(a, b)
    for sid in kept:
        for la, lb in zip(ee.store.get(sid).state, off.store.get(sid).state):
            for a, b in zip(la, lb):
                assert torch.equal(a, b)
    ee.snapshot(str(tmp_path))
    back = StreamingEngine(params, cfg, early_exit_threshold=0.0, **kw)
    back.restore(str(tmp_path))
    assert {sid: back.store.get(sid).rows.shape[0]
            for sid in back.active_sessions} == \
        {sid: ee.store.get(sid).rows.shape[0] for sid in ee.active_sessions}


# -- distilled students on the card ------------------------------------------

def _students_serve(eng, sigs, plan, modes):
    """``_serve`` with per-session modes (``modes[k]``: "mc" | "student")."""
    sids = [f"s{k}" for k in range(len(sigs))]
    for sid, mode in zip(sids, modes):
        eng.open_session(sid, mode=mode)
    out = []
    for lens in plan:
        out.append(eng.step({sid: sigs[k][eng.store.get(sid).steps:][
            :int(n)] for k, (sid, n) in enumerate(zip(sids, lens)) if n}))
    return out


def _same_engines(a, b, ra, rb):
    for sid in a.active_sessions:
        assert a.store.get(sid).mode == b.store.get(sid).mode
        assert np.array_equal(a.store.get(sid).rows, b.store.get(sid).rows)
        for la, lb in zip(a.store.get(sid).state, b.store.get(sid).state,
                          strict=True):
            for x, y in zip(la, lb, strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y)
    for ta, tb in zip(ra, rb, strict=True):
        assert ta.keys() == tb.keys()
        for sid in ta:
            for x, y in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(x, y)


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
@pytest.mark.parametrize("model,cell", [("classifier", "lstm"),
                                        ("autoencoder", "gru")])
def test_students_tick_graph_equals_eager(dev, model, cell, backend,
                                          precision):
    """Student and MC sessions co-batched, escalations included: the
    replayed tick gives the eager tick's carries, summaries, modes and
    rows bit for bit, the same launches a tick (the students ride the
    layer launches: as many as an all-MC tick) and no capture after
    prewarm."""
    from repro_torch.core import distill
    cfg, params = _model(model, cell, dev)
    stu = distill.init_student(torch.Generator().manual_seed(1), cfg,
                               params, device=dev)
    rng = np.random.default_rng(3)
    sigs = [rng.standard_normal((48, 1)).astype(np.float32)
            for _ in range(6)]
    plan = rng.integers(1, 13, (5, 6))
    modes = ["mc", "student"] * 3
    kw = dict(backend=backend, precision=precision, max_sessions=6,
              chunk_capacity=12, student=stu, device=dev)
    # A threshold the untrained heads' predictions straddle on tick 0.
    probe = StreamingEngine(params, cfg, **kw)
    first = _students_serve(probe, sigs, plan[:1], modes)[0]
    field = 3 if model == "classifier" else 2
    u = sorted(float(first[f"s{k}"].summary[field].float().mean())
               for k in (1, 3, 5))
    kw["student_escalate_threshold"] = 0.5 * (u[0] + u[2])
    g = StreamingEngine(params, cfg, **kw)
    e = StreamingEngine(params, cfg, graphs=False, **kw)
    prewarm(g)
    rg = _students_serve(g, sigs, plan, modes)
    re = _students_serve(e, sigs, plan, modes)
    _same_engines(g, e, rg, re)
    assert [m.launches for m in g.metrics] == [m.launches for m in e.metrics]
    per_tick = (cfg.num_layers if model == "classifier"
                else 2 * cfg.num_layers)
    if backend == "cuda_seq":
        assert all(m.launches == per_tick for m in g.metrics)
    assert g.metrics[0].student_rows == 3
    assert 1 <= g.metrics[0].escalations <= 2
    assert summarize(g.metrics)["compiles"] == 0


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_escalation_equals_the_attached_twin_on_the_card(dev, backend):
    """Escalated on the graph path: from the next chunk bit-equal to an
    always-MC session attached with the regrown rows and carry."""
    import dataclasses
    from repro_torch.core import distill
    cfg, params = _model("classifier", "lstm", dev)
    stu = distill.init_student(torch.Generator().manual_seed(1), cfg,
                               params, device=dev)
    sig = np.random.default_rng(4).standard_normal((48, 1)).astype(
        np.float32)
    kw = dict(backend=backend, max_sessions=2, chunk_capacity=12,
              device=dev)
    esc = StreamingEngine(params, cfg, student=stu,
                          student_escalate_threshold=0.0, **kw)
    esc.open_session("p", mode="student")
    esc.step({"p": sig[:12]})
    sess = esc.store.get("p")
    assert esc.last_metrics.escalations == 1 and sess.mode == "mc"
    twin = StreamingEngine(params, cfg, **kw)
    twin.attach_session(dataclasses.replace(
        sess, rows=sess.rows.copy(),
        state=[tuple(p.clone() for p in layer) for layer in sess.state]))
    ra = [esc.step({"p": sig[12 * t:12 * (t + 1)]}) for t in (1, 2, 3)]
    rb = [twin.step({"p": sig[12 * t:12 * (t + 1)]}) for t in (1, 2, 3)]
    _same_engines(esc, twin, ra, rb)


def test_optimizer_step_on_cuda_within_an_ulp_of_the_cpu(dev, monkeypatch):
    """AdamW on the card against the CPU on the same inputs, five steps
    with warmup and clipping: the global norm within 2 ulps (per-leaf
    sums in another order); given the CPU's norm, params and moments
    within 1 ulp."""
    from repro_torch.core.linear import DenseParams
    from repro_torch.train import optimizer as opt
    rng = np.random.default_rng(0)

    def tree(scale=1.0):
        return {name: DenseParams(*(torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
            for shape in shapes)) for name, shapes in
            (("head", ((8, 4), (4,))), ("unc", ((8, 1), (1,))))}

    def ulps(a, b):
        a = a.detach().cpu().double().numpy()
        b = b.detach().cpu().float().numpy()
        return float(np.max(np.abs(a - b) / np.abs(np.spacing(b))))

    from repro_torch.ckpt.checkpoint import tree_leaves, tree_map
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=3, clip_norm=0.5)
    cpu = tree()
    gpu = tree_map(lambda t: t.to(dev), cpu)
    sc, sg = opt.init(cpu), opt.init(gpu)
    real_norm = opt.global_norm
    for _ in range(5):
        grads = tree(2.0)
        norm = real_norm(grads)
        assert ulps(real_norm(tree_map(lambda t: t.to(dev), grads)),
                    norm) <= 2
        monkeypatch.setattr(opt, "global_norm", lambda t, n=norm: n.to(
            tree_leaves(t)[0].device))
        cpu, sc, mc = opt.apply(cfg, cpu, grads, sc)
        gpu, sg, mg = opt.apply(cfg, gpu, tree_map(lambda t: t.to(dev),
                                                   grads), sg)
        monkeypatch.setattr(opt, "global_norm", real_norm)
        assert float(mc["grad_norm"]) > cfg.clip_norm
        for a, b in zip(tree_leaves((gpu, sg.m, sg.v)),
                        tree_leaves((cpu, sc.m, sc.v)), strict=True):
            assert a.device.type == dev.type and ulps(a, b) <= 1


def _fleet(dev, backend, graphs=True):
    """``ward`` (classifier LSTM, S 4) and ``lite`` (the same params, S 2)
    in one group, ``anom`` (autoencoder GRU at bf16) in another."""
    from repro_torch.serve import FleetEngine, TenantSpec
    cfg, params = _model("classifier", "lstm", dev)
    acfg, aparams = _model("autoencoder", "gru", dev)
    kw = dict(backend=backend, chunk_capacity=12)
    fleet = FleetEngine([
        TenantSpec(name="ward", cfg=cfg, params=params, max_sessions=3,
                   **kw),
        TenantSpec(name="lite", cfg=cfg, params=params, n_samples=2,
                   max_sessions=2, **kw),
        TenantSpec(name="anom", cfg=acfg, params=aparams, precision="bf16",
                   max_sessions=2, **kw)], device=dev, graphs=graphs)
    if graphs:
        for g in fleet.groups.values():
            prewarm(g.engine)
    sids = {"ward": ["a", "b", "c"], "lite": ["a", "b"], "anom": ["a", "b"]}
    for tenant, ss in sids.items():
        for sid in ss:
            fleet.admit(tenant, sid)
    return fleet, sids


def _fleet_ticks(fleet, sids):
    rng = np.random.default_rng(4)
    sigs = {key: rng.standard_normal((48, 1)).astype(np.float32)
            for key in ((t, s) for t, ss in sids.items() for s in ss)}
    out = []
    for t in range(4):
        chunks = {}
        for k, (tenant, sid) in enumerate(sigs):
            if (t + k) % 3 == 2:
                continue                           # sits out this tick
            at = fleet.group_of(tenant).engine.store.get(
                f"{tenant}/{sid}").steps
            chunks.setdefault(tenant, {})[sid] = sigs[tenant, sid][
                at:at + int(rng.integers(1, 13))]
        out.append((chunks, fleet.step(chunks)))
    return out


def _same_session(a, b):
    assert np.array_equal(a.rows, b.rows)
    for la, lb in zip(a.state, b.state, strict=True):
        for x, y in zip(la, lb, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_fleet_graph_tick_equals_eager(dev, backend):
    """A fleet whose group engines replay their tick graphs against the
    same fleet served eagerly: summaries and carries bit for bit, the
    same launches a group tick, no capture after prewarm."""
    fg, sids = _fleet(dev, backend)
    fe, _ = _fleet(dev, backend, graphs=False)
    assert len(fg.groups) == 2
    for (_, rg), (_, re) in zip(_fleet_ticks(fg, sids),
                                _fleet_ticks(fe, sids), strict=True):
        for tenant in re:
            for sid, r in re[tenant].items():
                for a, b in zip(rg[tenant][sid].summary, r.summary,
                                strict=True):
                    assert torch.equal(a, b)
    for tenant in sids:
        for sess in fe.sessions_of(tenant):
            _same_session(fg.group_of(tenant).engine.store.get(sess.sid),
                          sess)
    for name, g in fg.groups.items():
        assert [m.launches for m in g.engine.metrics] == \
            [m.launches for m in fe.groups[name].engine.metrics]
        assert summarize(g.engine.metrics)["compiles"] == 0
    assert {m.tenant for m in fg.metrics} == set(sids)


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_fleet_equals_solo_on_the_card(dev, backend):
    """Each tenant in the shared fleet tick against an engine of its own
    holding its sessions on the same rows: bit for bit."""
    from repro_torch.serve import Session
    fleet, sids = _fleet(dev, backend)
    solo = {}
    for tenant in sids:
        spec = fleet.specs[tenant]
        eng = StreamingEngine(spec.params, spec.resolved_cfg(),
                              backend=backend, max_sessions=spec.max_sessions,
                              chunk_capacity=12, precision=spec.precision,
                              device=dev)
        for sess in fleet.sessions_of(tenant):
            eng.attach_session(Session(sid=sess.sid, rows=sess.rows.copy(),
                                       seed=sess.seed))
        solo[tenant] = eng
    for chunks, got in _fleet_ticks(fleet, sids):
        for tenant, tchunks in chunks.items():
            want = solo[tenant].step({f"{tenant}/{s}": c
                                      for s, c in tchunks.items()})
            for sid in tchunks:
                for a, b in zip(got[tenant][sid].summary,
                                want[f"{tenant}/{sid}"].summary,
                                strict=True):
                    assert torch.equal(a, b)
    for tenant, eng in solo.items():
        for sess in fleet.sessions_of(tenant):
            _same_session(sess, eng.store.get(sess.sid))


@pytest.mark.parametrize("new", [dict(n_samples=2),
                                 dict(n_samples=S, precision="bf16")])
@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_controller_swap_on_the_card(dev, backend, new):
    """An attached controller's swap: the new engine, prewarmed by
    ``apply_config``, captures no graph on any tick after it, and its
    ticks equal a prewarmed engine at the new config fed the converted
    pre-swap sessions, bit for bit."""
    from repro_torch.serve.controller import (CoDesignController,
                                              ServingConfig, SLOPolicy,
                                              carry_dtypes, convert_session)
    cfg, params = _model("classifier", "lstm", dev)
    rng = np.random.default_rng(11)
    sigs = [rng.normal(size=(60, 1)).astype(np.float32) for _ in range(3)]
    sids = [f"s{k}" for k in range(3)]
    # pow2_ladder(12): the ladder a swap to chunk_capacity 12 keeps, so
    # the scheduler's window crosses the swap.
    eng = StreamingEngine(params, cfg, backend=backend, max_sessions=4,
                          chunk_capacity="auto", ladder=(8, 12),
                          device=dev)
    prewarm(eng)
    for sid in sids:
        eng.open_session(sid)
    plan = rng.integers(1, 13, size=(3, 3))
    for t in range(3):
        eng.step({sid: sigs[k][eng.store.get(sid).steps:][:plan[k, t]]
                  for k, sid in enumerate(sids)})
    ctrl = CoDesignController(eng, SLOPolicy(p95_tick_s=1.0))
    new = ServingConfig(chunk_capacity=12, **new)
    swapped = ctrl.apply_config(new)
    assert swapped.device == eng.device and swapped._graphs is not None
    assert swapped._scheduler.ladder == eng._scheduler.ladder
    assert all(e.step.ready and (dev.type != "cuda"
                                 or e.step.graph is not None)
               for e in swapped._graphs.values())
    twin = StreamingEngine(
        params, dataclasses.replace(cfg, mcd=cfg.mcd.replace(
            n_samples=new.n_samples)),
        backend=backend, max_sessions=4, chunk_capacity="auto",
        ladder=(8, 12), precision=new.precision, device=dev)
    prewarm(twin)
    twin._scheduler.load_state(eng._scheduler.state())
    dts = carry_dtypes("lstm", new.precision, backend)
    for sess in ctrl.last_swap["old_sessions"]:
        twin.attach_session(convert_session(sess, n_samples=new.n_samples,
                                            part_dtypes=dts))
    for t in range(3):
        chunks = {sid: sigs[k][swapped.store.get(sid).steps:][:4 + t]
                  for k, sid in enumerate(sids)}
        got, want = swapped.step(chunks), twin.step(chunks)
        for sid in sids:
            for a, b in zip(got[sid].summary, want[sid].summary,
                            strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
    post = [m for m in swapped.metrics if m.tick >= ctrl.last_swap["tick"]]
    assert len(post) == 3 and all(m.compiles == 0 for m in post)
    assert [m.launches for m in post] == \
        [m.launches for m in twin.metrics]
    for sid in sids:
        _same_session(swapped.store.get(sid), twin.store.get(sid))


def test_a_dead_engine_is_not_freed_during_a_capture(dev):
    """An engine with captured graphs is a reference cycle; dropped, the
    cyclic collector frees it whenever it next runs.  With the collector
    due at every allocation, another engine's captures must not free it
    mid-capture (a graph destroyed during a capture fails the capture)."""
    import gc
    cfg, params = _model("classifier", "lstm", dev)
    dead = StreamingEngine(params, cfg, max_sessions=2, chunk_capacity=4,
                           device=dev)
    prewarm(dead)
    del dead
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng = StreamingEngine(params, cfg, max_sessions=2, chunk_capacity=8,
                              device=dev)
        prewarm(eng)
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    eng.open_session("a")
    eng.step({"a": np.ones((8, 1), np.float32)})
    assert eng.last_metrics.compiles == 0
    # The mechanism itself: the collector is off inside the capture only.
    seen = []
    x = torch.ones(4, device=dev)

    def fn():
        seen.append(gc.isenabled())
        return x * 2

    StaticStep(fn, dev).first()
    assert seen == [True, False] and gc.isenabled()


def test_a_failed_capture_raises(dev):
    """A step that reads a value on the host cannot be captured: the
    capture raises (nothing falls back to eager) and the launch counts
    stay as they were."""
    x = torch.ones(4, device=dev)
    cfg, params = _model("classifier", "lstm", dev)
    rows = torch.arange(2 * S, device=dev)
    xs = torch.zeros((2 * S, 4, 1), device=dev)

    def fn():
        out = clf.apply(params, xs, rows, cfg, backend="cuda_seq",
                        device=dev)
        return out * float(x.sum().item())

    before = stack_launch_count()
    step = StaticStep(fn, dev, counted=(mcd_lstm_seq.mcd_lstm_seq,))
    with pytest.raises(RuntimeError):
        step.first()
    torch.cuda.synchronize()
    assert stack_launch_count() == before + cfg.num_layers   # the warm-up
    assert not step.ready
