"""The compiled-step counterpart: ``prewarm``, the tick-step runner of
``StreamingEngine`` and the decode-step runner of ``BayesianEngine``.

On the CPU a step runs on its static buffers without capture
(``serve.graphs.StaticStep``), so the buffer and aliasing logic of the
CUDA graphs is checked here:

* ``prewarm`` returns the capacities JAX's ``repro.serve.prewarm`` returns
  for the same engine (an ``"auto"`` ladder, a fixed capacity) and both
  reject a dynamic engine; after it, ragged ticks over both rungs add no
  step (``compiles == 0``), and ``summarize`` reports ``compiles``.
* The runner gives the eager engine's bits at fp32 and int8 (int4 on the
  autoencoder), LSTM and GRU, on both kernel backends; chunked ==
  unchunked and co-batched == alone still hold through it; a carry
  stored at tick 1 is unchanged by tick 2 (the step's outputs are
  overwritten in place, as a graph's).
* ``decode_step`` with the position on the device (an int32 scalar, never
  read on the host), run three steps as the engine's static step runs
  it, equals JAX's ``decode_step`` on REDUCED qwen3 and mamba2; the
  engine's decode runner equals its eager decode bit for bit.
* The stream launcher's ``--prewarm`` prints the capacities it warmed.

The card's captures are held to eager in ``test_torch_cuda_kernel.py``
(marker ``cuda``).  The JAX work is two tiny prewarms and one prefill with
three decode steps a model.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import classifier as jclf, mcd as jmcd  # noqa: E402
from repro.models import backbone as jbb, layers as jlayers  # noqa: E402
from repro.serve import StreamingEngine as JaxEngine  # noqa: E402
from repro.serve import prewarm as jax_prewarm  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.launch import stream as tstream  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.serve import (StaticStep, StreamingEngine, prewarm,  # noqa: E402
                               summarize)
from repro_torch.serve.engine import BayesianEngine  # noqa: E402
from repro_torch.serve.graphs import copy_into  # noqa: E402

ATOL = 1e-5
S, SEED = 3, 4


def _clf_cfg(cell="lstm", mod=tclf, mmod=tmcd):
    return mod.ClassifierConfig(
        hidden=8, num_layers=2, num_classes=4, cell=cell,
        mcd=mmod.MCDConfig(p=0.125, placement="YN", n_samples=S,
                           seed=SEED))


def _clf_params(cfg):
    return tclf.init(torch.Generator().manual_seed(0), cfg, device="cpu")


def _ae_cfg(cell="gru"):
    return tae.AutoencoderConfig(
        input_dim=1, hidden=8, num_layers=2, cell=cell, heteroscedastic=True,
        mcd=tmcd.MCDConfig(p=0.125, placement="YNYN", n_samples=S,
                           seed=SEED))


def _engine(params, cfg, **kw):
    kw.setdefault("max_sessions", 3)
    kw.setdefault("chunk_capacity", "auto")
    kw.setdefault("ladder", (4, 8))
    return StreamingEngine(params, cfg, device="cpu", **kw)


def _signals(n, length=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((length, 1)).astype(np.float32)
            for _ in range(n)]


# -- prewarm -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_caps():
    cfg = _clf_cfg(mod=jclf, mmod=jmcd)
    params = jclf.init(jax.random.key(0), cfg)
    auto = JaxEngine(params, cfg, backend="reference", max_sessions=2,
                     chunk_capacity="auto", ladder=(4, 8))
    fixed = JaxEngine(params, cfg, backend="reference", max_sessions=2,
                      chunk_capacity=6)
    with pytest.raises(ValueError, match="bounded"):
        jax_prewarm(JaxEngine(params, cfg, backend="reference",
                              max_sessions=2))
    return {"auto": jax_prewarm(auto), "fixed": jax_prewarm(fixed)}


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step", "reference"])
def test_prewarm_returns_the_reference_capacities(jax_caps, backend):
    cfg = _clf_cfg()
    params = _clf_params(cfg)
    auto = _engine(params, cfg, backend=backend, max_sessions=2)
    fixed = _engine(params, cfg, backend=backend, max_sessions=2,
                    chunk_capacity=6, ladder=None)
    assert prewarm(auto) == jax_caps["auto"] == [4, 8]
    assert prewarm(fixed) == jax_caps["fixed"] == [6]
    steps = 0 if backend == "reference" else 1
    assert len(auto._graphs or ()) == 2 * steps
    assert len(fixed._graphs or ()) == steps


def test_prewarm_rejects_a_dynamic_engine():
    cfg = _clf_cfg()
    eng = _engine(_clf_params(cfg), cfg, chunk_capacity=None, ladder=None)
    assert eng._graphs is None
    with pytest.raises(ValueError, match="bounded"):
        prewarm(eng)


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
def test_no_step_is_made_after_prewarm(backend):
    cfg = _clf_cfg()
    params = _clf_params(cfg)
    sig = _signals(2, 8)[0]
    eng = _engine(params, cfg, backend=backend, max_sessions=2)
    assert prewarm(eng) == [4, 8]
    warm = dict(eng._graphs)
    eng.open_session("a")
    eng.open_session("b")
    for a, b in ((3, 2), (8, 4), (1, 1), (5, 8)):    # both rungs, ragged
        eng.step({"a": sig[:a], "b": sig[:b]})
    assert eng._graphs == warm
    assert {m.capacity for m in eng.metrics} == {4, 8}
    assert [m.compiles for m in eng.metrics] == [0, 0, 0, 0]
    assert summarize(eng.metrics)["compiles"] == 0
    # Without prewarm each rung's step is made on the first tick that
    # needs it, and the tick says so.
    cold = _engine(params, cfg, backend=backend, max_sessions=2)
    cold.open_session("a")
    for n in (3, 8, 2, 7):
        cold.step({"a": sig[:n]})
    assert [m.compiles for m in cold.metrics] == [1, 1, 0, 0]
    assert summarize(cold.metrics)["compiles"] == 2
    assert set(cold.metrics[0].parts_s) == {"assemble", "to_device",
                                            "apply", "summaries", "store",
                                            "sync"}


# -- the tick-step runner against eager ------------------------------------

def _serve(eng, sigs, plan):
    """Open one session a signal, serve ``plan`` [ticks, sessions] chunk
    lengths; returns the results of every tick."""
    sids = [f"s{k}" for k in range(len(sigs))]
    for sid in sids:
        eng.open_session(sid)
    out = []
    for lens in plan:
        chunks = {sid: sigs[k][eng.store.get(sid).steps:][:int(n)]
                  for k, (sid, n) in enumerate(zip(sids, lens)) if n}
        out.append(eng.step(chunks))
    return out


def _assert_same_serving(a, ra, b, rb):
    for sid in a.active_sessions:
        for la, lb in zip(a.store.get(sid).state, b.store.get(sid).state,
                          strict=True):
            for x, y in zip(la, lb, strict=True):
                assert x.dtype == y.dtype and torch.equal(x, y)
    for ta, tb in zip(ra, rb, strict=True):
        assert ta.keys() == tb.keys()
        for sid in ta:
            for x, y in zip(ta[sid].summary, tb[sid].summary, strict=True):
                assert torch.equal(x, y)


CASES = [("classifier", "lstm", None), ("classifier", "lstm", "int8"),
         ("classifier", "gru", None), ("classifier", "gru", "int8"),
         ("autoencoder", "lstm", None), ("autoencoder", "gru", "int4")]


def _model(model, cell):
    if model == "classifier":
        cfg = _clf_cfg(cell)
        return cfg, _clf_params(cfg)
    cfg = _ae_cfg(cell)
    return cfg, tae.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")


@pytest.mark.parametrize("backend", ["cuda_seq", "cuda_step"])
@pytest.mark.parametrize("model,cell,precision", CASES)
def test_runner_equals_eager(model, cell, precision, backend):
    cfg, params = _model(model, cell)
    sigs = _signals(3)
    plan = np.random.default_rng(1).integers(0, 9, (5, 3))
    plan[0] = np.maximum(plan[0], 1)
    kw = dict(backend=backend, precision=precision)
    g = _engine(params, cfg, **kw)
    e = _engine(params, cfg, graphs=False, **kw)
    rg, re = _serve(g, sigs, plan), _serve(e, sigs, plan)
    assert e._graphs is None and len(g._graphs) >= 1
    _assert_same_serving(g, rg, e, re)
    assert [m.launches for m in g.metrics] == [m.launches for m in e.metrics]


@pytest.mark.parametrize("model,cell,precision", CASES[::3])
def test_chunked_equals_unchunked_through_the_runner(model, cell,
                                                     precision):
    """Sessions served in ragged chunks, co-batched, through the runner,
    against one session served whole and alone (also through it): the
    carries bit for bit."""
    cfg, params = _model(model, cell)
    sigs = _signals(3, 16, seed=2)
    plan = np.array([[5, 3, 8], [8, 8, 1], [3, 5, 7]])
    kw = dict(backend="cuda_seq", precision=precision, ladder=(4, 8, 16))
    chunked = _engine(params, cfg, **kw)
    _serve(chunked, sigs, plan)
    for k, sid in enumerate(chunked.active_sessions):
        alone = _engine(params, cfg, **kw)
        alone.admit(sid, session=dataclasses.replace(
            chunked.store.get(sid), state=None, steps=0, chunks=0))
        alone.step({sid: sigs[k]})
        for la, lb in zip(chunked.store.get(sid).state,
                          alone.store.get(sid).state, strict=True):
            for x, y in zip(la, lb, strict=True):
                assert torch.equal(x, y)


def test_a_stored_carry_survives_the_next_tick():
    """The aliasing check: the tick step's outputs are overwritten in
    place by the next tick, so the carry a session stored at tick 1 and
    the summaries tick 1 returned are copies, never views of them."""
    cfg = _clf_cfg()
    eng = _engine(_clf_params(cfg), cfg, chunk_capacity=8, ladder=None)
    sigs = _signals(2)
    eng.open_session("a")
    eng.open_session("b")
    r1 = eng.step({"a": sigs[0][:5], "b": sigs[1][:7]})
    stored = eng.store.get("a").state          # the tensors themselves
    kept = [tuple(p.clone() for p in layer) for layer in stored]
    summ = tuple(v.clone() for v in r1["a"].summary)
    (entry,) = eng._graphs.values()
    buffers = {p.untyped_storage().data_ptr()
               for layer in entry.step.outputs[1] for p in layer}
    eng.step({"a": sigs[0][5:13], "b": sigs[1][7:8]})
    for layer, want in zip(stored, kept, strict=True):
        for p, w in zip(layer, want, strict=True):
            assert torch.equal(p, w)
    for v, w in zip(r1["a"].summary, summ, strict=True):
        assert torch.equal(v, w)
    for layer in eng.store.get("a").state:
        for p in layer:
            assert p.untyped_storage().data_ptr() not in buffers


def test_a_carry_held_across_a_tick_is_unchanged():
    """A session that sits a tick out keeps the carry stored for it at
    tick 1 while the other session's tick 2 overwrites the step's
    buffers."""
    cfg = _clf_cfg("gru")
    eng = _engine(_clf_params(cfg), cfg, chunk_capacity=8, ladder=None)
    sigs = _signals(2)
    eng.open_session("a")
    eng.open_session("b")
    eng.step({"a": sigs[0][:5], "b": sigs[1][:7]})
    kept = [tuple(p.clone() for p in layer)
            for layer in eng.store.get("a").state]
    eng.step({"b": sigs[1][7:15]})
    for layer, want in zip(eng.store.get("a").state, kept, strict=True):
        for p, w in zip(layer, want, strict=True):
            assert torch.equal(p, w)


def test_static_step_on_the_cpu_overwrites_its_outputs():
    """The CPU stand-in of a graph: ``replay`` writes into the first run's
    outputs in place, as a replayed graph does; ``copy_into`` walks
    tuples, lists and None."""
    x = torch.zeros(3)
    step = StaticStep(lambda: (x * 2, [x + 1, None]), "cpu")
    with pytest.raises(RuntimeError):
        step.replay()
    first = step.first()
    buf = first[0]
    x.fill_(5.0)
    again = step.replay()
    assert again is first and again[0] is buf
    assert torch.equal(buf, torch.full((3,), 10.0))
    assert torch.equal(again[1][0], torch.full((3,), 6.0))
    with pytest.raises(RuntimeError):
        step.first()
    with pytest.raises(TypeError):
        copy_into((torch.zeros(1), None), (torch.zeros(1), torch.zeros(1)))


# -- the LM decode step with a device position ----------------------------

B_LM, S_LM, L_LM, SEED_LM = 2, 2, 6, 5
ARCHS = ("qwen3-1.7b", "mamba2-370m")


def _lm_cfg(mod, arch):
    return mod.get_config(arch, reduced=True)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    cfg = _lm_cfg(jconfigs, arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (S_LM * B_LM, L_LM),
                          dtype=np.int32)
    decode = rng.integers(0, cfg.vocab_size, (3, S_LM * B_LM, 1),
                          dtype=np.int32)
    params = jbb.init_params(jax.random.key(1), cfg, jnp.float32)
    ctx = jlayers.Ctx(jmcd.sample_rows(B_LM, S_LM), SEED_LM, cfg.mcd)
    _, st = jbb.prefill(params, cfg, jnp.asarray(tokens), ctx, L_LM + 4)
    want = []
    for tok in decode:
        lg, st = jbb.decode_step(params, cfg, jnp.asarray(tok), st, ctx)
        want.append(np.asarray(lg))
    tcfg = _lm_cfg(tconfigs, arch)
    port = bridge.from_numpy_backbone(jax.tree.map(np.asarray, params),
                                      tcfg, device="cpu")
    return dict(arch=arch, cfg=tcfg, params=port, tokens=tokens,
                decode=decode, want=want, pos=int(st.pos))


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_decode_step_with_a_device_pos_matches_jax(lm, backend):
    """Three decode steps run as the engine's static step runs them: the
    fed token and the state in fixed buffers, the position advanced by
    the step itself in its int32 scalar."""
    cfg, params = lm["cfg"], lm["params"]
    ctx = tlayers.Ctx(tmcd.sample_rows(B_LM, S_LM), SEED_LM, cfg.mcd)
    _, state = tbb.prefill(params, cfg, torch.from_numpy(lm["tokens"]), ctx,
                           L_LM + 4, backend=backend)
    assert state.pos.dtype == torch.int32 and state.pos.shape == ()
    assert int(state.pos) == L_LM
    token = torch.zeros((S_LM * B_LM, 1), dtype=torch.int32)

    def fn():
        lg, new = tbb.decode_step(params, cfg, token, state, ctx, backend)
        state.pos.copy_(new.pos)
        return lg

    step = StaticStep(fn, "cpu")
    for i, (tok, want) in enumerate(zip(lm["decode"], lm["want"])):
        token.copy_(torch.from_numpy(tok))
        lg = step.first() if i == 0 else step.replay()
        np.testing.assert_allclose(lg.numpy(), want, rtol=0, atol=ATOL)
    assert int(state.pos) == lm["pos"] == L_LM + 3


def test_engine_decode_runner_equals_eager(lm):
    """``BayesianEngine`` on the ``cuda`` backend decodes through its
    static step; it gives the eager decode's bits, twice in a row (the
    second generate copies its prefill into the adopted state)."""
    cfg, params = lm["cfg"], lm["params"]
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=S_LM))
    prompts = lm["tokens"][:B_LM]
    kw = dict(max_len=L_LM + 5, seed=SEED_LM, device="cpu")
    g = BayesianEngine(params, cfg, **kw)
    e = BayesianEngine(params, cfg, graphs=False, **kw)
    ref = BayesianEngine(params, cfg, backend="reference", **kw)
    assert e._graphs is None and ref._graphs is None
    want = e.generate(prompts, 4, keep_logits=True)
    for _ in range(2):
        got = g.generate(prompts, 4, keep_logits=True)
        for a, b in ((got.tokens, want.tokens), (got.logits, want.logits),
                     (got.predictive_entropy, want.predictive_entropy),
                     (got.mutual_information, want.mutual_information)):
            assert torch.equal(a, b)
    assert len(g._graphs) == 1
    (entry,) = g._graphs.values()
    assert int(entry.state.pos) == L_LM + 4
    r = ref.generate(prompts, 4, teacher_tokens=want.tokens)
    np.testing.assert_allclose(r.predictive_entropy.numpy(),
                               want.predictive_entropy.numpy(), rtol=0,
                               atol=ATOL)


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("capacity,caps", [("auto", "[8, 16, 20]"),
                                           ("fixed", "[20]")])
def test_stream_launcher_prewarms(capsys, capacity, caps):
    agg = tstream.main(["--device", "cpu", "--sessions", "2", "--samples",
                        "2", "--beats", "1", "--ragged", "--chunk-len", "20",
                        "--capacity", capacity, "--hidden", "4",
                        "--layers", "1", "--placement", "Y", "--prewarm"])
    out = capsys.readouterr().out
    assert f"prewarmed capacities {caps} in " in out
    assert agg["compiles"] == 0 and "compiles 0" in out
