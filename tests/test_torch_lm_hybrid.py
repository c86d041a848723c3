"""jamba's hybrid through the port's LM backbone and engine, against the
JAX reference: jamba-1.5-large-398b REDUCED, one period of its eight
blocks (``attn.moe``, then ``mamba.mlp`` / ``mamba.moe`` in turn), and
llama3-8b REDUCED through the engine.

JAX ``backbone.init_params(key(0), float32)`` (jitted) goes through
``bridge.from_numpy_backbone`` into the port; the same numpy-seeded tokens
and MC context (2 requests x 2 chains, p = 0.1, placement "Y") go through
both, on both port backends ("cuda" runs the kernels' plain versions on
CPU tensors):

* ``forward`` logits (1e-5) and aux (1e-6), at the REDUCED capacity
  factor (8.0) and at 0.5 (routes dropped);
* ``prefill`` logits and the mixed caches -- (k, v) padded to max_len
  beside seven ``MambaState``s -- then three teacher-forced
  ``decode_step`` calls and the final caches (1e-5);
* ``loss_fn``'s nll and aux;
* ``BayesianEngine.generate`` (2 requests x 4 chains, 4 new tokens):
  tokens equal to the JAX engine's, entropy and MI within 1e-5; the same
  for llama3-8b REDUCED.

The decode logits have a tolerance of their own, ``DECODE_ATOL = 2e-5``.
Fed the same inputs, no block of the port departs from JAX's by more than
``BLOCK_ULPS`` = 4 ulps of its output's largest value (3.3 seen, the
mamba caches' conv state; ``test_each_block_decode_matches_jax_in_ulps``
holds every block to it): the port has no faulty op.  Through eight
blocks and the head those few ulps add up to 5.5e-6, 8.9e-6 and 1.12e-5
at the three steps, on logits of ~3.7 (up to ~25 of their ulps); 2e-5 is
~45.  Also: the serving and training launchers and ``uncertainty_serving``
run jamba on the CPU.  One JAX init and one pass per context, cached for
the module.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mcd as jmcd  # noqa: E402
from repro.models import backbone as jbb, layers as jlayers  # noqa: E402
from repro.serve.engine import BayesianEngine as JEngine  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves, tree_map  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.examples import uncertainty_serving  # noqa: E402
from repro_torch.launch import serve as tserve, train as ttrain  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import Stage  # noqa: E402
from repro_torch.models.layers import MLPParams  # noqa: E402
from repro_torch.models.mamba2 import MambaParams, MambaState  # noqa: E402
from repro_torch.models.moe import MoEParams  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL, AUX_ATOL, DECODE_ATOL, BLOCK_ULPS = 1e-5, 1e-6, 2e-5, 4.0
ARCH, LLAMA = "jamba-1.5-large-398b", "llama3-8b"
B, S, L, MAX_LEN, SEED = 2, 2, 8, 12, 5
ENG_S, ENG_L, N_NEW = 4, 6, 4
_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (S * B, L), dtype=np.int32)
DECODE = _rng.integers(0, 256, (3, S * B, 1), dtype=np.int32)
TARGETS = _rng.integers(0, 256, (S * B, L), dtype=np.int32)
PROMPTS = _rng.integers(0, 256, (B, ENG_L), dtype=np.int32)


def _cfg(mod, arch=ARCH, cf=None, samples=None):
    cfg = mod.get_config(arch, reduced=True)
    if cf is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    if samples is not None:
        cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=samples))
    return cfg


def _np(a):
    return np.asarray(a)


def _jax_caches(cfg, caches):
    """JAX caches[i][j], leaves stacked [repeat, ...] -> one tuple of
    numpy leaves a layer."""
    return [tuple(_np(a)[r] for a in stage[j])
            for st, stage in zip(cfg.stages, caches)
            for r in range(st.repeat) for j in range(len(st.pattern))]


def _port_caches(caches):
    return [tuple(a.numpy() for a in block) for stage in caches
            for rep in stage for block in rep]


def _engine_run(params, cfg):
    res = JEngine(params, cfg, max_len=MAX_LEN, seed=SEED).generate(
        jnp.asarray(PROMPTS), N_NEW)
    return {"tokens": _np(res.tokens), "entropy": _np(res.predictive_entropy),
            "mi": _np(res.mutual_information)}


def _block_decodes(params, cfg, state, ctx):
    """Decode step 1 block by block: (x in, cache in, x out, cache out) of
    each JAX block, the inputs the port's blocks are fed."""
    x = jlayers.embed(params["embed"], jnp.asarray(DECODE[0]))
    bayes = jbb._stage_bayes(cfg, 0, cfg.stages[0])
    out = []
    for j, kind in enumerate(cfg.stages[0].pattern):
        p = jax.tree.map(lambda a: a[0], params["stages"][0][j])
        c = jax.tree.map(lambda a: a[0], state.caches[0][j])
        xo, co = jbb._block_decode(p, kind, cfg, x, c, state.pos, ctx, j,
                                   bayes[j])
        out.append((_np(x), tuple(map(_np, c)), _np(xo), tuple(map(_np, co))))
        x = xo
    return out


def _jax_run():
    cfg = _cfg(jconfigs)
    # jitted: twice as fast as eager here, and any parameters will do
    params = jax.jit(lambda k: jbb.init_params(k, cfg, jnp.float32))(
        jax.random.key(0))
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, cfg.mcd)
    tokens = jnp.asarray(TOKENS)
    lg, aux, _ = jbb.forward(params, cfg, tokens, ctx)
    out = {"tree": jax.tree.map(np.asarray, params), "forward": _np(lg),
           "aux": float(aux)}
    lg, aux, _ = jbb.forward(params, _cfg(jconfigs, cf=0.5), tokens, ctx)
    out["forward_cf"], out["aux_cf"] = _np(lg), float(aux)
    lg, st = jbb.prefill(params, cfg, tokens, ctx, MAX_LEN)
    out["prefill"], out["prefill_caches"] = _np(lg), _jax_caches(cfg,
                                                                  st.caches)
    out["blocks"] = _block_decodes(params, cfg, st, ctx)
    out["pos"] = int(st.pos)
    out["decode"] = []
    for tok in DECODE:
        lg, st = jbb.decode_step(params, cfg, jnp.asarray(tok), st, ctx)
        out["decode"].append(_np(lg))
    out["decode_caches"] = _jax_caches(cfg, st.caches)
    total, parts = jbb.loss_fn(params, cfg, tokens, jnp.asarray(TARGETS),
                               ctx)
    out["loss"] = (float(total), float(parts["nll"]), float(parts["aux"]))
    out["engine"] = _engine_run(params, _cfg(jconfigs, samples=ENG_S))
    return out


@pytest.fixture(scope="module")
def ref():
    return _jax_run()


@pytest.fixture(scope="module")
def llama():
    cfg = _cfg(jconfigs, LLAMA, samples=ENG_S)
    params = jax.jit(lambda k: jbb.init_params(k, cfg, jnp.float32))(
        jax.random.key(1))
    return {"tree": jax.tree.map(np.asarray, params),
            "engine": _engine_run(params, cfg)}


@pytest.fixture(scope="module")
def port(ref):
    return bridge.from_numpy_backbone(ref["tree"], _cfg(tconfigs),
                                      device="cpu")


def _ctx(cfg):
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED, cfg.mcd)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def test_bridge_carries_the_hybrid_period(port):
    """Every block of the eight-kind period carries its mixer and its FFN
    (a mamba block's too), with the reference's shapes."""
    cfg = _cfg(tconfigs)
    (rep,) = port["stages"][0]
    assert len(rep) == len(cfg.stages[0].pattern) == 8
    for kind, blk in zip(cfg.stages[0].pattern, rep):
        mixer, ffn = kind.split(".")
        assert (type(blk["mixer"]) is MambaParams) == (mixer == "mamba")
        want = MoEParams if ffn == "moe" else MLPParams
        assert type(blk["ffn"]) is want
        if ffn == "moe":
            assert blk["ffn"].wi.shape == (4, 64, 2, 64)
        else:
            assert blk["ffn"].wi.shape == (64, 2, 128)


def test_bridge_carries_stacked_repeats():
    """Two repeats of the period, stacked [2, ...] as the reference stacks
    them, come back through ``bridge.from_numpy_backbone`` as the port's
    blocks, repeat by repeat, bit for bit (``stack_repeats`` undone)."""
    cfg = _cfg(tconfigs).replace(stages=(
        Stage(_cfg(tconfigs).stages[0].pattern, 2),))
    mine = tbb.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    tree = tree_map(lambda t: t.numpy(), tbb.stack_repeats(mine))
    assert tree["stages"][0][2]["ffn"].wi.shape == (2, 4, 64, 2, 64)
    back = bridge.from_numpy_backbone(tree, cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(mine), strict=True):
        assert torch.equal(a, b)
    assert len(back["stages"][0]) == 2


def test_init_params_builds_the_hybrid():
    """The port's own init gives the reference's tree: the same leaves in
    the same order, shapes and dtypes, once stacked [repeat, ...]."""
    cfg = _cfg(tconfigs)
    mine = tbb.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jcfg = _cfg(jconfigs)
    theirs = jax.eval_shape(lambda k: jbb.init_params(k, jcfg, jnp.float32),
                            jax.random.key(0))
    stacked = tbb.stack_repeats(mine)
    got = [(tuple(a.shape), str(a.dtype).split(".")[-1])
           for a in tree_leaves(stacked)]
    want = [(tuple(a.shape), str(a.dtype))
            for a in jax.tree_util.tree_leaves(theirs)]
    assert got == want


@pytest.mark.parametrize("cf", [None, 0.5], ids=["reduced", "cf0.5"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_forward_logits_and_aux(ref, port, backend, cf):
    cfg = _cfg(tconfigs, cf=cf)
    lg, aux, caches = tbb.forward(port, cfg, torch.from_numpy(TOKENS),
                                  _ctx(cfg), backend=backend)
    suffix = "" if cf is None else "_cf"
    assert lg.shape == (S * B, L, 256) and caches is None
    _close(lg.numpy(), ref["forward" + suffix])
    assert abs(float(aux) - ref["aux" + suffix]) <= AUX_ATOL
    assert float(aux) > 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefill_and_teacher_forced_decode(ref, port, backend):
    cfg = _cfg(tconfigs)
    ctx = _ctx(cfg)
    lg, st = tbb.prefill(port, cfg, torch.from_numpy(TOKENS), ctx, MAX_LEN,
                         backend=backend)
    assert st.pos == L
    _close(lg.numpy(), ref["prefill"])
    (rep,) = st.caches[0]
    assert isinstance(rep[0], tuple) and not isinstance(rep[0], MambaState)
    assert all(isinstance(c, MambaState) for c in rep[1:])
    got = _port_caches(st.caches)
    assert len(got) == len(ref["prefill_caches"]) == cfg.num_layers
    for mine, theirs in zip(got, ref["prefill_caches"]):
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape
            _close(a, b)
    assert got[0][0].shape[1] == MAX_LEN
    for tok, want in zip(DECODE, ref["decode"]):
        lg, st = tbb.decode_step(port, cfg, torch.from_numpy(tok), st, ctx,
                                 backend=backend)
        _close(lg.numpy(), want, DECODE_ATOL)
    assert st.pos == L + len(DECODE)
    for mine, theirs in zip(_port_caches(st.caches), ref["decode_caches"]):
        for a, b in zip(mine, theirs):
            _close(a, b)


def _ulps(got, want):
    return float(np.abs(got - want).max()
                 / (np.finfo(np.float32).eps * np.abs(want).max()))


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_each_block_decode_matches_jax_in_ulps(ref, port, backend):
    """Fed JAX's inputs (the residual stream and the cache after the
    prefill), each block's decode output and updated cache are within
    BLOCK_ULPS ulps of the tensor's largest value: the decode logits'
    wider gap (DECODE_ATOL) is these few ulps carried through depth, not
    an op of the port that departs."""
    cfg = _cfg(tconfigs)
    ctx = _ctx(cfg)
    (rep,) = port["stages"][0]
    bayes = tbb._stage_bayes(cfg, 0, cfg.stages[0])
    pos = torch.tensor(ref["pos"], dtype=torch.int32)
    worst = 0.0
    for j, (kind, (x, c, xo, co)) in enumerate(
            zip(cfg.stages[0].pattern, ref["blocks"])):
        cache = tuple(torch.from_numpy(a.copy()) for a in c)
        if kind.startswith("mamba"):
            cache = MambaState(*cache)
        y, cache = tbb._block_decode(rep[j], kind, cfg,
                                     torch.from_numpy(x.copy()), cache, pos,
                                     ctx, j, bayes[j], backend)
        for got, want in zip((y, *cache), (xo, *co)):
            worst = max(worst, _ulps(got.numpy(), want))
    assert 0 < worst <= BLOCK_ULPS


def test_experts_widen_a_few_at_a_time(port, monkeypatch):
    """A bf16 MoE layer whose fp32 expert weights pass WIDEN_BYTES widens
    and multiplies its experts a few at a time (jamba-1.5-large's at full
    width): the same output as the one product over every expert."""
    ffn = port["stages"][0][0][2]["ffn"]
    bf = MoEParams(*(t.bfloat16() if isinstance(t, torch.Tensor) else t
                     for t in ffn))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 5, 64)).astype(np.float32)).bfloat16()
    whole = tmoe._experts(x, bf)
    per_expert = bf.wi[0].numel() * 4
    for widen in (per_expert, 3 * per_expert):
        monkeypatch.setattr(tmoe, "WIDEN_BYTES", widen)
        assert torch.equal(tmoe._experts(x, bf), whole)


def test_loss_fn_matches_jax(ref, port):
    cfg = _cfg(tconfigs)
    total, parts = tbb.loss_fn(port, cfg, torch.from_numpy(TOKENS),
                               torch.from_numpy(TARGETS), _ctx(cfg))
    want_total, want_nll, want_aux = ref["loss"]
    assert abs(float(parts["nll"]) - want_nll) <= ATOL
    assert abs(float(parts["aux"]) - want_aux) <= AUX_ATOL
    assert abs(float(total) - want_total) <= ATOL
    assert float(parts["aux"]) > 0


def _check_engine(params, cfg, want, backend):
    res = BayesianEngine(params, cfg, max_len=MAX_LEN, seed=SEED,
                         device="cpu", backend=backend).generate(PROMPTS,
                                                                 N_NEW)
    assert np.array_equal(res.tokens.numpy(), want["tokens"])
    _close(res.predictive_entropy.numpy(), want["entropy"])
    _close(res.mutual_information.numpy(), want["mi"])
    assert (res.mutual_information.numpy() > 1e-4).all()


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_generate_matches_the_jax_engine(ref, port, backend):
    _check_engine(port, _cfg(tconfigs, samples=ENG_S), ref["engine"],
                  backend)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_llama3_generate_matches_the_jax_engine(llama, backend):
    want = llama
    cfg = _cfg(tconfigs, LLAMA, samples=ENG_S)
    params = bridge.from_numpy_backbone(want["tree"], cfg, device="cpu")
    _check_engine(params, cfg, want["engine"], backend)


def test_decode_state_holds_kv_and_mamba_states():
    """One stage's decode state holds a (k, v) pair and Mamba states side
    by side, every tensor its own; the cache positions are the (k, v)
    pair's, and the int8 form applies to it alone."""
    cfg = _cfg(tconfigs, samples=ENG_S)
    st = tbb.init_decode_state(cfg, 4, MAX_LEN, device="cpu")
    (rep,) = st.caches[0]
    assert rep[0][0].shape == (4, MAX_LEN, 2, 16)
    for c in rep[1:]:
        assert c.ssm.shape == (4, 8, 16, 16) and c.ssm.dtype == torch.float32
    ptrs = [t.data_ptr() for c in rep for t in c]
    assert len(set(ptrs)) == len(ptrs)
    assert tbb.cache_positions(cfg, st.caches) == MAX_LEN
    q = tbb.init_decode_state(cfg, 4, MAX_LEN, kv_quant=True, device="cpu")
    assert q.caches[0][0][0][0].dtype == torch.int8
    assert isinstance(q.caches[0][0][1], MambaState)


@pytest.mark.parametrize("argv", [[], ["--dtype", "bf16"]],
                         ids=["fp32", "bf16"])
def test_serve_launcher_runs_jamba(argv, capsys):
    res = tserve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                       "--prompt-len", "5", "--new-tokens", "3",
                       "--samples", "2", *argv])
    assert res.tokens.shape == (2, 3)
    assert torch.isfinite(res.mutual_information).all()
    assert "arch=jamba-reduced S=2" in capsys.readouterr().out


def test_uncertainty_serving_runs_jamba(capsys):
    res = uncertainty_serving.main(["--device", "cpu", "--arch", ARCH,
                                    "--new-tokens", "3", "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    assert capsys.readouterr().out.startswith("jamba-reduced")


def test_train_launcher_trains_jamba(capsys):
    argv = ["--device", "cpu", "--task", "lm", "--arch", ARCH, "--steps",
            "2", "--seq", "9", "--batch", "4"]
    loss, params, batches, _, _ = ttrain.setup(ttrain.parser().parse_args(
        argv), torch.device("cpu"))
    toks, targets = (torch.as_tensor(a) for a in next(batches))
    total, parts = loss(params, (toks, targets), 0)
    assert float(parts["aux"]) > 0
    hist = ttrain.main(argv)["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[0]["loss"] == pytest.approx(float(total), abs=1e-6)
    assert "final loss" in capsys.readouterr().out
