"""The MoE family through the port's LM backbone and engine, against the
JAX reference: olmoe-1b-7b (``attn.moe``) and deepseek-v2-lite-16b
(``mla.mlp`` then ``mla.moe`` with a shared expert), REDUCED.

JAX ``backbone.init_params(key(0), float32)`` (jitted) goes through
``bridge.from_numpy_backbone`` (``MoEParams`` with its shared
``MLPParams``, ``MLAParams``) into the port; the same numpy-seeded tokens
and MC context (2 requests x 2 chains, p = 0.1, placement "Y") go through
both.  On both port backends ("cuda" runs the kernels' plain versions on
CPU tensors), within 1e-5 (fp32), the MoE aux within 1e-6:

* ``forward`` logits and aux, at the REDUCED capacity factor (8.0,
  nothing dropped) and at 0.5 (routes dropped);
* ``prefill`` logits and caches (an ``MLACache`` padded to max_len for
  deepseek), then three teacher-forced ``decode_step`` calls and the
  final caches;
* ``BayesianEngine.generate`` (2 requests x 4 chains, 4 new tokens):
  tokens equal to the JAX engine's, entropy and MI within 1e-5;
* ``loss_fn``'s nll and aux.

Also: ``cache_positions`` reads an MLA cache, ``generate`` past
``max_len`` raises on deepseek, and the serving launcher, the
``uncertainty_serving`` example (olmoe by default, as the reference's) and
the training launcher run the MoE archs on the CPU.  One JAX init and one
pass per context and arch, cached for the module.
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
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.examples import uncertainty_serving  # noqa: E402
from repro_torch.launch import serve as tserve, train as ttrain  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.models.mla import MLACache  # noqa: E402
from repro_torch.models.moe import MoEParams  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL, AUX_ATOL = 1e-5, 1e-6
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
B, S, L, MAX_LEN, SEED = 2, 2, 8, 12, 5
ENG_S, ENG_L, N_NEW = 4, 6, 4
_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (S * B, L), dtype=np.int32)
DECODE = _rng.integers(0, 256, (3, S * B, 1), dtype=np.int32)
TARGETS = _rng.integers(0, 256, (S * B, L), dtype=np.int32)
PROMPTS = _rng.integers(0, 256, (B, ENG_L), dtype=np.int32)


def _cfg(mod, arch, cf=None, samples=None):
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
    out = []
    for st, stage in zip(cfg.stages, caches):
        for r in range(st.repeat):
            for j in range(len(st.pattern)):
                out.append(tuple(_np(a)[r] for a in stage[j]))
    return out


def _port_caches(caches):
    return [tuple(a.numpy() for a in block) for stage in caches
            for rep in stage for block in rep]


def _jax_run(arch):
    cfg = _cfg(jconfigs, arch)
    # jitted: twice as fast as eager here, and any parameters will do
    params = jax.jit(lambda k: jbb.init_params(k, cfg, jnp.float32))(
        jax.random.key(0))
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, cfg.mcd)
    tokens = jnp.asarray(TOKENS)
    lg, aux, _ = jbb.forward(params, cfg, tokens, ctx)
    out = {"tree": jax.tree.map(np.asarray, params), "forward": _np(lg),
           "aux": float(aux)}
    lg, aux, _ = jbb.forward(params, _cfg(jconfigs, arch, 0.5), tokens, ctx)
    out["forward_cf"], out["aux_cf"] = _np(lg), float(aux)
    lg, st = jbb.prefill(params, cfg, tokens, ctx, MAX_LEN)
    out["prefill"], out["prefill_caches"] = _np(lg), _jax_caches(cfg,
                                                                  st.caches)
    out["decode"] = []
    for tok in DECODE:
        lg, st = jbb.decode_step(params, cfg, jnp.asarray(tok), st, ctx)
        out["decode"].append(_np(lg))
    out["decode_caches"] = _jax_caches(cfg, st.caches)
    total, parts = jbb.loss_fn(params, cfg, tokens, jnp.asarray(TARGETS),
                               ctx)
    out["loss"] = (float(total), float(parts["nll"]), float(parts["aux"]))
    ecfg = _cfg(jconfigs, arch, samples=ENG_S)
    res = JEngine(params, ecfg, max_len=MAX_LEN, seed=SEED).generate(
        jnp.asarray(PROMPTS), N_NEW)
    out["engine"] = {"tokens": _np(res.tokens),
                     "entropy": _np(res.predictive_entropy),
                     "mi": _np(res.mutual_information)}
    return out


@pytest.fixture(scope="module")
def ref():
    """arch -> the JAX results, computed on first use."""
    class Lazy(dict):
        def __missing__(self, arch):
            self[arch] = _jax_run(arch)
            return self[arch]
    return Lazy()


@pytest.fixture(scope="module")
def ports(ref):
    class Lazy(dict):
        def __missing__(self, arch):
            self[arch] = bridge.from_numpy_backbone(
                ref[arch]["tree"], _cfg(tconfigs, arch), device="cpu")
            return self[arch]
    return Lazy()


def _ctx(cfg):
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED, cfg.mcd)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_moe_and_mla(ports, arch):
    blocks = [b for stage in ports[arch]["stages"] for rep in stage
              for b in rep]
    moes = [b["ffn"] for b in blocks if isinstance(b["ffn"], MoEParams)]
    assert len(moes) == 2
    for f in moes:
        assert f.router.dtype == torch.float32 and f.wi.shape == (8, 64, 2,
                                                                 32)
        assert (f.shared is None) == (arch == "olmoe-1b-7b")
        if f.shared is not None:
            assert f.shared.wi.shape == (64, 2, 32)
    if arch == "deepseek-v2-lite-16b":
        assert type(blocks[0]["mixer"]).__name__ == "MLAParams"
        assert blocks[0]["ffn"].wi.shape == (64, 2, 128)


@pytest.mark.parametrize("cf", [None, 0.5], ids=["reduced", "cf0.5"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(ref, ports, arch, backend, cf):
    cfg = _cfg(tconfigs, arch, cf)
    lg, aux, caches = tbb.forward(ports[arch], cfg, torch.from_numpy(TOKENS),
                                  _ctx(cfg), backend=backend)
    suffix = "" if cf is None else "_cf"
    assert lg.shape == (S * B, L, 256) and caches is None
    _close(lg.numpy(), ref[arch]["forward" + suffix])
    assert abs(float(aux) - ref[arch]["aux" + suffix]) <= AUX_ATOL
    assert float(aux) > 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode(ref, ports, arch, backend):
    cfg = _cfg(tconfigs, arch)
    ctx = _ctx(cfg)
    lg, st = tbb.prefill(ports[arch], cfg, torch.from_numpy(TOKENS), ctx,
                         MAX_LEN, backend=backend)
    assert st.pos == L
    _close(lg.numpy(), ref[arch]["prefill"])
    got = _port_caches(st.caches)
    assert len(got) == len(ref[arch]["prefill_caches"]) == cfg.num_layers
    for mine, theirs in zip(got, ref[arch]["prefill_caches"]):
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape and a.shape[1] == MAX_LEN
            _close(a, b)
    if arch == "deepseek-v2-lite-16b":
        assert isinstance(st.caches[1][0][0], MLACache)
        assert st.caches[1][0][0].c_kv.shape == (S * B, MAX_LEN, 32)
    for tok, want in zip(DECODE, ref[arch]["decode"]):
        lg, st = tbb.decode_step(ports[arch], cfg, torch.from_numpy(tok), st,
                                 ctx, backend=backend)
        _close(lg.numpy(), want)
    assert st.pos == L + len(DECODE)
    for mine, theirs in zip(_port_caches(st.caches),
                            ref[arch]["decode_caches"]):
        for a, b in zip(mine, theirs):
            _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(ref, ports, arch):
    cfg = _cfg(tconfigs, arch)
    total, parts = tbb.loss_fn(ports[arch], cfg, torch.from_numpy(TOKENS),
                               torch.from_numpy(TARGETS), _ctx(cfg))
    want_total, want_nll, want_aux = ref[arch]["loss"]
    assert abs(float(parts["nll"]) - want_nll) <= ATOL
    assert abs(float(parts["aux"]) - want_aux) <= AUX_ATOL
    assert abs(float(total) - want_total) <= ATOL
    assert float(parts["aux"]) > 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_jax_engine(ref, ports, arch, backend):
    cfg = _cfg(tconfigs, arch, samples=ENG_S)
    res = BayesianEngine(ports[arch], cfg, max_len=MAX_LEN, seed=SEED,
                         device="cpu", backend=backend).generate(PROMPTS,
                                                                 N_NEW)
    want = ref[arch]["engine"]
    assert np.array_equal(res.tokens.numpy(), want["tokens"])
    _close(res.predictive_entropy.numpy(), want["entropy"])
    _close(res.mutual_information.numpy(), want["mi"])
    assert (res.mutual_information.numpy() > 1e-4).all()


def test_mla_cache_positions_and_past_max_len_raises(ports):
    arch = "deepseek-v2-lite-16b"
    cfg = _cfg(tconfigs, arch, samples=ENG_S)
    st = tbb.init_decode_state(cfg, 4, MAX_LEN, device="cpu")
    assert isinstance(st.caches[0][0][0], MLACache)
    assert tbb.cache_positions(cfg, st.caches) == MAX_LEN
    q = tbb.init_decode_state(cfg, 4, MAX_LEN, kv_quant=True, device="cpu")
    assert q.caches[0][0][0].c_kv.dtype == torch.float32   # kv_quant: MLA
    eng = BayesianEngine(ports[arch], cfg, max_len=MAX_LEN, seed=SEED,
                         device="cpu")
    assert eng.generate(PROMPTS, MAX_LEN - ENG_L).tokens.shape == (
        B, MAX_LEN - ENG_L)
    with pytest.raises(ValueError, match="past the cache"):
        eng.generate(PROMPTS, MAX_LEN - ENG_L + 1)


@pytest.mark.parametrize("argv", [
    ["--arch", "olmoe-1b-7b"],
    ["--arch", "deepseek-v2-lite-16b", "--dtype", "bf16"]],
    ids=["olmoe", "deepseek-bf16"])
def test_serve_launcher_runs_the_moe_archs(argv, capsys):
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "5", "--new-tokens", "3", "--samples", "2", *argv])
    assert res.tokens.shape == (2, 3)
    assert torch.isfinite(res.mutual_information).all()
    assert "-reduced S=2" in capsys.readouterr().out


def test_uncertainty_serving_defaults_to_olmoe(capsys):
    res = uncertainty_serving.main(["--device", "cpu", "--new-tokens", "3",
                                    "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    assert capsys.readouterr().out.startswith("olmoe-reduced")


def test_train_launcher_lm_loss_carries_the_aux(capsys):
    argv = ["--device", "cpu", "--task", "lm", "--arch", "olmoe-1b-7b",
            "--steps", "2", "--seq", "9", "--batch", "4"]
    loss, params, batches, _, cfg = ttrain.setup(ttrain.parser().parse_args(
        argv), torch.device("cpu"))
    toks, targets = (torch.as_tensor(a) for a in next(batches))
    total, parts = loss(params, (toks, targets), 0)
    assert float(parts["aux"]) > 0
    assert float(total) == float(parts["nll"] + parts["aux"])
    hist = ttrain.main(argv)["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[0]["loss"] == pytest.approx(float(total), abs=1e-6)
    assert "final loss" in capsys.readouterr().out
