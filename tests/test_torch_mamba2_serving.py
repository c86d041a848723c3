"""The port's backbone and ``BayesianEngine`` on mamba2-370m REDUCED (3
``mamba`` blocks, d_model 64, 8 SSD heads of 16, d_state 16, chunk 16,
vocab 256) against the JAX reference.

JAX ``backbone.init_params(key(0), float32)`` goes through
``bridge.from_numpy_backbone`` into the port; the same numpy-seeded
40-token prompts (three chunks of 16 after padding to 48) and MC context
(2 requests x 2 chains, p = 0.1, placement "Y") go through both, on both
port backends ("cuda", which on CPU tensors runs the kernels' plain
versions, and "reference"):

* ``forward`` logits; ``prefill`` logits and its Mamba states (unpadded:
  no sequence axis); three teacher-forced ``decode_step`` calls, logits and
  states — past any position limit, since a model without attention has
  none;
* ``generate``: tokens equal to the JAX engine's, entropy and mutual
  information within 1e-5;
* the launcher on ``--device cpu --arch mamba2-370m``.

Tolerance: 1e-5 absolute on fp32.  One JAX init, pass and engine run,
cached for the module.
"""

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
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL = 1e-5
B, S, L, MAX_LEN, N_NEW, SEED = 2, 2, 40, 44, 4, 5


def _cfg(mod):
    cfg = mod.get_config("mamba2-370m", reduced=True)
    return cfg.replace(mcd=cfg.mcd.replace(n_samples=S))


CFG, TCFG = _cfg(jconfigs), _cfg(tconfigs)
_rng = np.random.default_rng(0)
PROMPTS = _rng.integers(0, CFG.vocab_size, (B, L), dtype=np.int32)
TOKENS = np.tile(PROMPTS, (S, 1))               # chains folded into rows
DECODE = _rng.integers(0, CFG.vocab_size, (3, S * B, 1), dtype=np.int32)


def _np(a):
    return np.asarray(a)


def _jax_states(caches):
    """JAX caches[i][j] = MambaState stacked [repeat, ...] -> [(ssm, conv)]
    per layer."""
    out = []
    for st, stage in zip(CFG.stages, caches):
        for r in range(st.repeat):
            for j in range(len(st.pattern)):
                out.append((_np(stage[j].ssm)[r], _np(stage[j].conv)[r]))
    return out


def _port_states(caches):
    return [(blk.ssm.numpy(), blk.conv.numpy()) for stage in caches
            for rep in stage for blk in rep]


@pytest.fixture(scope="module")
def ref():
    params = jbb.init_params(jax.random.key(0), CFG, jnp.float32)
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, CFG.mcd)
    tokens = jnp.asarray(TOKENS)
    out = {"tree": jax.tree.map(np.asarray, params),
           "forward": _np(jbb.forward(params, CFG, tokens, ctx)[0])}
    lg, st = jbb.prefill(params, CFG, tokens, ctx, L)
    out["prefill"], out["prefill_states"] = _np(lg), _jax_states(st.caches)
    out["decode"] = []
    for tok in DECODE:
        lg, st = jbb.decode_step(params, CFG, jnp.asarray(tok), st, ctx)
        out["decode"].append(_np(lg))
    out["decode_states"] = _jax_states(st.caches)
    res = JEngine(params, CFG, max_len=MAX_LEN, seed=SEED).generate(
        jnp.asarray(PROMPTS), N_NEW)
    out["gen"] = {"tokens": _np(res.tokens),
                  "entropy": _np(res.predictive_entropy),
                  "mi": _np(res.mutual_information)}
    return out


@pytest.fixture(scope="module")
def params(ref):
    return bridge.from_numpy_backbone(ref["tree"], TCFG, device="cpu")


def _ctx():
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED, TCFG.mcd)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


def test_bridge_makes_mamba_blocks(params):
    blocks = [blk for stage in params["stages"] for rep in stage
              for blk in rep]
    assert len(blocks) == CFG.num_layers == 3
    assert all(isinstance(b["mixer"], tmamba.MambaParams) and "ffn" not in b
               for b in blocks)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_forward_logits(ref, params, backend):
    lg, _, caches = tbb.forward(params, TCFG, torch.from_numpy(TOKENS),
                                _ctx(), backend=backend)
    assert lg.shape == (S * B, L, CFG.vocab_size) and caches is None
    _close(lg.numpy(), ref["forward"])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefill_and_teacher_forced_decode(ref, params, backend):
    ctx = _ctx()
    # max_len = L: the decode steps below run past it, as a model without
    # attention has no position limit (the reference has none either)
    lg, st = tbb.prefill(params, TCFG, torch.from_numpy(TOKENS), ctx, L,
                         backend=backend)
    assert st.pos == L
    _close(lg.numpy(), ref["prefill"])
    got = _port_states(st.caches)
    assert len(got) == len(ref["prefill_states"]) == CFG.num_layers
    for (ssm, conv), (jssm, jconv) in zip(got, ref["prefill_states"]):
        assert ssm.shape == jssm.shape and conv.shape == jconv.shape
        _close(ssm, jssm)
        _close(conv, jconv)
    for tok, want in zip(DECODE, ref["decode"]):
        lg, st = tbb.decode_step(params, TCFG, torch.from_numpy(tok), st,
                                 ctx, backend=backend)
        _close(lg.numpy(), want)
    assert st.pos == L + len(DECODE)
    for (ssm, conv), (jssm, jconv) in zip(_port_states(st.caches),
                                          ref["decode_states"]):
        _close(ssm, jssm)
        _close(conv, jconv)


def test_init_decode_state_is_a_zero_mamba_state():
    st = tbb.init_decode_state(TCFG, 3, 10, device="cpu")
    blk = st.caches[0][0][0]
    assert isinstance(blk, tmamba.MambaState)
    assert blk.ssm.shape == (3, 8, 16, 16) and blk.conv.shape == (3, 3, 160)
    assert not blk.ssm.any() and not blk.conv.any()


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_generate_matches_the_jax_engine(ref, params, backend):
    res = BayesianEngine(params, TCFG, max_len=MAX_LEN, seed=SEED,
                         device="cpu", backend=backend).generate(PROMPTS,
                                                                 N_NEW)
    assert np.array_equal(res.tokens.numpy(), ref["gen"]["tokens"])
    _close(res.predictive_entropy.numpy(), ref["gen"]["entropy"])
    _close(res.mutual_information.numpy(), ref["gen"]["mi"])
    assert (res.mutual_information.numpy() > 1e-3).all()


def test_launcher_serves_mamba_on_cpu(capsys):
    res = tserve.main(["--device", "cpu", "--arch", "mamba2-370m",
                       "--batch", "2", "--prompt-len", "20",
                       "--new-tokens", "3", "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert "arch=mamba2-reduced S=2" in out and "req 1:" in out
