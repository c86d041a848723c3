"""``BayesianEngine.generate`` of the port against the JAX engine, on
qwen3-1.7b REDUCED (2 requests x 4 chains, p = 0.1, 4 new tokens).

The same JAX parameters (through ``bridge.from_numpy_backbone``) and the
same numpy-seeded prompts go to both engines.  Tokens must be equal;
predictive entropy and mutual information within 1e-5 (fp32).  Both port
backends are held to it ("cuda" on CPU tensors runs the kernels' plain
versions).  Also: the same seed gives the same generation bit for bit,
teacher forcing on a run's own tokens repeats that run, p = 0 leaves no
epistemic part (MI ~ 0), and the launcher serves on the CPU.  One JAX
engine run, cached for the module.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro.serve.engine import BayesianEngine as JEngine  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL = 1e-5
B, S, L, N_NEW, MAX_LEN, SEED = 2, 4, 6, 4, 12, 3


def _cfg(mod):
    cfg = mod.get_config("qwen3-1.7b", reduced=True)
    return cfg.replace(mcd=cfg.mcd.replace(n_samples=S))


CFG, TCFG = _cfg(jconfigs), _cfg(tconfigs)
PROMPTS = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, L),
                                            dtype=np.int32)


@pytest.fixture(scope="module")
def ref():
    params = jbb.init_params(jax.random.key(0), CFG, jnp.float32)
    res = JEngine(params, CFG, max_len=MAX_LEN, seed=SEED).generate(
        jnp.asarray(PROMPTS), N_NEW)
    return {"tree": jax.tree.map(np.asarray, params),
            "tokens": np.asarray(res.tokens),
            "entropy": np.asarray(res.predictive_entropy),
            "mi": np.asarray(res.mutual_information),
            "probs": np.asarray(res.mean_probs_last)}


@pytest.fixture(scope="module")
def params(ref):
    return bridge.from_numpy_backbone(ref["tree"], TCFG, device="cpu")


def _engine(params, cfg=TCFG, backend="cuda", seed=SEED):
    return BayesianEngine(params, cfg, max_len=MAX_LEN, seed=seed,
                          device="cpu", backend=backend)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_generate_matches_the_jax_engine(ref, params, backend):
    res = _engine(params, backend=backend).generate(PROMPTS, N_NEW)
    assert res.tokens.shape == (B, N_NEW)
    assert np.array_equal(res.tokens.numpy(), ref["tokens"])
    for got, want in ((res.predictive_entropy, ref["entropy"]),
                      (res.mutual_information, ref["mi"]),
                      (res.mean_probs_last, ref["probs"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (res.mutual_information.numpy() > 1e-3).all()
    assert len(res.decode_s) == N_NEW and res.prefill_s > 0


def test_same_seed_same_generation_and_teacher_forcing(params):
    a = _engine(params).generate(PROMPTS, N_NEW, keep_logits=True)
    b = _engine(params).generate(PROMPTS, N_NEW)
    c = _engine(params, backend="reference").generate(
        PROMPTS, N_NEW, teacher_tokens=a.tokens, keep_logits=True)
    for x, y in ((a.tokens, b.tokens), (a.predictive_entropy,
                                        b.predictive_entropy),
                 (a.mutual_information, b.mutual_information)):
        assert torch.equal(x, y)
    assert a.logits.shape == (N_NEW, S * B, CFG.vocab_size)
    assert torch.equal(c.tokens, a.tokens)
    np.testing.assert_allclose(c.logits.numpy(), a.logits.numpy(), rtol=0,
                               atol=ATOL)
    other = _engine(params, seed=SEED + 1).generate(PROMPTS, N_NEW)
    assert not torch.equal(other.mutual_information, a.mutual_information)


def test_generate_past_max_len_raises(params):
    """Prompt + new tokens up to ``max_len`` serve; one more raises
    ``ValueError`` at the decode step past the cache.  (The JAX engine
    clamps that step's cache write to the last slot and goes on: a
    documented divergence, not a repair.)"""
    res = _engine(params).generate(PROMPTS, MAX_LEN - L)
    assert res.tokens.shape == (B, MAX_LEN - L)
    with pytest.raises(ValueError, match="past the cache"):
        _engine(params).generate(PROMPTS, MAX_LEN - L + 1)


def test_p_zero_leaves_no_epistemic_part(params):
    cfg = TCFG.replace(mcd=TCFG.mcd.replace(p=0.0))
    res = _engine(params, cfg).generate(PROMPTS, 3)
    np.testing.assert_allclose(res.mutual_information.numpy(), 0.0,
                               atol=1e-6)
    assert (res.predictive_entropy.numpy() > 1.0).all()


def test_launcher_serves_on_cpu(capsys):
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "5", "--new-tokens", "3", "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b-reduced S=2" in out and "req 1:" in out
    res = tserve.main(["--device", "cpu", "--arch", "jamba-1.5-large-398b",
                       "--batch", "2", "--prompt-len", "5", "--new-tokens",
                       "2", "--samples", "2"])
    assert res.tokens.shape == (2, 2)
    assert "arch=jamba-reduced S=2" in capsys.readouterr().out
