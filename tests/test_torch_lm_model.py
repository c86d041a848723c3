"""The port's LM backbone against the JAX reference, qwen3-1.7b REDUCED.

JAX ``backbone.init_params(key(0), float32)`` goes through
``bridge.from_numpy_backbone`` into the port; the same numpy-seeded tokens
and MC context (2 requests x 2 chains, p = 0.1, placement "Y") go through
both.  Compared, on both port backends ("cuda", which on CPU tensors runs
the kernels' plain versions, and "reference"):

* ``forward`` logits;
* ``prefill`` logits and its caches (padded to max_len);
* three teacher-forced ``decode_step`` calls: logits and the final caches;
* placement "NY", which over the one-block pattern makes no layer Bayesian
  (the Bayesian flag follows the pattern position, not the layer).

Tolerance: 1e-5 absolute on fp32 (matmuls and transcendentals round at
other places in XLA and PyTorch).  Also: the configs of all six archs
equal the reference's field for field, the attention site's kernel path
equals the reference's ``apply_site_mask`` up to the sign of zero, and
a ``.cross`` block, which once raised, matches JAX.  One JAX init and one
pass per context, cached for the module.
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
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.models.config import Stage  # noqa: E402

ATOL = 1e-5
CFG = jconfigs.get_config("qwen3-1.7b", reduced=True)
TCFG = tconfigs.get_config("qwen3-1.7b", reduced=True)
B, S, L, MAX_LEN, SEED = 2, 2, 8, 12, 5
_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, CFG.vocab_size, (S * B, L), dtype=np.int32)
DECODE = _rng.integers(0, CFG.vocab_size, (3, S * B, 1), dtype=np.int32)
NY = dict(placement="NY")


def _np(a):
    return np.asarray(a)


def _jax_caches(caches):
    """JAX caches[i][j] = (k, v) stacked [repeat, ...] -> [(k, v)] per
    layer."""
    out = []
    for st, stage in zip(CFG.stages, caches):
        for r in range(st.repeat):
            for j in range(len(st.pattern)):
                out.append(tuple(_np(a)[r] for a in stage[j]))
    return out


def _port_caches(caches):
    return [tuple(a.numpy() for a in block) for stage in caches
            for rep in stage for block in rep]


@pytest.fixture(scope="module")
def ref():
    params = jbb.init_params(jax.random.key(0), CFG, jnp.float32)
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, CFG.mcd)
    tokens = jnp.asarray(TOKENS)
    out = {"tree": jax.tree.map(np.asarray, params),
           "forward": _np(jbb.forward(params, CFG, tokens, ctx)[0])}
    lg, st = jbb.prefill(params, CFG, tokens, ctx, MAX_LEN)
    out["prefill"], out["prefill_caches"] = _np(lg), _jax_caches(st.caches)
    out["decode"] = []
    for tok in DECODE:
        lg, st = jbb.decode_step(params, CFG, jnp.asarray(tok), st, ctx)
        out["decode"].append(_np(lg))
    out["decode_caches"], out["pos"] = _jax_caches(st.caches), int(st.pos)
    cfg_ny = CFG.replace(mcd=CFG.mcd.replace(**NY))
    out["forward_ny"] = _np(jbb.forward(params, cfg_ny, tokens, ctx)[0])
    return out


@pytest.fixture(scope="module")
def port(ref):
    return bridge.from_numpy_backbone(ref["tree"], TCFG, device="cpu")


def _ctx(cfg=TCFG):
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED, cfg.mcd)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_forward_logits(ref, port, backend):
    lg, aux, caches = tbb.forward(port, TCFG, torch.from_numpy(TOKENS),
                                  _ctx(), backend=backend)
    assert lg.shape == (S * B, L, CFG.vocab_size) and caches is None
    _close(lg.numpy(), ref["forward"])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefill_and_teacher_forced_decode(ref, port, backend):
    ctx = _ctx()
    lg, st = tbb.prefill(port, TCFG, torch.from_numpy(TOKENS), ctx, MAX_LEN,
                         backend=backend)
    assert st.pos == L and lg.shape == (S * B, 1, CFG.vocab_size)
    _close(lg.numpy(), ref["prefill"])
    got = _port_caches(st.caches)
    assert len(got) == len(ref["prefill_caches"]) == CFG.num_layers
    for (k, v), (jk, jv) in zip(got, ref["prefill_caches"]):
        assert k.shape == jk.shape == (S * B, MAX_LEN, CFG.num_kv_heads,
                                       CFG.head_dim)
        _close(k, jk)
        _close(v, jv)
    for tok, want in zip(DECODE, ref["decode"]):
        lg, st = tbb.decode_step(port, TCFG, torch.from_numpy(tok), st, ctx,
                                 backend=backend)
        _close(lg.numpy(), want)
    assert st.pos == ref["pos"] == L + len(DECODE)
    for (k, v), (jk, jv) in zip(_port_caches(st.caches),
                                ref["decode_caches"]):
        _close(k, jk)
        _close(v, jv)


def test_placement_follows_the_pattern_position(ref, port):
    """ "NY" over the one-block pattern: position 0 takes "N" for every
    layer, so no layer is Bayesian — as in the reference."""
    cfg_ny = TCFG.replace(mcd=TCFG.mcd.replace(**NY))
    assert tbb._stage_bayes(cfg_ny, 0, cfg_ny.stages[0]) == (False,)
    tokens = torch.from_numpy(TOKENS)
    lg = tbb.forward(port, cfg_ny, tokens, _ctx(cfg_ny))[0]
    _close(lg.numpy(), ref["forward_ny"])
    det = tbb.forward(port, TCFG, tokens,
                      tlayers.Ctx.disabled(S * B, device="cpu"))[0]
    assert torch.equal(lg, det)
    assert not np.allclose(ref["forward_ny"], ref["forward"], atol=1e-3)


def test_attention_site_kernel_path_equals_apply_site_mask():
    """The kernel path (``masked_activation``) against the reference's
    ``apply_site_mask``: equal values; only the sign of a zero may
    differ (x · 0 · scale keeps x's sign, where(...) writes +0)."""
    x = np.random.default_rng(3).standard_normal((S * B, L, 64)).astype(
        np.float32)
    jm = jlayers.site_mask(jlayers.Ctx(jmcd.sample_rows(B, S), SEED,
                                       CFG.mcd), True, 1, jlayers.SITE_ATTN,
                           64, jnp.float32)
    want = _np(jlayers.apply_site_mask(jnp.asarray(x), jm, CFG.mcd.p))
    tm = tlayers.site_mask(_ctx(), True, 1, tlayers.SITE_ATTN)
    for backend in ("cuda", "reference"):
        got = tlayers.apply_site_mask(torch.from_numpy(x), tm, CFG.mcd.p,
                                      backend).numpy()
        assert np.array_equal(got, want)
    assert (want == 0).any()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for reduced in (False, True):
        assert dataclasses.asdict(tconfigs.get_config(arch, reduced)) == \
            dataclasses.asdict(jconfigs.get_config(arch, reduced))


@pytest.mark.parametrize("arch", ["attn.cross.mlp", "moe_sharding axis"])
def test_unported_blocks_raise(arch):
    """Two cases that once raised, naming ROADMAP.md, and no longer do.
    A block with cross-attention (on an ``attn`` mixer, as the
    reference's ``init_block`` allows) is built with one ``enc_attn.mlp``
    encoder layer and matches JAX's forward over the same frames
    (tests/test_torch_lm_encdec.py holds the whole encoder–decoder path).
    A MoE expert or token mesh axis is accepted since the planning stack
    (launch/shardings.py) and is the identity on the port's one device
    (tests/test_torch_moe.py)."""
    if arch == "moe_sharding axis":
        from repro_torch.models import moe as tmoe
        with tmoe.moe_sharding(expert_axis="model", token_axes=("data",)):
            assert tmoe._MOE_OVERRIDE == {"groups": 1}
        assert tmoe._MOE_OVERRIDE == {}
        return
    from repro.models.config import Stage as JStage
    kw = dict(encoder_seq=4)
    jcfg = CFG.replace(stages=(JStage((arch,), 1),),
                       encoder_stages=(JStage(("enc_attn.mlp",), 1),), **kw)
    tcfg = TCFG.replace(stages=(Stage((arch,), 1),),
                        encoder_stages=(Stage(("enc_attn.mlp",), 1),), **kw)
    jp = jbb.init_params(jax.random.key(1), jcfg, jnp.float32)
    tp = bridge.from_numpy_backbone(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    assert set(tp["stages"][0][0][0]) == {"mixer", "cross", "ffn"}
    frames = np.random.default_rng(2).standard_normal(
        (S * B, 4, CFG.d_model)).astype(np.float32)
    want = _np(jbb.forward(
        jp, jcfg, jnp.asarray(TOKENS),
        jlayers.Ctx(jmcd.sample_rows(B, S), SEED, CFG.mcd),
        frames=jnp.asarray(frames))[0])
    for backend in ("cuda", "reference"):
        got = tbb.forward(tp, tcfg, torch.from_numpy(TOKENS), _ctx(),
                          frames=torch.from_numpy(frames),
                          backend=backend)[0]
        _close(got.numpy(), want)


def test_int8_kv_cache_raises(port):
    """The int8 KV cache is ported (held to JAX in
    ``test_torch_lm_precision.py``): ``init_decode_state(kv_quant=True)``
    makes the reference's (k_i8, k_scale, v_i8, v_scale), a decode step
    writes the codes and scales at pos in place on both backends; a cache
    of any other arity raises."""
    for backend in ("cuda", "reference"):
        st = tbb.init_decode_state(TCFG, S * B, MAX_LEN, kv_quant=True,
                                   device="cpu")
        k8, ks, v8, vs = st.caches[0][0][0]
        assert (k8.dtype, ks.dtype) == (torch.int8, torch.bfloat16)
        assert ks.shape == (S * B, MAX_LEN, TCFG.num_kv_heads)
        lg, st = tbb.decode_step(port, TCFG, torch.from_numpy(DECODE[0]), st,
                                 _ctx(), backend=backend)
        assert torch.isfinite(lg).all() and st.pos == 1
        assert ks[:, 0].abs().min() > 0 and not ks[:, 1:].any()
        assert k8[:, 0].abs().max() == 127 and not k8[:, 1:].any()
    blk = port["stages"][0][0][0]["mixer"]
    kv = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="k_i8"):
        tlayers.attention_decode(blk, torch.zeros((2, 1, 64)),
                                 (kv, kv, kv), torch.tensor(0), 1e6, None,
                                 0.1)


def test_init_params_is_seeded_and_at_the_reference_scales():
    a = tbb.init_params(TCFG, torch.Generator().manual_seed(1), device="cpu")
    b = tbb.init_params(TCFG, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a["embed"].head, b["embed"].head)
    blk = a["stages"][0][1][0]
    assert blk["mixer"].wq.shape == (64, 4, 16)
    assert blk["ffn"].wi.shape == (64, 2, 128)
    assert abs(blk["ffn"].wo.std().item() - 128 ** -0.5) < 0.01
    assert abs(a["embed"].table.std().item() - 0.02) < 0.002
    assert torch.equal(blk["mixer"].q_scale, torch.ones(16))
