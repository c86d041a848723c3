"""The port's LMs at bf16 and with the int8 KV cache, against the JAX
reference at the precision it builds them in.

* The five places where the port rounded other than the reference: the
  prefill attention's scores and P·V product (``blockwise_attention``),
  the reference backend's SwiGLU gate/up product and the logits, each an
  fp32 product of bf16 operands in the reference
  (``preferred_element_type``); the reference backend's decode softmax,
  whose weights the reference rounds to the cache dtype before P·V; and
  the weight bridge, which kept no bf16 leaf bf16.  One test each: each
  failed before the repair.
* The four LM kernels' plain versions at bf16 against the interpret-mode
  Pallas kernels: ``masked_activation_plain``, ``mcd_matmul_plain`` (bf16
  out) and the y of ``ssd_chunk_scan_plain`` bit-equal,
  ``decode_attention_plain`` within 2e-6 and the SSD state within 5e-7
  (fp32 sums in another order).
* ``layers.quantize_kv`` against the compiled ``_quantize_kv`` (codes and
  bf16 scales bit-equal) and the int8 cache of ``init_decode_state``
  against the reference's shapes and dtypes.
* qwen3-1.7b and mamba2-370m REDUCED at bf16 (``init_params(bfloat16)``
  bridged): prefill and 3 teacher-forced decode steps on both port
  backends, and qwen3 from an int8 zero state over 4 decode steps.  The
  ``reference`` backend within 1e-5 of JAX's logits, mamba2's ``cuda``
  backend too; qwen3's ``cuda`` backend within CUDA_BF16_ATOL, since its
  decode softmax is the TPU kernel's (fp32 weights over the cache: 0.02 to
  0.05 from the reference's bf16-rounded ones on logits of ~3.5).
* The engine at bf16: the decode step through its static buffers (the
  graph's on the card) equal to eager, and ``init_params``' default dtype.

How the comparison is made clean.  Two things on the JAX side are not the
port's and are taken out:
* XLA on the CPU keeps excess precision between bf16 operations by
  default, so JAX's bf16 would not round where its program says; every
  JAX function here is compiled with ``compiler_options=
  {"xla_allow_excess_precision": False}`` (the same numbers as
  ``XLA_FLAGS=--xla_allow_excess_precision=false``).
* XLA's bf16 ``jax.nn.silu`` differs from every PyTorch form by one bf16
  ulp on a fifth to a half of the elements (its logistic); inside the
  module fixture, and only there (``pytest.MonkeyPatch.context``), it is
  ``x * sigmoid(f32(x))`` rounded to bf16, which is the port's
  ``mamba2._silu`` at bf16.  The mamba mixer is the only bf16 user.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mcd as jmcd  # noqa: E402
from repro.kernels import bernoulli_mask as jmask  # noqa: E402
from repro.kernels import decode_attn as jattn  # noqa: E402
from repro.kernels import mcd_matmul as jmm  # noqa: E402
from repro.kernels import ssd_chunk as jssd  # noqa: E402
from repro.models import backbone as jbb, layers as jlayers  # noqa: E402
from repro_torch import bridge, configs as tconfigs  # noqa: E402
from repro_torch.core import cells as tcells  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.kernels import bernoulli_mask as tmask  # noqa: E402
from repro_torch.kernels import decode_attn as tattn  # noqa: E402
from repro_torch.kernels import mcd_matmul as tmm  # noqa: E402
from repro_torch.kernels import ssd_chunk as tssd  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL = 1e-5            # reference backend (and mamba2 on cuda) vs JAX bf16
CUDA_BF16_ATOL = 0.06  # qwen3 on cuda: the TPU kernel's fp32 softmax
                       # weights against the reference's bf16-rounded ones
OPTS = {"xla_allow_excess_precision": False}
ARCHS = ("qwen3-1.7b", "mamba2-370m")
B, S, L, MAX_LEN, SEED = 2, 2, 8, 12, 5
_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (S * B, L), dtype=np.int32)
DECODE = _rng.integers(0, 256, (4, S * B, 1), dtype=np.int32)
BF16 = jnp.bfloat16


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=OPTS)


def _silu_bf16(x):
    return x * jax.nn.sigmoid(x.astype(jnp.float32)).astype(x.dtype)


def _np(a):
    """A JAX array as numpy; bf16 as fp32 (exact)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bf(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).astype(np.float32)).bfloat16()


def _randn(seed, shape, k=1.0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                       .astype(np.float32) * k).astype(BF16)


def _model(arch, params, ctx, quant):
    """JAX bf16: prefill + 3 teacher-forced steps, or 4 steps from an int8
    zero state; the logits of each call."""
    cfg = jconfigs.get_config(arch, reduced=True)
    if quant:
        st = jbb.init_decode_state(cfg, S * B, MAX_LEN, kv_quant=True)
        out, toks = [], DECODE
    else:
        tokens = jnp.asarray(TOKENS)
        lg, st = _compiled(lambda p, t: jbb.prefill(p, cfg, t, ctx, MAX_LEN),
                           params, tokens)(params, tokens)
        out, toks = [_np(lg)], DECODE[:3]
    step = _compiled(lambda p, t, s: jbb.decode_step(p, cfg, t, s, ctx),
                     params, jnp.asarray(toks[0]), st)
    for tok in toks:
        lg, st = step(params, jnp.asarray(tok), st)
        out.append(_np(lg))
    return out


@pytest.fixture(scope="module")
def jx():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "silu", _silu_bf16)
        # fault 1: the prefill attention
        q, k, v = (_randn(i, (4, 8, 4, 16)) for i in (1, 2, 3))
        k, v = k[:, :, :2], v[:, :, :2]
        out["attn_in"] = (q, k, v)
        out["attn"] = _np(_compiled(
            lambda q, k, v: jlayers.blockwise_attention(q, k, v, causal=True,
                                                        q_block=4,
                                                        kv_block=4),
            q, k, v)(q, k, v))
        # faults 2 and 3: the SwiGLU gate/up product and the logits
        mlp = jlayers.init_mlp(jax.random.key(1), 64, 128, BF16)
        emb = jlayers.init_embed(jax.random.key(2), 256, 64, False, BF16)
        x = _randn(4, (3, 5, 64))
        out["mlp_in"], out["emb_in"], out["x"] = mlp, emb, x
        out["mlp"] = _np(_compiled(
            lambda p, x: jlayers.mlp_forward(p, x, None, 0.0), mlp, x)(mlp, x))
        out["logits"] = _np(_compiled(jlayers.logits, emb, x)(emb, x))
        # fault 4: the reference backend's decode softmax
        att = jlayers.init_attn(jax.random.key(3), 64, 4, 2, 16, True, BF16)
        xd = _randn(5, (3, 1, 64))
        cache = (_randn(6, (3, 10, 2, 16)), _randn(7, (3, 10, 2, 16)))
        pos = jnp.int32(6)
        dec = _compiled(lambda p, x, c, i: jlayers.attention_decode(
            p, x, c, i, 1e6, None, 0.0), att, xd, cache, pos)
        o, c = dec(att, xd, cache, pos)
        out["decode_in"] = (att, xd, cache)
        out["decode"] = (_np(o), _np(c[0]), _np(c[1]))
        # _quantize_kv as the decode step compiles it
        kv = _randn(8, (16, 1, 8, 128), k=3.0)
        qc, qs = _compiled(jlayers._quantize_kv, kv)(kv)
        out["quant"] = (kv, np.asarray(qc), _np(qs))
        # the models
        ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED,
                          jconfigs.get_config("qwen3-1.7b", reduced=True).mcd)
        for arch in ARCHS:
            cfg = jconfigs.get_config(arch, reduced=True)
            params = jbb.init_params(jax.random.key(0), cfg, BF16)
            out[arch] = {"tree": jax.tree.map(np.asarray, params),
                         "logits": _model(arch, params, ctx, False)}
            if arch == "qwen3-1.7b":
                out[arch]["int8"] = _model(arch, params, ctx, True)
                st = jbb.init_decode_state(cfg, S * B, MAX_LEN, kv_quant=True)
                out[arch]["int8_state"] = st
    return out


def _tctx():
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED,
                       tconfigs.get_config("qwen3-1.7b", reduced=True).mcd)


def _tree(params, kind):
    return kind(*(None if a is None else _bf(a) for a in params))


# -- faults 1-5 ---------------------------------------------------------------

def test_blockwise_attention_keeps_fp32_scores(jx):
    """Fault 1: the scores and the P·V product were bf16 products."""
    q, k, v = (_bf(a) for a in jx["attn_in"])
    got = tlayers.blockwise_attention(q, k, v, causal=True, q_block=4,
                                      kv_block=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), jx["attn"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_mlp_gate_up_stays_fp32(jx, backend):
    """Fault 2: the reference backend's gate/up product rounded to bf16
    (the cuda backend's ``mcd_dense`` was right)."""
    p = _tree(jx["mlp_in"], tlayers.MLPParams)
    got = tlayers.mlp_forward(p, _bf(jx["x"]), None, 0.0, backend)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), jx["mlp"])


def test_logits_are_an_fp32_product(jx):
    """Fault 3: the logits rounded to bf16 before the cast to fp32."""
    p = _tree(jx["emb_in"], tlayers.EmbedParams)
    got = tlayers.logits(p, _bf(jx["x"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jx["logits"], rtol=0, atol=1e-6)


def test_reference_decode_rounds_the_weights_to_the_cache_dtype(jx):
    """Fault 4: the reference backend's decode softmax kept its weights in
    fp32 (the kernel's plain version); the reference rounds them to the
    cache dtype before P·V.  The cache is written in place at pos."""
    att, xd, cache = jx["decode_in"]
    p = _tree(att, tlayers.AttnParams)
    kc, vc = (_bf(a) for a in cache)
    o, (k2, v2) = tlayers.attention_decode(
        p, _bf(xd), (kc, vc), torch.tensor(6, dtype=torch.int32), 1e6, None,
        0.0, backend="reference")
    want_o, want_k, want_v = jx["decode"]
    assert k2 is kc and o.dtype == torch.bfloat16
    np.testing.assert_array_equal(kc.float().numpy(), want_k)
    np.testing.assert_array_equal(vc.float().numpy(), want_v)
    np.testing.assert_allclose(o.float().numpy(), want_o, rtol=0, atol=ATOL)


def test_bridge_keeps_bf16_leaves_bf16(jx):
    """Fault 5: every leaf became fp32.  A bf16 leaf stays bf16 bit for bit,
    the fp32 leaves (mamba's a_log, d_skip, dt_bias) stay fp32; the ECG
    bridge still makes fp32."""
    tree = jx["mamba2-370m"]["tree"]
    cfg = tconfigs.get_config("mamba2-370m", reduced=True)
    port = bridge.from_numpy_backbone(tree, cfg, device="cpu")
    blk = port["stages"][0][0][0]["mixer"]
    assert port["embed"].table.dtype == blk.in_proj.dtype == torch.bfloat16
    assert blk.a_log.dtype == blk.dt_bias.dtype == torch.float32
    want = np.asarray(tree["stages"][0][0]["mixer"].in_proj)[0]
    assert np.array_equal(blk.in_proj.view(torch.int16).numpy(),
                          want.view(np.int16))
    w = np.asarray(jnp.ones((4, 1, 8), BF16))
    ecg = bridge.from_numpy_params(
        {"encoder": [(w, np.asarray(jnp.ones((4, 8, 8), BF16)),
                      np.zeros((4, 8), np.float32))],
         "head": (np.ones((8, 3), np.float32), np.zeros(3, np.float32))},
        device="cpu")
    assert isinstance(ecg["encoder"][0], tcells.LSTMParams)
    assert ecg["encoder"][0].wx.dtype == torch.float32


# -- the plain kernels at bf16 against interpret-mode Pallas -----------------

ROWS = np.asarray([0, 5, 2 ** 31 + 4, 9, 2 ** 31 - 1, 40, 7, 11], np.uint32)


def _key():
    return int(np.asarray(jmcd.mask_key(3, 1, jmcd.KIND_FEAT, 0)))


def _jkey():
    return jnp.uint32(_key())


def _rows_t():
    return torch.from_numpy(ROWS.astype(np.int64))


@pytest.mark.parametrize("p", [0.1, 0.0])
def test_masked_activation_plain_bf16_is_the_pallas_kernel(p):
    x = _randn(10, (len(ROWS), 64))
    want = jmask.masked_activation(x, jnp.asarray(ROWS), _jkey(), p)
    got = tmask.masked_activation_plain(_bf(x), _rows_t(), _key(), p)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_mcd_matmul_plain_bf16_is_the_pallas_kernel():
    x, w = _randn(11, (len(ROWS), 64)), _randn(12, (64, 32), k=0.125)
    want = jmm.mcd_matmul(x, w, jnp.asarray(ROWS), _jkey(), 0.1)
    got = tmm.mcd_matmul_plain(_bf(x), _bf(w), _rows_t(), _key(), 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_decode_attention_plain_bf16_matches_the_pallas_kernel(pos):
    q, kc, vc = (_randn(13 + i, s) for i, s in
                 enumerate(((3, 4, 16), (3, 24, 2, 16), (3, 24, 2, 16))))
    want = jattn.decode_attention(q, kc, vc, jnp.int32(pos), block_s=8)
    got = tattn.decode_attention_plain(_bf(q), _bf(kc), _bf(vc), pos)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0,
                               atol=2e-6)


def test_ssd_chunk_scan_plain_bf16_matches_the_pallas_kernel():
    r = np.random.default_rng(16)
    f = np.float32
    x = _randn(17, (2, 32, 4, 8))
    dt = jnp.asarray(np.logaddexp(r.standard_normal((2, 32, 4)), 0.0)
                     .astype(f))
    a = jnp.asarray(-np.exp(r.standard_normal(4) * 0.3).astype(f))
    bm, cm = _randn(18, (2, 32, 16), k=0.3), _randn(19, (2, 32, 16), k=0.3)
    d = jnp.asarray(np.linspace(0.5, 1.5, 4).astype(f))
    wy, wh = jssd.ssd_chunk_scan(x, dt, a, bm, cm, d, q_chunk=8, block_h=2)
    y, h = tssd.ssd_chunk_scan_plain(
        _bf(x), torch.from_numpy(np.array(dt)),
        torch.from_numpy(np.array(a)), _bf(bm), _bf(cm),
        torch.from_numpy(np.array(d)), q_chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_array_equal(y.float().numpy(), _np(wy))
    np.testing.assert_allclose(h.numpy(), _np(wh), rtol=0, atol=5e-7)


# -- the int8 KV cache --------------------------------------------------------

def test_quantize_kv_is_the_compiled_reference(jx):
    kv, want_codes, want_scales = jx["quant"]
    codes, scales = tlayers.quantize_kv(_bf(kv))
    assert codes.dtype == torch.int8 and scales.dtype == torch.bfloat16
    assert np.array_equal(codes.numpy(), want_codes)
    assert np.array_equal(scales.float().numpy(), want_scales)
    # half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    v = torch.tensor([0.5, 1.5, 2.5, -2.5, 127.0]).reshape(1, 1, 1, 5)
    codes, _ = tlayers.quantize_kv(v)
    assert codes.reshape(-1).tolist() == [0, 2, 2, -2, 127]


def test_int8_decode_state_has_the_reference_shapes(jx):
    cfg = tconfigs.get_config("qwen3-1.7b", reduced=True)
    st = tbb.init_decode_state(cfg, S * B, MAX_LEN, kv_quant=True,
                               device="cpu")
    jst = jx["qwen3-1.7b"]["int8_state"]
    got = [t for stage in st.caches for rep in stage for c in rep for t in c]
    want = [np.asarray(a)[r] for stage in jst.caches for c in stage
            for r in range(cfg.stages[0].repeat) for a in c]
    assert len(got) == len(want) == 4 * cfg.num_layers
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == w.dtype.name
        assert not g.any()
    assert len({t.data_ptr() for t in got}) == len(got)   # each its own
    assert tbb.cache_positions(cfg, st.caches) == MAX_LEN


# -- the models ---------------------------------------------------------------

def _port_logits(jx, arch, backend, quant=False):
    cfg = tconfigs.get_config(arch, reduced=True)
    port = bridge.from_numpy_backbone(jx[arch]["tree"], cfg, device="cpu")
    ctx = _tctx()
    if quant:
        st = tbb.init_decode_state(cfg, S * B, MAX_LEN, kv_quant=True,
                                   device="cpu")
        out, toks = [], DECODE
    else:
        lg, st = tbb.prefill(port, cfg, torch.from_numpy(TOKENS), ctx,
                             MAX_LEN, backend=backend)
        out, toks = [lg], DECODE[:3]
    for tok in toks:
        lg, st = tbb.decode_step(port, cfg, torch.from_numpy(tok), st, ctx,
                                 backend=backend)
        out.append(lg)
    return [t.numpy() for t in out]


def _atol(arch, backend):
    return CUDA_BF16_ATOL if (arch, backend) == ("qwen3-1.7b", "cuda") \
        else ATOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_jax(jx, arch, backend):
    got = _port_logits(jx, arch, backend)
    want = jx[arch]["logits"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=_atol(arch, backend))
    # the prefill has no decode attention: every backend within ATOL there
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_int8_kv_decode_matches_jax(jx, backend):
    got = _port_logits(jx, "qwen3-1.7b", backend, quant=True)
    want = jx["qwen3-1.7b"]["int8"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=_atol("qwen3-1.7b", backend))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)


# -- the engine at bf16 -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_bf16_decode_step_equals_eager(jx, arch):
    """The decode step through the engine's static buffers (the CUDA
    graph's, run without capture on the CPU) equals the eager engine bit
    for bit at bf16, with a bf16 KV cache or a bf16 conv state beside the
    fp32 SSM state."""
    cfg = tconfigs.get_config(arch, reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=2))
    port = bridge.from_numpy_backbone(jx[arch]["tree"], cfg, device="cpu")
    prompts = TOKENS[:2, :6]
    runs = [BayesianEngine(port, cfg, max_len=10, seed=1, device="cpu",
                           graphs=g).generate(prompts, 3, keep_logits=True)
            for g in (True, False)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert torch.equal(runs[0].logits, runs[1].logits)
    eng = BayesianEngine(port, cfg, max_len=10, seed=1, device="cpu")
    eng.generate(prompts, 1)
    (entry,) = eng._graphs.values()
    cache = entry.state.caches[0][0][0]
    if arch == "mamba2-370m":
        assert cache.ssm.dtype == torch.float32
        assert cache.conv.dtype == torch.bfloat16
    else:
        assert [t.dtype for t in cache] == [torch.bfloat16] * 2


def test_init_params_stays_fp32_by_default():
    cfg = tconfigs.get_config("qwen3-1.7b", reduced=True)
    p = tbb.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].table.dtype == torch.float32
    p = tbb.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    assert p["stages"][0][0][0]["ffn"].wi.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_bf16_on_cpu(capsys, arch):
    from repro_torch.launch import serve as tserve
    res = tserve.main(["--device", "cpu", "--arch", arch, "--dtype", "bf16",
                       "--batch", "2", "--prompt-len", "5", "--new-tokens",
                       "3", "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    assert torch.isfinite(res.predictive_entropy).all()
    assert "dtype=bf16" in capsys.readouterr().out
