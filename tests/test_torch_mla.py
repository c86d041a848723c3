"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX reference's (``repro.models.mla``), at deepseek-v2-lite's
REDUCED widths (d_model 64, 4 heads, kv_lora 32, rope 8, nope 16, v 16).

JAX's ``init_mla`` parameters (fp32 and bf16) are carried across as
numpy; the same numpy-seeded inputs and MC context go through both:
``mla_forward`` with its cache over an 8-position prompt, then three
absorbed ``mla_decode`` steps from that cache padded to 12 positions.  On
both port backends: fp32 within 1e-5; bf16 (JAX compiled without excess
precision, as ``test_torch_lm_precision.py``) within 1e-5 plus one bf16
ulp on all but 0.5% of the elements (a bf16 rounding upstream may go to
the other neighbour).  Also: decode writes the latent into the cache in
place at the device ``pos`` and nowhere else, and what the cache holds
past ``pos`` does not move the output.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mcd as jmcd  # noqa: E402
from repro.models import layers as jlayers, mla as jmla  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.models import layers as tlayers, mla as tmla  # noqa: E402

ATOL = 1e-5
ARCH = "deepseek-v2-lite-16b"
JCFG = jconfigs.get_config(ARCH, reduced=True)
TCFG = tconfigs.get_config(ARCH, reduced=True)
B, S, L, MAX_LEN, SEED, LAYER = 2, 2, 8, 12, 5, 1
THETA = JCFG.rope_theta
OPTS = {"xla_allow_excess_precision": False}
_rng = np.random.default_rng(0)
X = _rng.standard_normal((S * B, L, 64)).astype(np.float32)
XD = _rng.standard_normal((3, S * B, 1, 64)).astype(np.float32)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _jmask(dtype):
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, JCFG.mcd)
    return jlayers.site_mask(ctx, True, LAYER, jlayers.SITE_ATTN, 64, dtype)


def _tmask():
    ctx = tlayers.Ctx(tmcd.sample_rows(B, S), SEED, TCFG.mcd)
    return tlayers.site_mask(ctx, True, LAYER, tlayers.SITE_ATTN)


def _jax_run(dtype):
    """JAX: the prefill (out, cache) and three decode steps (out each, the
    final cache), compiled without excess precision."""
    p = jmla.init_mla(jax.random.key(4), 64, JCFG.num_heads, JCFG.mla, dtype)
    m = _jmask(dtype)
    x = jnp.asarray(X).astype(dtype)
    fwd = jax.jit(lambda p, x, m: jmla.mla_forward(
        p, x, jnp.arange(L), THETA, JCFG.mla, m, 0.1,
        return_cache=True)).lower(p, x, m).compile(compiler_options=OPTS)
    out, cache = fwd(p, x, m)
    pad = ((0, 0), (0, MAX_LEN - L), (0, 0))
    cache = jmla.MLACache(jnp.pad(cache.c_kv, pad), jnp.pad(cache.k_rope,
                                                             pad))
    step = jax.jit(lambda p, x, c, i, m: jmla.mla_decode(
        p, x, c, i, THETA, JCFG.mla, m, 0.1)).lower(
        p, jnp.asarray(XD[0]).astype(dtype), cache, jnp.int32(L), m).compile(
        compiler_options=OPTS)
    outs = []
    for i, xd in enumerate(XD):
        o, cache = step(p, jnp.asarray(xd).astype(dtype), cache,
                        jnp.int32(L + i), m)
        outs.append(_np(o))
    return {"params": jax.tree.map(np.asarray, p), "out": _np(out),
            "decode": outs, "cache": [_np(a) for a in cache]}


@pytest.fixture(scope="module")
def ref():
    return {name: _jax_run(jd) for name, (jd, _) in DTYPES.items()}


def _params(tree):
    return tmla.MLAParams(*(_t(a) for a in tree))


def _close(got, want, bf16):
    got = got.float().numpy()
    if not bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    far = np.abs(got - want) > ATOL + ulp
    assert far.mean() <= 5e-3, (far.sum(), np.abs(got - want).max())


def _port_run(ref, dtype, backend):
    td = DTYPES[dtype][1]
    p = _params(ref[dtype]["params"])
    out, cache = tmla.mla_forward(p, torch.from_numpy(X).to(td),
                                  torch.arange(L), THETA, TCFG.mla, _tmask(),
                                  0.1, return_cache=True, backend=backend)
    full = tmla.init_cache(S * B, MAX_LEN, TCFG.mla, td)
    full.c_kv[:, :L] = cache.c_kv
    full.k_rope[:, :L] = cache.k_rope
    outs = []
    for i, xd in enumerate(XD):
        o, full = tmla.mla_decode(p, torch.from_numpy(xd).to(td), full,
                                  torch.tensor(L + i, dtype=torch.int32),
                                  THETA, TCFG.mla, _tmask(), 0.1, backend)
        outs.append(o)
    return out, cache, outs, full


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_forward_and_three_decode_steps_match_jax(ref, backend, dtype):
    bf16 = dtype == "bf16"
    out, cache, outs, full = _port_run(ref, dtype, backend)
    assert out.dtype == DTYPES[dtype][1] and out.shape == X.shape
    _close(out, ref[dtype]["out"], bf16)
    for got, want in zip(outs, ref[dtype]["decode"]):
        assert got.shape == (S * B, 1, 64)
        _close(got, want, bf16)
    for got, want in zip(full, ref[dtype]["cache"]):
        _close(got, want, bf16)
    assert not full.c_kv[:, L + len(XD):].any()


def test_decode_writes_in_place_at_the_device_pos(ref):
    p = _params(ref["fp32"]["params"])
    cache = tmla.init_cache(S * B, MAX_LEN, TCFG.mla, torch.float32)
    cache.c_kv.normal_(generator=torch.Generator().manual_seed(1))
    cache.k_rope.normal_(generator=torch.Generator().manual_seed(2))
    before = [a.clone() for a in cache]
    ptrs = [a.data_ptr() for a in cache]
    pos = torch.tensor(5, dtype=torch.int32)
    _, got = tmla.mla_decode(p, torch.from_numpy(XD[0]), cache, pos, THETA,
                             TCFG.mla, None, 0.1)
    assert got is cache and [a.data_ptr() for a in got] == ptrs
    for a, b in zip(got, before):
        assert not torch.equal(a[:, 5], b[:, 5])
        assert torch.equal(a[:, :5], b[:, :5])
        assert torch.equal(a[:, 6:], b[:, 6:])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_positions_past_pos_do_not_move_the_output(ref, backend):
    p = _params(ref["fp32"]["params"])
    g = torch.Generator().manual_seed(3)
    base = tmla.init_cache(S * B, MAX_LEN, TCFG.mla, torch.float32)
    base.c_kv[:, :7].normal_(generator=g)
    base.k_rope[:, :7].normal_(generator=g)
    junk = tmla.MLACache(*(a.clone() for a in base))
    junk.c_kv[:, 8:] = 1e4
    junk.k_rope[:, 8:] = -3e3
    pos = torch.tensor(7, dtype=torch.int32)
    a, _ = tmla.mla_decode(p, torch.from_numpy(XD[1]), base, pos, THETA,
                           TCFG.mla, _tmask(), 0.1, backend)
    b, _ = tmla.mla_decode(p, torch.from_numpy(XD[1]), junk, pos, THETA,
                           TCFG.mla, _tmask(), 0.1, backend)
    assert torch.equal(a, b)


def test_init_mla_is_seeded_and_at_the_reference_scales():
    a = tmla.init_mla(torch.Generator().manual_seed(1), 64, 4, TCFG.mla,
                      torch.float32)
    b = tmla.init_mla(torch.Generator().manual_seed(1), 64, 4, TCFG.mla,
                      torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.wq.shape == (64, 4, 24) and a.w_uk.shape == (32, 4, 16)
    assert abs(a.w_uv.std().item() - 32 ** -0.5) < 0.02
    assert torch.equal(a.kv_norm, torch.ones(32))
