"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``).

Parameters come from JAX's ``init_moe`` at the REDUCED widths of
olmoe-1b-7b (8 experts top-2, d_ff_expert 32) and deepseek-v2-lite-16b
(the same with one shared expert), carried across as numpy; the same
numpy-seeded activations (4 rows x 16 positions: 64 tokens) and MC context
go through both.  Compared, on both port backends ("cuda" runs the
site mask's plain version on CPU tensors):

* ``moe_forward``'s y and aux, with and without the site mask, at
  ``capacity_factor`` 8.0 (nothing dropped) and 0.5 (routes dropped), and
  under ``moe_sharding(groups=2)`` (group-local capacity; JAX's
  ``_constrain`` falls through without a mesh): y within 1e-5, aux within
  1e-6;
* ``_dispatch``: the top-k expert ids, ``counts``, ``slot_token`` and the
  dropped routes exactly equal, the gathered expert inputs bitwise, the
  slot weights and probabilities within 1e-6; a zeroed router (every
  probability tied) picks experts 0..k-1 for every token, as
  ``jax.lax.top_k`` does;
* the combine's order: a constructed case whose sum depends on it equals
  the reference's scatter-add (ascending slots from an fp32 zero);
* two calls bitwise equal; and bf16 at the settings of
  ``test_torch_lm_precision.py`` (JAX compiled without excess precision):
  y bitwise but on at most 0.1% of its elements, which may take a bf16
  rounding upstream to the other neighbour.

One JAX pass per case, cached for the module.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mcd as jmcd  # noqa: E402
from repro.models import layers as jlayers, moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.models import layers as tlayers, moe as tmoe  # noqa: E402

ATOL, AUX_ATOL = 1e-5, 1e-6
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
B, S, L, SEED, LAYER = 2, 2, 16, 5, 3
OPTS = {"xla_allow_excess_precision": False}
X = np.random.default_rng(0).standard_normal((S * B, L, 64)).astype(
    np.float32)
FLAT = np.random.default_rng(1).standard_normal((64, 64)).astype(
    np.float32)


def _cfg(arch, cf=None, mod=jconfigs):
    cfg = mod.get_config(arch, reduced=True)
    return (cfg.moe if cf is None else
            dataclasses.replace(cfg.moe, capacity_factor=cf))


def _tcfg(arch, cf=None):
    return _cfg(arch, cf, tconfigs)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a, dtype=torch.float32):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a)).to(dtype)


def _params(jp):
    shared = (None if jp.shared is None else
              tlayers.MLPParams(*(_t(a) for a in jp.shared)))
    return tmoe.MoEParams(_t(jp.router), _t(jp.wi), _t(jp.wo), shared,
                          _t(jp.norm))


def _jmask(dtype=jnp.float32):
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED,
                      jconfigs.get_config(ARCHS[0], reduced=True).mcd)
    return jlayers.site_mask(ctx, True, LAYER, jlayers.SITE_MLP, 64, dtype)


def _tmask():
    ctx = tlayers.Ctx(tmcd.sample_rows(B, S), SEED,
                      tconfigs.get_config(ARCHS[0], reduced=True).mcd)
    return tlayers.site_mask(ctx, True, LAYER, tlayers.SITE_MLP)


FORWARD = [(arch, masked, cf, groups) for arch in ARCHS
           for masked in (True, False) for cf in (8.0, 0.5)
           for groups in (1, 2)]


@pytest.fixture(scope="module")
def ref():
    out = {}
    for arch in ARCHS:
        jp = jmoe.init_moe(jax.random.key(7), 64, _cfg(arch), jnp.float32)
        out[arch] = {"params": jax.tree.map(np.asarray, jp)}
        for _, masked, cf, groups in [c for c in FORWARD if c[0] == arch]:
            m = _jmask() if masked else None
            with jmoe.moe_sharding(groups=groups):
                y, aux = jmoe.moe_forward(jp, jnp.asarray(X), _cfg(arch, cf),
                                          m, 0.1)
            out[arch][masked, cf, groups] = (_np(y), float(aux))
        for cf in (8.0, 0.5):
            cfg = _cfg(arch, cf)
            C = jmoe.capacity(FLAT.shape[0], cfg)
            flat = jnp.asarray(FLAT)
            for tie in (False, True):
                router = jnp.zeros_like(jp.router) if tie else jp.router
                res = jmoe._dispatch(flat * 0.5, flat, router, cfg, C)
                gate = jax.lax.top_k(res[4], cfg.top_k)[1]
                out[arch]["dispatch", cf, tie] = (
                    [_np(a) for a in res], np.asarray(gate), C)
    # bf16, compiled without excess precision
    jp = jmoe.init_moe(jax.random.key(7), 64, _cfg(ARCHS[1], 0.5),
                       jnp.bfloat16)
    xb = jnp.asarray(X).astype(jnp.bfloat16)
    m = _jmask(jnp.bfloat16)
    f = jax.jit(lambda p, x, m: jmoe.moe_forward(
        p, x, _cfg(ARCHS[1], 0.5), m, 0.1)).lower(jp, xb, m).compile(
        compiler_options=OPTS)
    y, aux = f(jp, xb, m)
    out["bf16"] = {"params": jax.tree.map(np.asarray, jp),
                   "y": _np(y), "aux": float(aux)}
    return out


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch,masked,cf,groups", FORWARD)
def test_moe_forward_matches_jax(ref, arch, masked, cf, groups, backend):
    p = _params(ref[arch]["params"])
    want_y, want_aux = ref[arch][masked, cf, groups]
    with tmoe.moe_sharding(groups=groups):
        y, aux = tmoe.moe_forward(p, torch.from_numpy(X), _tcfg(arch, cf),
                                  _tmask() if masked else None, 0.1, backend)
    assert y.shape == X.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
    assert abs(float(aux) - want_aux) <= AUX_ATOL
    assert (p.shared is not None) == (arch == "deepseek-v2-lite-16b")


def _kept(slot_token, C, T):
    """The kept (token, expert) routes of a slot map."""
    return {(int(t), s // C) for s, t in enumerate(slot_token) if t < T}


@pytest.mark.parametrize("tie", [False, True], ids=["router", "tied"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_integers_equal_jax(ref, arch, cf, tie):
    cfg = _tcfg(arch, cf)
    (jx_exp, j_st, j_sw, j_counts, j_probs), j_gate, C = \
        ref[arch]["dispatch", cf, tie]
    p = _params(ref[arch]["params"])
    router = torch.zeros_like(p.router) if tie else p.router
    flat = torch.from_numpy(FLAT)
    x_exp, st, sw, counts, probs = tmoe._dispatch(flat * 0.5, flat, router,
                                                  cfg, C)
    gate = tmoe.top_k(probs, cfg.top_k)[1]
    T, K = FLAT.shape[0], cfg.top_k
    assert np.array_equal(gate.numpy(), j_gate)
    assert np.array_equal(counts.numpy(), j_counts)
    assert np.array_equal(st.numpy(), j_st)
    assert np.array_equal(x_exp.numpy(), jx_exp)
    np.testing.assert_allclose(sw.numpy(), j_sw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), j_probs, rtol=0, atol=1e-6)
    routes = {(t, int(e)) for t in range(T) for e in j_gate[t]}
    kept, j_kept = _kept(st.numpy(), C, T), _kept(j_st, C, T)
    assert kept == j_kept and routes - kept == routes - j_kept
    dropped = len(routes - kept)
    assert dropped == int(np.maximum(j_counts - C, 0).sum())
    if cf == 0.5:
        assert dropped > 0
    else:
        assert dropped == 0 or tie
    if tie:
        assert (gate.numpy() == np.arange(K)).all()
        assert (j_counts[:K] == T).all() and not j_counts[K:].any()


def test_combine_adds_in_slot_order():
    """Token 0 takes four routes whose fp32 sum depends on the order:
    ((0 + 1e8) + 1) + (-1e8) + 1 = 1 in ascending slot order (2 or 0 in
    others); the reference's scatter-add gives the same."""
    E, C, T, K = 4, 2, 1, 4
    vals = np.zeros((E * C, 1), np.float32)
    vals[[0, 2, 4, 6], 0] = [1e8, 1.0, -1e8, 1.0]
    st = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    sw = np.ones(E * C, np.float32)
    want = np.asarray(jnp.zeros((T + 1, 1), jnp.float32).at[st].add(
        jnp.asarray(vals) * jnp.asarray(sw)[:, None])[:T])
    got = tmoe._combine(torch.from_numpy(vals).reshape(E, C, 1),
                        torch.from_numpy(st), torch.from_numpy(sw), T, K)
    assert want[0, 0] == 1.0 and got.numpy()[0, 0] == 1.0
    rev = np.float32(0.0)
    for v in vals[[6, 4, 2, 0], 0]:        # descending slots
        rev = np.float32(rev + v)
    assert rev != 1.0


def test_token_slots_orders_and_pads():
    """Each token's kept slots ascending, then E·C for each dropped
    route; an empty slot (token T) belongs to no token."""
    st = torch.tensor([2, 0, 3, 2, 0, 1, 3, 3])      # T = 3, E·C = 8
    got = tmoe.token_slots(st, 3, 3)
    assert got.tolist() == [[1, 4, 8], [5, 8, 8], [0, 3, 8]]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_calls_are_bitwise_equal(ref, arch):
    p = _params(ref[arch]["params"])
    x = torch.from_numpy(X)
    a = tmoe.moe_forward(p, x, _tcfg(arch, 0.5), _tmask(), 0.1, "cuda")
    b = tmoe.moe_forward(p, x, _tcfg(arch, 0.5), _tmask(), 0.1, "cuda")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_moe_forward_bf16_matches_jax(ref, backend):
    """deepseek REDUCED at bf16, capacity 0.5, masked: y (bf16) bitwise
    JAX's but on at most 0.1% of its elements, and those within 1e-5
    plus 4 bf16 ulps of the output (a bf16 rounding upstream may go to the
    other neighbour -- a bf16 x bf16 -> bf16 product, or silu(g)·u -- and
    the routed and shared outputs then add one ulp of a larger value; 1
    element of 4096 on these inputs), aux within 1e-6."""
    jp = ref["bf16"]["params"]
    p = _params(jp)
    assert p.router.dtype == torch.float32 and p.wi.dtype == torch.bfloat16
    y, aux = tmoe.moe_forward(p, torch.from_numpy(X).bfloat16(),
                              _tcfg(ARCHS[1], 0.5), _tmask(), 0.1, backend)
    assert y.dtype == torch.bfloat16
    want = ref["bf16"]["y"]
    got = y.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert (np.abs(got - want) <= ATOL + 4 * ulp).all()
    assert (got != want).mean() <= 1e-3
    assert abs(float(aux) - ref["bf16"]["aux"]) <= AUX_ATOL


def test_mesh_axes_raise():
    for kw in ({"expert_axis": "model"}, {"token_axes": ("data",)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            with tmoe.moe_sharding(**kw):
                pass


def test_capacity_matches_jax():
    for arch in ARCHS:
        for cf in (0.5, 1.25, 8.0):
            for n in (1, 7, 64, 8192):
                assert tmoe.capacity(n, _tcfg(arch, cf)) == \
                    jmoe.capacity(n, _cfg(arch, cf))
