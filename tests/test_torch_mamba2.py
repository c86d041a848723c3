"""The port's Mamba2 mixer and SSD scan against the JAX reference.

* ``ssd_chunk_scan_plain`` (the plain version beside the CUDA kernel)
  against JAX ``repro.kernels.ssd_chunk.ssd_chunk_scan`` run in interpret
  mode, as ``tests/test_ssd_kernel.py`` runs it, at (B, L, H, P, N) =
  (2, 32, 4, 8, 16) with q = 8 and (2, 40, 4, 8, 16) with q = 16, which
  shrinks to 10 (the largest divisor of L); ``ops.ssd_scan`` on CPU tensors
  runs it too.
* The port's ``_ssd_chunked`` and ``ops.ssd_scan`` against JAX
  ``mamba2._ssd_chunked`` at L = 40 with chunk 16 (padded to 48, three
  chunks).
* ``_ssd_chunked(..., h0=...)`` against JAX's at mamba2 REDUCED's SSD
  widths across a padded last chunk (``ops.ssd_scan`` takes no ``h0``).
* ``_causal_conv``; ``mamba_forward`` with ``return_state`` and three
  ``mamba_decode`` steps on parameters bridged from JAX
  ``mamba2.init_mamba``, on both port backends ("cuda", which on CPU
  tensors runs the kernels' plain versions, and "reference"), with the
  site mask on (p = 0.1).

Tolerance: 1e-5 absolute on fp32 (the same sums in another order; the
JAX kernel test's own is 3e-4).  Inputs are numpy-made from a seed; each
JAX reference is computed once per module.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import mcd as jmcd  # noqa: E402
from repro.kernels import ssd_chunk as jssd  # noqa: E402
from repro.models import layers as jlayers, mamba2 as jmamba  # noqa: E402
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_chunk as tssd  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402

ATOL = 1e-5
CFG = jconfigs.get_config("mamba2-370m", reduced=True)
SSM, D = CFG.ssm, CFG.d_model
B, S, L, SEED, LAYER = 2, 2, 40, 4, 1
SCAN_CASES = [(2, 32, 4, 8, 16, 8), (2, 40, 4, 8, 16, 16)]


def _scan_inputs(Bn, Ln, H, P, N, seed=0):
    """The JAX kernel test's distributions, drawn with numpy."""
    r = np.random.default_rng(seed)

    def f(a):
        return np.asarray(a, np.float32)

    x = f(r.standard_normal((Bn, Ln, H, P)))
    dt = f(np.logaddexp(r.standard_normal((Bn, Ln, H)), 0.0))
    a = f(-np.exp(r.standard_normal(H) * 0.3))
    bm = f(r.standard_normal((Bn, Ln, N)) * 0.3)
    cm = f(r.standard_normal((Bn, Ln, N)) * 0.3)
    d = f(np.linspace(0.5, 1.5, H))
    return x, dt, a, bm, cm, d


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def pallas():
    """JAX's interpret-mode Pallas kernel at each case."""
    out = {}
    for case in SCAN_CASES:
        *shape, q = case
        ins = _scan_inputs(*shape)
        y, h = jssd.ssd_chunk_scan(*(jnp.asarray(a) for a in ins),
                                   q_chunk=q, block_h=2)
        out[case] = (ins, np.asarray(y), np.asarray(h))
    return out


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ssd_chunk_scan_plain_matches_the_pallas_kernel(pallas, case):
    ins, want_y, want_h = pallas[case]
    q = case[-1]
    y, h = tssd.ssd_chunk_scan_plain(*_t(*ins), q_chunk=q)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, want_y)
    _close(h, want_h)
    # the wrapper on CPU tensors is the plain version
    y2, h2 = tssd.ssd_chunk_scan(*_t(*ins), q_chunk=q)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_chunk_length_is_the_largest_divisor():
    assert [tcommon.largest_divisor(L_, q) for L_, q in
            [(32, 8), (40, 16), (320, 256), (512, 256), (7, 16), (13, 4)]] \
        == [8, 10, 160, 256, 7, 1]


def test_ssd_plain_has_no_nan_where_the_decay_overflows():
    """Fast heads: cs falls by ~400 within a chunk, so exp(cs_q - cs_k)
    above the diagonal is inf; the plain version selects 0 there."""
    x, dt, a, bm, cm, d = _t(*_scan_inputs(1, 64, 2, 8, 16, seed=3))
    a = torch.tensor([-16.0, -1.0])
    dt = torch.full_like(dt, 0.4)
    y, h = tssd.ssd_chunk_scan_plain(x, dt, a, bm, cm, d, q_chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert not torch.isfinite(torch.exp(torch.tensor(64 * 6.4))).item()


@pytest.fixture(scope="module")
def chunked():
    """JAX ``_ssd_chunked`` at L = 40, chunk 16 (pads to 48)."""
    x, dt, a, bm, cm, d = _scan_inputs(2, L, 4, 8, 16, seed=1)
    bm4, cm4 = bm[:, :, None, :], cm[:, :, None, :]
    y, h = jmamba._ssd_chunked(*(jnp.asarray(v) for v in
                                 (x, dt, a, bm4, cm4, d)), 16)
    return (x, dt, a, bm4, cm4, d), np.asarray(y), np.asarray(h)


@pytest.mark.parametrize("fn", ["_ssd_chunked", "ops.ssd_scan"])
def test_chunked_scan_matches_jax(chunked, fn):
    ins, want_y, want_h = chunked
    scan = tmamba._ssd_chunked if fn == "_ssd_chunked" else tops.ssd_scan
    y, h = scan(*_t(*ins), 16)
    assert y.shape == (2, L, 4, 8) and h.shape == (2, 4, 8, 16)
    _close(y, want_y)
    _close(h, want_h)


def test_ssd_chunked_h0_raises():
    """``_ssd_chunked`` takes a carried-in state (below); ``ops.ssd_scan``
    and its kernel take none, as the TPU kernel takes none."""
    x, dt, a, bm, cm, d = _t(*_scan_inputs(1, 8, 2, 4, 4))
    with pytest.raises(TypeError, match="h0"):
        tops.ssd_scan(x, dt, a, bm[:, :, None], cm[:, :, None], d, 4,
                      h0=torch.zeros((1, 2, 4, 4)))


@pytest.fixture(scope="module")
def chunked_h0():
    """JAX ``_ssd_chunked(..., h0=...)`` at mamba2 REDUCED's SSD widths,
    L = 40 at its chunk (pads the last chunk), from a random state."""
    H, P = SSM.expand * D // SSM.head_dim, SSM.head_dim
    x, dt, a, bm, cm, d = _scan_inputs(2, L, H, P, SSM.d_state, seed=5)
    ins = (x, dt, a, bm[:, :, None, :], cm[:, :, None, :], d)
    h0 = np.random.default_rng(6).standard_normal(
        (2, H, P, SSM.d_state)).astype(np.float32)
    y, h = jmamba._ssd_chunked(*(jnp.asarray(v) for v in ins), SSM.chunk,
                               h0=jnp.asarray(h0))
    return ins, h0, np.asarray(y), np.asarray(h)


def test_ssd_chunked_h0_matches_jax(chunked_h0):
    """The carried-in state starts the inter-chunk recurrence, as the
    reference's ``h_init``; a zero state is no state, bit for bit, and a
    scan split in two with the first part's final state carried in ends
    where the whole scan ends."""
    ins, h0, want_y, want_h = chunked_h0
    assert L % SSM.chunk
    t = _t(*ins)
    y, h = tmamba._ssd_chunked(*t, SSM.chunk, h0=torch.from_numpy(h0))
    _close(y, want_y)
    _close(h, want_h)
    y0, h_0 = tmamba._ssd_chunked(*t, SSM.chunk)
    yz, hz = tmamba._ssd_chunked(*t, SSM.chunk, h0=torch.zeros_like(h_0))
    assert torch.equal(y0, yz) and torch.equal(h_0, hz)
    cut = 2 * SSM.chunk
    first = [v[:, :cut] if v.dim() > 1 else v for v in t]
    rest = [v[:, cut:] if v.dim() > 1 else v for v in t]
    y1, h1 = tmamba._ssd_chunked(*first, SSM.chunk)
    y2, h2 = tmamba._ssd_chunked(*rest, SSM.chunk, h0=h1)
    _close(torch.cat([y1, y2], dim=1), y0)
    _close(h2, h_0)


def test_causal_conv_matches_jax():
    r = np.random.default_rng(2)
    xbc = r.standard_normal((3, 9, 12)).astype(np.float32)
    w = (r.standard_normal((12, 4)) * 0.5).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    want = np.asarray(jmamba._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                          jnp.asarray(b)))
    got = tmamba._causal_conv(*_t(xbc, w, b)).numpy()
    _close(got, want)
    # a sequence shorter than the taps
    short = tmamba._causal_conv(*_t(xbc[:, :2], w, b)).numpy()
    _close(short, want[:, :2])


@pytest.fixture(scope="module")
def block():
    """JAX init_mamba's parameters; mamba_forward (return_state) and three
    mamba_decode steps, the site mask on."""
    params = jmamba.init_mamba(jax.random.key(3), D, SSM, jnp.float32)
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, CFG.mcd)
    m = jlayers.site_mask(ctx, True, LAYER, jlayers.SITE_MIXER, D,
                          jnp.float32)
    r = np.random.default_rng(5)
    x = r.standard_normal((S * B, L, D)).astype(np.float32)
    steps = r.standard_normal((3, S * B, 1, D)).astype(np.float32)
    out, st = jmamba.mamba_forward(params, jnp.asarray(x), SSM, m,
                                   CFG.mcd.p, D, return_state=True)
    ref = {"params": jax.tree.map(np.asarray, params), "x": x,
           "steps": steps, "forward": np.asarray(out),
           "state": (np.asarray(st.ssm), np.asarray(st.conv)), "decode": []}
    for xt in steps:
        y, st = jmamba.mamba_decode(params, jnp.asarray(xt), st, SSM, m,
                                    CFG.mcd.p, D)
        ref["decode"].append((np.asarray(y), np.asarray(st.ssm),
                              np.asarray(st.conv)))
    return ref


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_mamba_forward_and_decode_match_jax(block, backend):
    p = tmamba.MambaParams(*_t(*block["params"]))
    ctx = tlayers.Ctx(tmcd.sample_rows(B, S), SEED, CFG.mcd)
    m = tlayers.site_mask(ctx, True, LAYER, tlayers.SITE_MIXER)
    out, st = tmamba.mamba_forward(p, torch.from_numpy(block["x"]), SSM, m,
                                   CFG.mcd.p, D, return_state=True,
                                   backend=backend)
    _close(out, block["forward"])
    _close(st.ssm, block["state"][0])
    _close(st.conv, block["state"][1])
    for xt, (want, ssm, conv) in zip(block["steps"], block["decode"]):
        y, st2 = tmamba.mamba_decode(p, torch.from_numpy(xt), st, SSM, m,
                                     CFG.mcd.p, D, backend)
        assert st2 is st                  # updated in place
        _close(y, want)
        _close(st.ssm, ssm)
        _close(st.conv, conv)
    # no mask: a different block output
    plain = tmamba.mamba_forward(p, torch.from_numpy(block["x"]), SSM, None,
                                 0.0, D, backend=backend)
    assert not np.allclose(plain.numpy(), block["forward"], atol=1e-3)


def test_init_mamba_is_seeded_and_at_the_reference_scales():
    a = tmamba.init_mamba(torch.Generator().manual_seed(1), D, SSM,
                          torch.float32, "cpu")
    b = tmamba.init_mamba(torch.Generator().manual_seed(1), D, SSM,
                          torch.float32, "cpu")
    ref = jmamba.init_mamba(jax.random.key(0), D, SSM, jnp.float32)
    for name, got, want in zip(tmamba.MambaParams._fields, a, ref):
        assert tuple(got.shape) == np.shape(want), name
    assert torch.equal(a.in_proj, b.in_proj)
    assert abs(a.in_proj.std().item() - D ** -0.5) < 0.01
    for name in ("a_log", "d_skip", "dt_bias"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-7)
