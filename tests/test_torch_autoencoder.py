"""The port's anomaly autoencoder and regression summary against JAX.

* ``autoencoder.apply`` — LSTM and GRU, full and windowed decode — on the
  port's three backends (on the CPU) against JAX
  ``autoencoder.apply(backend="reference")``, with weights passed through
  the bridge: mean, log-variance, the decoder sequence and every encoder
  state.
* ``regression_summary``, ``regression_nll``, ``rmse``, ``l1`` and
  ``gaussian_nll`` against the reference on the same numpy inputs.
* Inside the port: the windowed decode is bit-equal to the first W
  positions of the full decode.

Tolerance: 1e-5 absolute for fp32 (the JAX backends themselves differ by up
to 1.2e-7).  Sizes are small (H=8, NL=2, T=7) and the JAX side runs four
model passes, cached per module.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, mcd as jmcd  # noqa: E402
from repro.core import uncertainty as junc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, mcd as tmcd  # noqa: E402
from repro_torch.core import uncertainty as tunc  # noqa: E402
from repro_torch.core.cells import GRUParams, LSTMParams  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ATOL = 1e-5
HID, NL, SEED, T, W = 8, 2, 3, 7, 4
ROWS = np.asarray([0, 5, 2 ** 31 + 2, 17, 40, 2 ** 31 - 1], np.uint32)
LENS = np.asarray([7, 3, 5, 1, 7, 6], np.int32)
CASES = [(cell, win) for cell in ("lstm", "gru") for win in (None, W)]


def _cfgs(cell, window):
    kw = dict(hidden=HID, num_layers=NL, cell=cell, decode_window=window)
    return (jae.AutoencoderConfig(**kw, mcd=jmcd.MCDConfig(
                p=0.125, placement="YNYN", n_samples=2, seed=SEED)),
            tae.AutoencoderConfig(**kw, mcd=tmcd.MCDConfig(
                p=0.125, placement="YNYN", n_samples=2, seed=SEED)))


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((len(ROWS), T, 1)).astype(np.float32)
    h0 = [rng.standard_normal((len(ROWS), h)).astype(np.float32) * 0.5
          for h in (HID, HID // 2)]
    return x, h0


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def models():
    """Per cell: the JAX params (numpy tree) and the port's."""
    out = {}
    for cell in ("lstm", "gru"):
        jcfg, _ = _cfgs(cell, None)
        tree = jax.tree.map(np.asarray, jae.init(jax.random.key(1), jcfg))
        out[cell] = (tree, bridge.from_numpy_params(tree, device="cpu"))
    return out


def _initial_state(cell, h0, to):
    """A resumed encoder carry: (h,) per GRU layer, (h, c) per LSTM one."""
    return [tuple(to(a) for a in ((h,) if cell == "gru" else (h, 0.5 * h)))
            for h in h0]


@pytest.fixture(scope="module")
def jax_refs(models):
    x, h0 = _inputs()
    refs = {}
    for cell, win in CASES:
        jcfg, _ = _cfgs(cell, win)
        tree = models[cell][0]
        mean, lv, dec, states = jae.apply(
            tree, jnp.asarray(x), jnp.asarray(ROWS), jcfg,
            backend="reference", lengths=jnp.asarray(LENS),
            initial_state=_initial_state(cell, h0, jnp.asarray),
            return_state=True, return_decoded=True)
        refs[cell, win] = jax.tree.map(np.asarray, (mean, lv, dec, states))
    return refs


def test_bridge_builds_cell_params(models):
    for cell, kind in (("lstm", LSTMParams), ("gru", GRUParams)):
        tree, tparams = models[cell]
        assert set(tparams) == {"encoder", "decoder", "head"}
        for part in ("encoder", "decoder"):
            for jl, tl in zip(tree[part], tparams[part]):
                assert isinstance(tl, kind)
                for a, b in zip(jl, tl):
                    assert np.array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="gates"):
        bridge.from_numpy_params({"encoder": [(np.zeros((2, 1, 4)),) * 3],
                                  "head": (np.zeros((4, 2)), np.zeros(2))},
                                 device="cpu")


@pytest.mark.parametrize("backend", tops.LSTM_BACKENDS)
@pytest.mark.parametrize("cell,win", CASES)
def test_apply_matches_jax_reference(models, jax_refs, cell, win, backend):
    _, tcfg = _cfgs(cell, win)
    x, h0 = _inputs()
    mean, lv, dec, states = tae.apply(
        models[cell][1], torch.from_numpy(x),
        torch.from_numpy(ROWS.astype(np.int64)), tcfg, backend=backend,
        lengths=torch.from_numpy(LENS),
        initial_state=_initial_state(cell, h0, torch.from_numpy),
        return_state=True, return_decoded=True, device="cpu")
    rmean, rlv, rdec, rstates = jax_refs[cell, win]
    width = T if win is None else W
    assert mean.shape == lv.shape == (len(ROWS), width, 1)
    assert dec.shape == (len(ROWS), width, HID)
    assert lv.abs().max() <= 10.0
    for r, g in ((rmean, mean), (rlv, lv), (rdec, dec)):
        _close(r, g)
    assert [h.shape[-1] for h, *_ in states] == [HID, HID // 2]
    for rs, s in zip(rstates, states):
        assert len(s) == len(rs) == (1 if cell == "gru" else 2)
        for r, g in zip(rs, s):
            _close(r, g)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_windowed_decode_is_prefix_bitwise(models, cell):
    _, cfg_w = _cfgs(cell, W)
    cfg_full = dataclasses.replace(cfg_w, decode_window=None)
    x, _ = _inputs()
    rows = torch.from_numpy(ROWS.astype(np.int64))
    lens = torch.from_numpy(LENS)
    params = models[cell][1]
    for backend in ("cuda_step", "cuda_seq"):
        mw, lw = tae.apply(params, torch.from_numpy(x), rows, cfg_w,
                           backend=backend, lengths=lens, device="cpu")
        mf, lf = tae.apply(params, torch.from_numpy(x), rows, cfg_full,
                           backend=backend, lengths=lens, device="cpu")
        assert torch.equal(mw, mf[:, :W]) and torch.equal(lw, lf[:, :W])


def test_config_matches_reference():
    for cell, win in CASES:
        jcfg, tcfg = _cfgs(cell, win)
        assert tcfg.encoder_hiddens == jcfg.encoder_hiddens == (HID, HID // 2)
        assert tcfg.decoder_hiddens == jcfg.decoder_hiddens
    with pytest.raises(ValueError, match="decode_window"):
        tae.AutoencoderConfig(decode_window=0)


def test_init_is_seeded_and_shaped():
    cfg = tae.AutoencoderConfig(cell="gru")
    a = tae.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = tae.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for part in ("encoder", "decoder"):
        for la, lb in zip(a[part], b[part]):
            assert isinstance(la, GRUParams)
            assert all(torch.equal(u, v) for u, v in zip(la, lb))
    assert [lp.wh.shape[-1] for lp in a["encoder"]] == [16, 8]
    assert a["decoder"][0].wx.shape == (3, 8, 16)
    assert a["head"].w.shape == (16, 2)


# -- regression summary and losses -------------------------------------------

def _passes(seed=0, s=5):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((s, 3, T, 2)).astype(np.float32)
    log_vars = rng.uniform(-3, 2, (s, 3, T, 2)).astype(np.float32)
    target = rng.standard_normal((3, T, 2)).astype(np.float32)
    return means, log_vars, target


@pytest.mark.parametrize("hetero", [True, False])
def test_regression_summary_matches_jax(hetero):
    means, log_vars, target = _passes()
    lv = log_vars if hetero else None
    ref = junc.regression_summary(jnp.asarray(means),
                                  None if lv is None else jnp.asarray(lv))
    got = tunc.regression_summary(torch.from_numpy(means),
                                  None if lv is None
                                  else torch.from_numpy(lv))
    assert got._fields == ref._fields
    for r, g in zip(ref, got):
        assert g.shape == (3, T, 2)
        _close(r, g)
    jt, tt = jnp.asarray(target), torch.from_numpy(target)
    for jfn, tfn in ((junc.regression_nll, tunc.regression_nll),
                     (junc.rmse, tunc.rmse), (junc.l1, tunc.l1)):
        _close(jfn(ref, jt), tfn(got, tt))


@pytest.mark.parametrize("hetero", [True, False])
def test_gaussian_nll_matches_jax(hetero):
    means, log_vars, target = _passes(1)
    lv = log_vars[0] if hetero else None
    ref = jae.gaussian_nll(jnp.asarray(means[0]),
                           None if lv is None else jnp.asarray(lv),
                           jnp.asarray(target))
    got = tae.gaussian_nll(torch.from_numpy(means[0]),
                           None if lv is None else torch.from_numpy(lv),
                           torch.from_numpy(target))
    assert got.shape == (3,)
    _close(ref, got)
