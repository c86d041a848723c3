"""The design-space exploration in the port (``repro_torch.dse``) held
against the JAX package's ``repro.dse`` on the CPU.

* **FPGA model and search** (pure Python on both sides): ``dsp_usage``,
  ``fits``, ``latency_s`` and ``best_reuse_factors`` on a grid of archs
  (both cells, both kinds, every weight width), ``optimize`` for every mode
  in ``MODES`` with and without requirements (the FPGA gate, and the
  roofline with ``hw_model=None``), and ``pareto_front``: exactly equal.
* **The roofline** (``gpu_model`` against ``tpu_model``'s recurrent half):
  ``rnn_step_model``'s ``flops`` and ``bytes`` exactly equal over both
  cells, both kinds, ``weight_bits`` in {32, 16, 8, 4}, ``data`` in {1, 4}
  and fractional rows, at the H100's peaks; with the peaks set to the
  reference's, every term and ``rnn_latency_s`` bit-equal.
* **Calibration**: with the reference's peaks, ``tick_raw_seconds``,
  ``fit_roofline`` and ``latency_model`` bit-equal to JAX's on windows of
  ``TickMetrics`` numpy builds from a seed — varying shapes, a degenerate
  (one-shape) window, a negative-overhead window, a non-positive slope and
  one below ``min_ticks``.

No JAX program is compiled here: both packages' DSE modules are pure
Python.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.dse import calibrate as jcal  # noqa: E402
from repro.dse import fpga_model as jfm  # noqa: E402
from repro.dse import search as jsearch, tpu_model  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch.dse import calibrate as tcal  # noqa: E402
from repro_torch.dse import fpga_model as tfm  # noqa: E402
from repro_torch.dse import gpu_model, search as tsearch  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

#: The reference's roofline peaks (``repro.launch.analysis``).
REF_PEAKS = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9}


@pytest.fixture
def ref_peaks(monkeypatch):
    """The port's roofline priced at the reference's peaks."""
    for name, value in REF_PEAKS.items():
        monkeypatch.setattr(gpu_model, name, value)


def _arch(mod, hidden, layers, kind, cell, bits, timesteps=140):
    placement = "YN" * layers
    return mod.RNNArch(hidden=hidden, num_layers=layers,
                       placement=placement[:layers], kind=kind, cell=cell,
                       weight_bits=bits, input_dim=1,
                       output_dim=4 if kind == "classifier" else 1,
                       timesteps=timesteps)


ARCHS = [(h, nl, kind, cell, bits)
         for h in (4, 8, 16) for nl in (1, 2, 3)
         for kind in ("classifier", "autoencoder")
         for cell in ("lstm", "gru") for bits in (32, 16, 8, 4)]
HWS = [(1, 1, 1), (12, 1, 1), (16, 5, 16), (3, 7, 2)]


@pytest.mark.parametrize("h,nl,kind,cell,bits", ARCHS)
def test_fpga_model_equals_jax(h, nl, kind, cell, bits):
    ja, ta = (_arch(m, h, nl, kind, cell, bits) for m in (jfm, tfm))
    assert ta.layer_dims() == ja.layer_dims()
    for r in HWS:
        jh, th = jfm.HwConfig(*r), tfm.HwConfig(*r)
        assert tfm.dsp_usage(ta, th) == jfm.dsp_usage(ja, jh)
        assert tfm.fits(ta, th) == jfm.fits(ja, jh)
        for batch, s in ((1, 1), (50, 30), (3, 7)):
            assert tfm.latency_s(ta, th, batch=batch, n_samples=s) \
                == jfm.latency_s(ja, jh, batch=batch, n_samples=s)


@pytest.mark.parametrize("h,nl,kind,cell", [
    (8, 3, "classifier", "lstm"), (16, 2, "autoencoder", "lstm"),
    (8, 3, "classifier", "gru"), (32, 2, "autoencoder", "gru"),
    (2048, 3, "classifier", "lstm")])
def test_best_reuse_factors_equal_jax(h, nl, kind, cell):
    ja, ta = (_arch(m, h, nl, kind, cell, 16) for m in (jfm, tfm))
    want, got = jfm.best_reuse_factors(ja), tfm.best_reuse_factors(ta)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_constants_equal_jax():
    for name in ("DSP_TOTAL_ZC706", "CLOCK_HZ", "HLS_MARGIN", "II_TAIL_AE",
                 "II_TAIL_CLF", "PIPELINE_FILL", "CELL_GATES",
                 "DSP_PER_MAC"):
        assert getattr(tfm, name) == getattr(jfm, name), name
    assert tsearch.MODES == jsearch.MODES
    assert tsearch.MAXIMIZE == jsearch.MAXIMIZE
    assert tsearch.MINIMIZE == jsearch.MINIMIZE


# ---------------------------------------------------------------------------
# search.optimize / pareto_front
# ---------------------------------------------------------------------------

def _table(mod, fm, seed):
    """A lookup table of random (arch, metrics) rows, some Bayesian, some
    GRU, one too large for the ZC706."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(10):
        nl = int(rng.integers(1, 4))
        placement = "".join(rng.choice(["Y", "N"], nl))
        kind = ["classifier", "autoencoder"][int(rng.integers(2))]
        arch = fm.RNNArch(hidden=int(rng.choice([4, 8, 16, 2048 if k == 9
                                                 else 8])),
                          num_layers=nl, placement=placement, kind=kind,
                          weight_bits=int(rng.choice([32, 16, 8, 4])),
                          output_dim=4 if kind == "classifier" else 1)
        metrics = {m: float(rng.random())
                   for m in ("accuracy", "ap", "ar", "auc", "entropy",
                             "precision", "recall", "nll", "rmse")}
        rows.append(mod.Candidate(
            arch=arch, metrics=metrics, n_samples=int(rng.integers(1, 31)),
            cell=["lstm", "gru", None][int(rng.integers(3))]))
    return rows


def _cand(c):
    if c is None:
        return None
    hw = None if c.hw is None else dataclasses.astuple(c.hw)
    return (dataclasses.astuple(c.arch), c.metrics, c.n_samples, c.cell, hw,
            c.latency_s)


REQUIREMENTS = [None, {"accuracy": 0.3}, {"latency": 0.05, "entropy": 0.2},
                {"rmse": 0.5, "ap": 0.1}, {"accuracy": 2.0}]


#: Each package's reuse-factor search, memoized per arch: the FPGA stage
#: takes ~0.2 s an arch, and every mode prices the same tables.
_REUSE = {fm: functools.lru_cache(maxsize=None)(fm.best_reuse_factors)
          for fm in (jfm, tfm)}


@pytest.mark.parametrize("mode", sorted(jsearch.MODES) + ["rmse", "nll"])
@pytest.mark.parametrize("req", range(len(REQUIREMENTS)))
@pytest.mark.parametrize("flow", ["fpga", "gpu"])
def test_optimize_equals_jax(mode, req, flow, ref_peaks):
    kw = {"requirements": REQUIREMENTS[req], "batch": 4}
    jkw, tkw = dict(kw), dict(kw)
    if flow == "gpu":
        jkw.update(latency_model=tpu_model.rnn_latency_s, hw_model=None)
        tkw.update(latency_model=gpu_model.rnn_latency_s, hw_model=None)
    else:
        jkw.update(hw_model=_REUSE[jfm])
        tkw.update(hw_model=_REUSE[tfm])
    for seed in range(3):
        want = jsearch.optimize(_table(jsearch, jfm, seed), mode, **jkw)
        got = tsearch.optimize(_table(tsearch, tfm, seed), mode, **tkw)
        assert _cand(got) == _cand(want), (mode, seed)


@pytest.mark.parametrize("mode", ["Opt-Latency", "Opt-Accuracy"])
def test_optimize_default_fpga_stage_equals_jax(mode):
    """The default hardware stage (the ``_FPGA_FIT`` sentinel: the paper's
    reuse-factor search), on a table with a row no reuse fits."""
    want = jsearch.optimize(_table(jsearch, jfm, 0)[7:], mode)
    got = tsearch.optimize(_table(tsearch, tfm, 0)[7:], mode)
    assert _cand(got) == _cand(want) and got is not None
    big = [m.Candidate(arch=fm.RNNArch(2048, 3, "Y"), metrics={})
           for m, fm in ((jsearch, jfm), (tsearch, tfm))]
    assert jsearch.optimize(big[:1], mode) is None
    assert tsearch.optimize(big[1:], mode) is None


def test_optimize_without_a_stage_names_the_gpu_model():
    with pytest.raises(ValueError, match="gpu_model.rnn_latency_s"):
        tsearch.optimize(_table(tsearch, tfm, 0), "Opt-Latency",
                         hw_model=None)


@pytest.mark.parametrize("x,y", [("entropy", "accuracy"),
                                 ("latency", "accuracy"), ("rmse", "auc")])
def test_pareto_front_equals_jax(x, y):
    for seed in range(3):
        jt, tt = _table(jsearch, jfm, seed), _table(tsearch, tfm, seed)
        for jc, tc, lat in zip(jt, tt, np.linspace(1e-3, 1e-2, len(jt))):
            jc.latency_s = tc.latency_s = float(lat)
        want = [_cand(c) for c in jsearch.pareto_front(jt, x, y)]
        assert [_cand(c) for c in tsearch.pareto_front(tt, x, y)] == want
        assert want


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

ROWS = [(1, 1), (64, 30), (2.5, 3.3), (7, 0.4)]


@pytest.mark.parametrize("h,nl,kind,cell,bits", ARCHS[::3])
@pytest.mark.parametrize("data", [1, 4])
def test_step_model_counts_equal_jax(h, nl, kind, cell, bits, data):
    """At the H100's peaks: the flop and byte counts term for term."""
    ja, ta = (_arch(m, h, nl, kind, cell, bits, timesteps=20)
              for m in (jfm, tfm))
    for batch, s in ROWS:
        want = tpu_model.rnn_step_model(ja, batch=batch, n_samples=s,
                                        data=data)
        got = gpu_model.rnn_step_model(ta, batch=batch, n_samples=s,
                                       data=data)
        assert got["flops"] == want["flops"]
        assert got["bytes"] == want["bytes"]
        assert got["coll"] == want["coll"] == 0.0
        assert got["t_step"] == max(got["flops"] / 67e12,
                                    got["bytes"] / 3.35e12)


@pytest.mark.parametrize("h,nl,kind,cell,bits", ARCHS[1::3])
@pytest.mark.parametrize("data", [1, 4])
def test_step_model_bit_equal_at_the_reference_peaks(h, nl, kind, cell,
                                                     bits, data, ref_peaks):
    ja, ta = (_arch(m, h, nl, kind, cell, bits, timesteps=20)
              for m in (jfm, tfm))
    for batch, s in ROWS:
        assert gpu_model.rnn_step_model(ta, batch=batch, n_samples=s,
                                        data=data) \
            == tpu_model.rnn_step_model(ja, batch=batch, n_samples=s,
                                        data=data)
        assert gpu_model.rnn_latency_s(ta, None, batch, s, data=data) \
            == tpu_model.rnn_latency_s(ja, None, batch, s, data=data)


def test_step_model_rejects_a_bad_width():
    with pytest.raises(ValueError, match="weight_bits"):
        gpu_model.rnn_step_model(_arch(tfm, 8, 1, "classifier", "lstm", 6))


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

CAL_ARCH = dict(hidden=8, num_layers=3, placement="YNY", kind="classifier",
                cell="lstm", weight_bits=32, input_dim=1, output_dim=4,
                timesteps=20)


def _window(mod, seed, kind, n=12):
    """``TickMetrics`` whose durations follow an affine world of the
    reference's roofline plus noise (``kind``: "affine" varying shapes,
    "flat" one shape, "negative" an overhead below zero, "falling" durations
    that fall as the shape grows, "mixed" padding and idle ticks too)."""
    rng = np.random.default_rng(seed)
    arch = jfm.RNNArch(**CAL_ARCH)
    out = []
    for i in range(n):
        rows = int(rng.choice([8, 16, 32, 64])) * 30
        cap = int(rng.choice([8, 16, 20]))
        if kind == "flat":
            rows, cap = 1920, 20
        raw = jcal.tick_raw_seconds(arch, rows=rows, capacity=cap)
        noise = float(rng.normal(0, 1e-5))
        dur = {"affine": 900.0 * raw + 3e-3 + noise,
               "flat": 4e-3 + noise,
               "negative": 2000.0 * raw - 2e-4 + abs(noise) / 10,
               "falling": 0.02 - 500.0 * raw,
               "mixed": 700.0 * raw + 2e-3 + noise}[kind]
        if kind == "mixed" and i % 4 == 3:
            rows, dur = 0, 0.0
        live = rows * cap
        out.append(mod.TickMetrics(
            tick=i, capacity=cap, n_chunks=rows // 30, live_rows=rows,
            batch_rows=rows, queue_depth=0, live_steps=live // 30,
            live_chain_steps=live, padded_steps=live, pad_waste=0.0,
            duration_s=dur,
            tokens_per_sec=live / dur if dur > 0 else 0.0))
    return out


KINDS = ["affine", "flat", "negative", "falling", "mixed"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("min_ticks", [4, 20])
def test_fit_roofline_bit_equal_jax(kind, seed, min_ticks, ref_peaks):
    ja, ta = jfm.RNNArch(**CAL_ARCH), tfm.RNNArch(**CAL_ARCH)
    want = jcal.fit_roofline(_window(jsched, seed, kind), ja,
                             min_ticks=min_ticks)
    got = tcal.fit_roofline(_window(tsched, seed, kind), ta,
                            min_ticks=min_ticks)
    if min_ticks == 20:
        assert want is None and got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if kind == "flat":
        assert got.overhead_s == 0.0        # the ratio fallback
    if kind == "falling":
        assert got.overhead_s == 0.0        # a non-positive slope
    if kind == "affine":
        assert got.overhead_s > 0.0 and got.scale > 0.0


def test_negative_overhead_falls_back_to_the_ratio(ref_peaks):
    """A window whose least-squares overhead is negative: both packages
    clamp it to the ratio fit through the origin."""
    ja, ta = jfm.RNNArch(**CAL_ARCH), tfm.RNNArch(**CAL_ARCH)
    fits = []
    for mod, cal, arch in ((jsched, jcal, ja), (tsched, tcal, ta)):
        win = _window(mod, 0, "affine")
        for m in win:
            raw = cal.tick_raw_seconds(arch, rows=m.batch_rows,
                                       capacity=m.capacity)
            m.duration_s = 3000.0 * raw - 1e-4
        fits.append(cal.fit_roofline(win, arch))
    want, got = fits
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.overhead_s == 0.0


@pytest.mark.parametrize("rows,cap,shards", [(1920, 20, 1), (480, 8, 1),
                                             (37.5, 16, 4), (1, 1, 1)])
def test_tick_raw_seconds_bit_equal_jax(rows, cap, shards, ref_peaks):
    for cell in ("lstm", "gru"):
        kw = dict(CAL_ARCH, cell=cell)
        assert tcal.tick_raw_seconds(tfm.RNNArch(**kw), rows=rows,
                                     capacity=cap, shards=shards) \
            == jcal.tick_raw_seconds(jfm.RNNArch(**kw), rows=rows,
                                     capacity=cap, shards=shards)


@given(scale=st.floats(1.0, 1e5), overhead=st.floats(0.0, 1e-2),
       slots=st.sampled_from([None, 4, 64]),
       batch=st.integers(1, 80), s=st.floats(0.5, 30.0),
       cap=st.integers(1, 64), bits=st.sampled_from([32, 16, 8, 4]))
@settings(max_examples=60, deadline=None)
def test_latency_model_bit_equal_jax(scale, overhead, slots, batch, s, cap,
                                     bits):
    with pytest.MonkeyPatch.context() as mp:
        for name, value in REF_PEAKS.items():
            mp.setattr(gpu_model, name, value)
        kw = dict(CAL_ARCH, weight_bits=bits, timesteps=cap)
        fit = dict(scale=scale, overhead_s=overhead, n_ticks=8, resid_s=0.0)
        want = jcal.latency_model(jcal.RooflineFit(**fit), slots=slots)(
            jfm.RNNArch(**kw), None, batch=batch, n_samples=s)
        got = tcal.latency_model(tcal.RooflineFit(**fit), slots=slots)(
            tfm.RNNArch(**kw), None, batch=batch, n_samples=s)
    assert got == want


def test_fit_recovers_a_known_roofline_at_the_h100_peaks():
    """At the port's own peaks the affine fit is identifiable on varying
    shapes and recovers a synthetic world's constants (the port of
    ``tests/test_controller.py::TestCalibration``)."""
    arch = tfm.RNNArch(**CAL_ARCH)
    win = []
    for i, rows in enumerate((240, 480, 960, 1440, 1920)):
        raw = tcal.tick_raw_seconds(arch, rows=rows, capacity=20)
        win.append(dataclasses.replace(
            _window(tsched, 0, "flat")[0], tick=i, batch_rows=rows,
            duration_s=5000.0 * raw + 3e-3))
    fit = tcal.fit_roofline(win, arch)
    assert fit.scale == pytest.approx(5000.0, rel=1e-6)
    assert fit.overhead_s == pytest.approx(3e-3, rel=1e-6)
    assert fit.resid_s < 1e-9
    assert tcal.fit_roofline(win[:3], arch) is None
