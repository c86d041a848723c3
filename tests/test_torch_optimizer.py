"""The port's optimizer and trainer (``repro_torch.train.optimizer`` /
``trainer``) held against the JAX package on the CPU.

* ``optimizer.apply`` on the same numpy params, grads and state as JAX:
  within 1 fp32 ulp of JAX's params and moments over 5 steps, warmup and
  clipping both active (bit-equal where the evaluations agree).
* ``_compress`` at bf16 and int8 bit-equal to JAX's, value and residual.
* ``Trainer`` over a fixed quadratic loss with 2 microbatches against the
  JAX ``Trainer`` within 1e-6, loss history and params.
* A JAX ``Trainer`` checkpoint resumes in the port's ``Trainer`` and the
  reverse; both write the same leaf names.

The JAX work is small: a two-leaf dense head, a few steps.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import linear as jlinear  # noqa: E402
from repro.train import optimizer as jopt, trainer as jtrainer  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.core import linear as tlinear  # noqa: E402
from repro_torch.train import optimizer as topt, trainer as ttrainer  # noqa: E402

ULP = 1        # fp32 ulps of JAX's value
NORM_ULPS = 2  # the global norm: per-leaf fp32 sums in another order


def _tree(rng, scale=1.0):
    """{"head": (w [5, 3], b [3]), "unc": (w [5, 1], b [1])} as numpy."""
    return {name: tuple((rng.standard_normal(shape) * scale)
                        .astype(np.float32) for shape in shapes)
            for name, shapes in (("head", ((5, 3), (3,))),
                                 ("unc", ((5, 1), (1,))))}


def _jax(tree):
    return {k: jlinear.DenseParams(*map(jnp.asarray, v))
            for k, v in tree.items()}


def _port(tree):
    return {k: tlinear.DenseParams(*(torch.from_numpy(a.copy()) for a in v))
            for k, v in tree.items()}


def _within_ulps(got, want, ulps, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    spacing = np.abs(np.spacing(want))
    over = np.abs(got.astype(np.float64) - want) > ulps * spacing
    assert not over.any(), (what, got[over], want[over])


def _same_tree(port_tree, jax_tree, ulps, what):
    pl = checkpoint.tree_leaves(port_tree)
    jl = jax.tree_util.tree_leaves(jax_tree)
    assert len(pl) == len(jl)
    for i, (p, j) in enumerate(zip(pl, jl)):
        _within_ulps(p.numpy(), np.asarray(j), ulps, f"{what} leaf {i}")


def _ulps(got, want) -> float:
    got = np.asarray(got, np.float32).astype(np.float64)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / np.abs(np.spacing(want))))


def _steps(warmup, clip, same_norm, monkeypatch):
    """Five AdamW steps of both packages on the same numpy params and
    grads; with ``same_norm`` the port's clipping reads JAX's global norm
    of each step's grads.  Yields (JAX's metrics, params, state, the
    port's metrics, params, state) after each step."""
    rng = np.random.default_rng(warmup * 7 + int(clip * 1000))
    params = _tree(rng)
    cfg_kw = dict(lr=1e-2, warmup_steps=warmup, clip_norm=clip,
                  weight_decay=1e-4)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp, tp = _jax(params), _port(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = _tree(rng, scale=2.0)
        if same_norm:
            norm = torch.from_numpy(np.array(jopt.global_norm(
                _jax(grads))))
            monkeypatch.setattr(topt, "global_norm", lambda tree: norm)
        jp, js, jm = jopt.apply(jcfg, jp, _jax(grads), js)
        tp, ts, tm = topt.apply(tcfg, tp, _port(grads), ts)
        yield jm, jp, js, tm, tp, ts


@pytest.mark.parametrize("warmup,clip", [(3, 0.5), (0, 3.0), (2, 1e-3)])
def test_apply_matches_jax_within_an_ulp(warmup, clip, monkeypatch):
    """Given the same global norm, every leaf of the params and both
    moments within 1 ulp of JAX's over 5 steps (bit-equal seen), the
    warmup lr bit-equal, clipping active on every step."""
    for step, (jm, jp, js, tm, tp, ts) in enumerate(
            _steps(warmup, clip, True, monkeypatch)):
        assert float(jm["grad_norm"]) > clip
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        _within_ulps(np.asarray(tm["lr"]), np.asarray(jm["lr"]), 0, "lr")
        _same_tree(tp, jp, ULP, f"params step {step}")
        _same_tree(ts.m, js.m, ULP, f"m step {step}")
        _same_tree(ts.v, js.v, ULP, f"v step {step}")


@pytest.mark.parametrize("warmup,clip", [(3, 0.5), (0, 3.0), (2, 1e-3)])
def test_apply_end_to_end_against_jax(warmup, clip, monkeypatch):
    """The whole step, the port's own norm included: the norm within 1 ulp
    (the per-leaf sums run in another order, see the next test), the
    params within 1e-6 (a moment that cancels to near zero can differ by
    many of its own ulps, which AdamW then divides by sqrt(v))."""
    for jm, jp, js, tm, tp, ts in _steps(warmup, clip, False, monkeypatch):
        _within_ulps(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                     ULP, "grad_norm")
        for a, b in zip(checkpoint.tree_leaves(tp),
                        jax.tree_util.tree_leaves(jp), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("shape,ulps", [
    ((5, 3), NORM_ULPS), ((8, 4), NORM_ULPS), ((16, 2), NORM_ULPS),
    ((16, 1), NORM_ULPS), ((33,), NORM_ULPS), ((128, 64), 2 * NORM_ULPS)])
def test_global_norm_within_ulps(shape, ulps):
    """The per-leaf sum of squares: ``torch.sum``'s order in the port;
    XLA's CPU order depends on the shape (in order for some, vectorized for
    others, and another again under jit), so the norms agree within
    NORM_ULPS (2 seen at (8, 4)), not always bitwise (a divergence kept on
    purpose: ROADMAP.md); twice that for an 8192-element leaf.  A float64
    witness: the port's norm is no further from the float64 norm than
    JAX's plus one ulp."""
    rng = np.random.default_rng(sum(shape))
    worst = 0.0
    for _ in range(20):
        tree = {"a": rng.standard_normal(shape).astype(np.float32),
                "b": rng.standard_normal((3,)).astype(np.float32)}
        want = np.asarray(jopt.global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}))
        got = topt.global_norm({k: torch.from_numpy(v)
                                for k, v in tree.items()}).numpy()
        exact = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                            for v in tree.values()))
        worst = max(worst, _ulps(got, want))
        assert abs(float(got) - exact) <= (abs(float(want) - exact)
                                           + float(np.spacing(want)))
    assert worst <= ulps, worst


def test_global_norm_uses_the_reference_leaf_order():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    assert [tuple(x.shape) for x in checkpoint.tree_leaves(_port(tree))] \
        == [x.shape for x in jax.tree_util.tree_leaves(_jax(tree))]
    # A leaf moved to another position changes which sums are stacked
    # where; the norm does not depend on it beyond an ulp.
    _within_ulps(topt.global_norm(_port(tree)).numpy(),
                 np.asarray(jopt.global_norm(_jax(tree))), ULP, "norm")


@pytest.mark.parametrize("mode", ["bf16", "int8", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_bit_equal(mode, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((17, 9)) * 10 ** rng.uniform(-4, 2)).astype(
        np.float32)
    err = (rng.standard_normal((17, 9)) * 1e-3).astype(np.float32)
    jd, je = jtrainer._compress(jnp.asarray(g), jnp.asarray(err), mode)
    td, te = ttrainer._compress(torch.from_numpy(g), torch.from_numpy(err),
                                mode)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(te.numpy(), np.asarray(je))


def test_compress_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="fp8"):
        ttrainer._compress(torch.zeros(2), torch.zeros(2), "fp8")


# -- the Trainer -----------------------------------------------------------

_A = np.random.default_rng(11).standard_normal((5, 3)).astype(np.float32)


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((4, 5)).astype(np.float32),
             "y": rng.standard_normal((4, 3)).astype(np.float32)}
            for _ in range(n)]


def _jax_loss(params, batch, step):
    pred = jlinear.dense(params["head"], batch["x"])
    loss = jnp.mean((pred - batch["y"]) ** 2) + 0.1 * jnp.sum(
        (params["head"].w - _A) ** 2)
    return loss, {}


def _port_loss(params, batch, step):
    pred = tlinear.dense(params["head"], batch["x"])
    loss = torch.mean((pred - batch["y"]) ** 2) + 0.1 * torch.sum(
        (params["head"].w - torch.from_numpy(_A)) ** 2)
    return loss, {}


def _trainers(cfg_kw, ckpt_dir=None):
    params = {"head": tuple(a for a in _tree(np.random.default_rng(2))[
        "head"])}
    jcfg = jtrainer.TrainConfig(adamw=jopt.AdamWConfig(**cfg_kw),
                                microbatches=2, log_every=0,
                                ckpt_dir=ckpt_dir, ckpt_every=2)
    tcfg = ttrainer.TrainConfig(adamw=topt.AdamWConfig(**cfg_kw),
                                microbatches=2, log_every=0,
                                ckpt_dir=ckpt_dir, ckpt_every=2)
    return jcfg, tcfg, _jax(params), _port(params)


def _port_batches(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def _jax_batches(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_trainer_matches_jax(compression):
    cfg_kw = dict(lr=3e-2, warmup_steps=2, clip_norm=1.0)
    jcfg, tcfg, jp, tp = _trainers(cfg_kw)
    jcfg = dataclasses.replace(jcfg, grad_compression=compression)
    tcfg = dataclasses.replace(tcfg, grad_compression=compression)
    batches = _batches(1) * 6
    jt = jtrainer.Trainer(_jax_loss, jp, jcfg)
    tt = ttrainer.Trainer(_port_loss, tp, tcfg)
    jh = jt.run(_jax_batches(batches), 6)
    th = tt.run(_port_batches(batches), 6)
    assert len(th) == len(jh) == 6 and tt.step == jt.step == 6
    for a, b in zip(th, jh):
        assert a.keys() == b.keys() == {"loss", "grad_norm", "lr"}
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
    for p, j in zip(checkpoint.tree_leaves(tt.params),
                    jax.tree_util.tree_leaves(jt.params)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    assert th[-1]["loss"] < th[0]["loss"]


def test_trainer_stops_when_the_batches_end():
    _, tcfg, _, tp = _trainers(dict(lr=1e-2))
    tt = ttrainer.Trainer(_port_loss, tp, tcfg)
    assert len(tt.run(_port_batches(_batches(3)), 10)) == 3
    assert tt.step == 3


def test_straggler_watchdog():
    _, tcfg, _, tp = _trainers(dict(lr=1e-2))
    tt = ttrainer.Trainer(_port_loss, tp, tcfg)
    for dt in [0.01] * 12:
        tt.step += 1
        tt._watchdog(dt)
    tt.step += 1
    tt._watchdog(1.0)
    assert tt.straggler_events == [tt.step]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(first, tmp_path):
    """Four steps in one package (checkpoints at 2 and 4, the last kept),
    then the other package's Trainer on the same directory resumes at
    step 4 and runs to 6: equal to six steps in the second package alone,
    within 1e-6."""
    cfg_kw = dict(lr=3e-2, warmup_steps=2, clip_norm=1.0)
    batches = _batches(6)
    d = str(tmp_path / "ckpt")
    jcfg, tcfg, jp, tp = _trainers(cfg_kw, ckpt_dir=d)
    if first == "jax":
        jtrainer.Trainer(_jax_loss, jp, jcfg).run(
            _jax_batches(batches[:4]), 4)
        _, tcfg2, _, tp2 = _trainers(cfg_kw, ckpt_dir=d)
        resumed = ttrainer.Trainer(_port_loss, tp2, tcfg2)
        assert resumed.step == 4
        assert int(resumed.opt_state.step) == 4
        assert resumed.opt_state.step.dtype == torch.int32
        resumed.run(_port_batches(batches[4:]), 6)
        got = checkpoint.tree_leaves(resumed.params)
    else:
        ttrainer.Trainer(_port_loss, tp, tcfg).run(
            _port_batches(batches[:4]), 4)
        jcfg2, _, jp2, _ = _trainers(cfg_kw, ckpt_dir=d)
        resumed = jtrainer.Trainer(_jax_loss, jp2, jcfg2)
        assert resumed.step == 4 and int(resumed.opt_state.step) == 4
        resumed.run(_jax_batches(batches[4:]), 6)
        got = jax.tree_util.tree_leaves(resumed.params)
    # The whole run in one package, without checkpoints.
    jcfg3, tcfg3, jp3, tp3 = _trainers(cfg_kw)
    if first == "jax":
        whole = ttrainer.Trainer(_port_loss, tp3, tcfg3)
        whole.run(_port_batches(batches), 6)
        want = checkpoint.tree_leaves(whole.params)
    else:
        whole = jtrainer.Trainer(_jax_loss, jp3, jcfg3)
        whole.run(_jax_batches(batches), 6)
        want = jax.tree_util.tree_leaves(whole.params)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6)
    steps = sorted(os.listdir(d))
    assert steps[-1] == "step-0000000006"


def test_checkpoint_leaf_names_are_the_reference_names(tmp_path):
    from repro.ckpt import checkpoint as jckpt
    _, _, jp, tp = _trainers(dict(lr=1e-2))
    jtree = (jp, jopt.init(jp))
    ttree = (tp, topt.init(tp))
    assert checkpoint._leaf_names(ttree) == jckpt._leaf_names(jtree)
    path = checkpoint.save(str(tmp_path / "t"), 0, ttree)
    jpath = jckpt.save(str(tmp_path / "j"), 0, jtree)

    def entries(p):
        with open(os.path.join(p, "manifest.json")) as f:
            return [(e["name"], e["dtype"], e["shape"], e["sha256"])
                    for e in json.load(f)["leaves"]]
    assert entries(path) == entries(jpath)
