"""Distillation in the port: ``repro_torch.core.distill`` and
``repro_torch.train.distill``, held against the JAX package on the CPU.

* ``det_rows`` equal to JAX's (uint32 patterns, flag included).
* The student summaries (classifier; autoencoder with and without the
  heteroscedastic head) on heads carried from JAX through
  ``bridge.from_numpy_student``: within 1e-6 of JAX's on the same feature
  (relative to values above 1).
* Teacher targets: the port's ``cuda_seq`` / ``cuda_step`` backends (their
  plain versions here) against JAX ``pallas_seq`` in interpret mode within
  3e-7, the port's ``reference`` against JAX's ``reference`` too; every
  port backend gives the same targets bit for bit.
* ``distill_classifier`` / ``distill_autoencoder`` (H = 8, 2 layers, S =
  4, 5 steps, ``cache_targets``) against JAX from the same JAX-drawn
  student: loss history and heads within 1e-5.  AdamW divides each
  gradient by its own running RMS, so a gradient near zero is amplified
  to ~lr: the test prints the smallest non-zero gradient magnitude the
  step sees, which stays far above the trunk's ulp-scale differences.
* Inside the port: the features are the flagged rows' deterministic pass
  on every backend bit for bit; ``cache_targets`` equals re-feeding; the
  loss falls.

The JAX work is small: H = 8, NL = 2, S = 4, B = 3, T = 6.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import distill as jdistill, mcd as jmcd  # noqa: E402
from repro.train import distill as jtrain  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import distill as tdistill, mcd as tmcd  # noqa: E402
from repro_torch.train import distill as ttrain  # noqa: E402

S, HID, NL = 4, 8, 2
SUMMARY_TOL = 1e-6    # student heads on the same feature
TARGET_TOL = 3e-7     # teacher targets against JAX pallas_seq
FIT_TOL = 1e-5        # loss history and heads after 5 steps
BACKENDS = ("reference", "cuda_seq", "cuda_step")


def _cfgs(kind, het=True):
    jm = jmcd.MCDConfig(p=0.25, placement="YN" if kind == "classifier"
                        else "YNYN", n_samples=S, seed=3)
    tm = tmcd.MCDConfig(p=0.25, placement="YN" if kind == "classifier"
                        else "YNYN", n_samples=S, seed=3)
    if kind == "classifier":
        kw = dict(hidden=HID, num_layers=NL, num_classes=4)
        return (jclf.ClassifierConfig(mcd=jm, **kw),
                tclf.ClassifierConfig(mcd=tm, **kw))
    kw = dict(hidden=HID, num_layers=NL, heteroscedastic=het)
    return (jae.AutoencoderConfig(mcd=jm, **kw),
            tae.AutoencoderConfig(mcd=tm, **kw))


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX cfg, JAX params, JAX student, port cfg, port params,
    port student carried from JAX)."""
    out = {}
    for kind, het in (("classifier", True), ("autoencoder", True),
                      ("autoencoder_mean", False)):
        jcfg, tcfg = _cfgs(kind.split("_")[0], het)
        init = jclf.init if kind == "classifier" else jae.init
        jparams = init(jax.random.key(0), jcfg)
        jstu = jdistill.init_student(jax.random.key(1), jcfg, jparams)
        tparams = bridge.from_numpy_params(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
        tstu = bridge.from_numpy_student(jax.tree.map(np.asarray, jstu),
                                         device="cpu")
        out[kind] = (jcfg, jparams, jstu, tcfg, tparams, tstu)
    return out


def _x(b=3, t=6, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, 1)).astype(
        np.float32)


def _close(port, ref, atol, what):
    """Within ``atol``, relative to values above 1 (``exp(log_var)`` is
    one ulp of an exp apart)."""
    for i, (a, b) in enumerate(zip(port, ref, strict=True)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=0,
                                   atol=atol * max(1.0, float(np.abs(b).max())),
                                   err_msg=f"{what} field {i}")


# -- rows and heads -----------------------------------------------------------

@pytest.mark.parametrize("n,base", [(1, 0), (5, 7), (3, 2 ** 31 - 3)])
def test_det_rows_equal(n, base):
    got = tdistill.det_rows(n, base, device="cpu")
    want = np.asarray(jdistill.det_rows(n, base))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert all(tmcd.is_student_row(int(r)) for r in got)
    assert [tmcd.base_row(int(r)) for r in got] == list(range(base, base + n))


def test_init_student_adopts_the_teacher_head(models):
    for kind in models:
        _, _, jstu, tcfg, tparams, tstu = models[kind]
        stu = tdistill.init_student(torch.Generator().manual_seed(0), tcfg,
                                    tparams, device="cpu")
        assert stu["head"] is tparams["head"]
        assert stu["unc"].w.shape == tuple(np.asarray(jstu["unc"].w).shape)
        fresh = tdistill.init_student(torch.Generator().manual_seed(0),
                                      tcfg, device="cpu")
        assert fresh["head"].w.shape == tparams["head"].w.shape
        assert torch.equal(fresh["unc"].b, torch.zeros_like(fresh["unc"].b))
    with pytest.raises(TypeError, match="ClassifierConfig"):
        tdistill.init_student(torch.Generator(), object(), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classifier_student_summary_matches_jax(models, seed):
    jcfg, _, jstu, _, _, tstu = models["classifier"]
    h = (np.random.default_rng(seed).standard_normal((5, HID)) * 2).astype(
        np.float32)
    want = jdistill.classifier_student_summary(jstu, jnp.asarray(h))
    got = tdistill.classifier_student_summary(tstu, torch.from_numpy(h))
    _close(got, want, SUMMARY_TOL, "classifier student")
    # The decomposition identity holds as in the S-chain estimator.
    assert torch.equal(got.expected_entropy,
                       got.predictive_entropy - got.mutual_information)
    assert bool((got.mutual_information >= 0).all())


@pytest.mark.parametrize("kind", ["autoencoder", "autoencoder_mean"])
@pytest.mark.parametrize("seed", [0, 1])
def test_autoencoder_student_summary_matches_jax(models, kind, seed):
    jcfg, _, jstu, tcfg, _, tstu = models[kind]
    d = (np.random.default_rng(seed).standard_normal((3, 7, HID)) * 2
         ).astype(np.float32)
    want = jdistill.autoencoder_student_summary(jstu, jnp.asarray(d),
                                                jcfg.heteroscedastic)
    got = tdistill.autoencoder_student_summary(tstu, torch.from_numpy(d),
                                               tcfg.heteroscedastic)
    _close(got, want, SUMMARY_TOL, kind)
    assert torch.equal(got.total, got.aleatoric + got.epistemic)


def test_softplus_is_the_reference_logaddexp():
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [-1e-8, 0.0, 1e-8, 88.0, -88.0]]).astype(np.float32)
    got = tdistill.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.abs(np.spacing(want)).max()))


def test_heads_keep_the_feature_dtype(models):
    _, _, _, _, _, tstu = models["classifier"]
    h = torch.randn(4, HID, generator=torch.Generator().manual_seed(0))
    s = tdistill.classifier_student_summary(tstu, h.to(torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in s)


# -- teacher targets ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_teacher_targets_match_jax(models, kind):
    jcfg, jparams, _, tcfg, tparams, _ = models[kind]
    x = _x()
    jt = (jdistill.classifier_teacher_targets if kind == "classifier"
          else jdistill.autoencoder_teacher_targets)
    tt = (tdistill.classifier_teacher_targets if kind == "classifier"
          else tdistill.autoencoder_teacher_targets)
    want = jt(jparams, jnp.asarray(x), jcfg, backend="pallas_seq")
    want_ref = jt(jparams, jnp.asarray(x), jcfg, backend="reference")
    got = {b: tt(tparams, x, tcfg, backend=b, device="cpu")
           for b in BACKENDS}
    for b in ("cuda_seq", "cuda_step"):
        _close(got[b], want, TARGET_TOL, f"{kind} {b} vs pallas_seq")
        for u, v in zip(got[b], got["cuda_seq"]):
            assert torch.equal(u, v), b
    _close(got["reference"], want_ref, TARGET_TOL, f"{kind} reference")
    assert got["cuda_seq"][0].dtype == torch.float32


def test_teacher_targets_n_samples_and_base_row(models):
    jcfg, jparams, _, tcfg, tparams, _ = models["classifier"]
    x = _x(b=2)
    want = jdistill.classifier_teacher_targets(
        jparams, jnp.asarray(x), jcfg, n_samples=3, base_row=11,
        backend="reference")
    got = tdistill.classifier_teacher_targets(
        tparams, x, tcfg, n_samples=3, base_row=11, backend="reference",
        device="cpu")
    _close(got, want, TARGET_TOL, "n_samples / base_row")


# -- the distillation trainer ---------------------------------------------------

def _fit(models, kind, steps=5):
    jcfg, jparams, jstu, tcfg, tparams, tstu = models[kind]
    xs = [_x(seed=0), _x(seed=1)]
    jd = jtrain.DistillConfig(lr=1e-2, cache_targets=True)
    td = ttrain.DistillConfig(lr=1e-2, cache_targets=True)
    jfit = (jtrain.distill_classifier if kind == "classifier"
            else jtrain.distill_autoencoder)
    tfit = (ttrain.distill_classifier if kind == "classifier"
            else ttrain.distill_autoencoder)
    jstu_out, jhist = jfit(jparams, jcfg, [jnp.asarray(x) for x in xs],
                           steps, dcfg=jd, student=jstu)
    tstu_out, thist = tfit(tparams, tcfg, xs, steps, dcfg=td, student=tstu,
                           device="cpu")
    return jstu_out, jhist, tstu_out, thist


@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_distill_matches_jax(models, kind):
    jstu, jhist, tstu, thist = _fit(models, kind)
    assert len(thist) == len(jhist) == 5
    for a, b in zip(thist, jhist):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=FIT_TOL,
                                       err_msg=k)
    for name in ("head", "unc"):
        for a, b in zip(tstu[name], jstu[name], strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=FIT_TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_distill_gradients_are_far_from_zero(models, kind):
    """The gap AdamW could amplify: the first step's smallest gradient
    magnitude, against the trunk's ulp-scale feature differences."""
    jcfg, jparams, _, tcfg, tparams, tstu = models[kind]
    batches = (ttrain.classifier_batches if kind == "classifier"
               else ttrain.autoencoder_batches)
    batch = next(batches(tparams, tcfg, [_x()], ttrain.DistillConfig(),
                         device="cpu"))
    leaves = [p.detach().clone().requires_grad_(True)
              for name in ("head", "unc") for p in tstu[name]]
    stu = {"head": type(tstu["head"])(*leaves[:2]),
           "unc": type(tstu["unc"])(*leaves[2:])}
    if kind == "classifier":
        s = tdistill.classifier_student_summary(stu, batch["feat"])
        loss = ttrain._kl(batch["probs"], s.probs) + torch.mean(
            (s.mutual_information - batch["mi"]) ** 2)
    else:
        s = tdistill.autoencoder_student_summary(stu, batch["feat"], True)
        loss = torch.mean((s.mean - batch["mean"]) ** 2) + torch.mean(
            (s.epistemic - batch["eps"]) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    # The autoencoder's loss reads the head's mean half only: the log-var
    # columns get exact zeros, which AdamW leaves at zero in both packages.
    if kind == "autoencoder":
        assert not grads[0][:, 1:].any() and not grads[1][1:].any()
    smallest = min(float(g[g != 0].abs().min()) for g in grads)
    print(f"{kind}: smallest non-zero |grad| at step 1 = {smallest:.3e}")
    assert smallest > 1e-6


@pytest.mark.parametrize("kind", ["classifier", "autoencoder"])
def test_features_are_the_deterministic_pass_on_every_backend(models, kind):
    _, _, _, tcfg, tparams, _ = models[kind]
    batches = (ttrain.classifier_batches if kind == "classifier"
               else ttrain.autoencoder_batches)
    x = _x()
    got = {b: next(batches(tparams, tcfg, [x],
                           ttrain.DistillConfig(backend=b), device="cpu"))
           for b in BACKENDS}
    for b in ("cuda_step", "reference"):
        for k in got[b]:
            if b == "reference":
                np.testing.assert_allclose(got[b][k].numpy(),
                                           got["cuda_seq"][k].numpy(),
                                           rtol=0, atol=1e-6, err_msg=k)
            else:
                assert torch.equal(got[b][k], got["cuda_seq"][k]), (b, k)
    # A flagged row is the p = 0 pass of the same rows.
    p0 = tcfg.__class__(**{**tcfg.__dict__,
                           "mcd": tcfg.mcd.replace(p=0.0)})
    rows = torch.arange(3)
    if kind == "classifier":
        _, states = tclf.apply(tparams, torch.from_numpy(x), rows, p0,
                               backend="cuda_seq", return_state=True,
                               device="cpu")
        want = states[-1][0]
    else:
        want = tae.apply(tparams, torch.from_numpy(x), rows, p0,
                         backend="cuda_seq", return_decoded=True,
                         device="cpu")[-1]
    assert torch.equal(got["cuda_seq"]["feat"], want)


def test_cache_targets_equals_refeeding(models):
    _, _, _, tcfg, tparams, tstu = models["classifier"]
    xs = [_x(seed=0), _x(seed=1)]
    a, ha = ttrain.distill_classifier(
        tparams, tcfg, xs, 6, student=tstu, device="cpu",
        dcfg=ttrain.DistillConfig(cache_targets=True))
    b, hb = ttrain.distill_classifier(
        tparams, tcfg, xs * 3, 6, student=tstu, device="cpu")
    assert ha == hb
    for name in ("head", "unc"):
        for u, v in zip(a[name], b[name]):
            assert torch.equal(u, v)


def test_loss_falls(models):
    _, _, _, tcfg, tparams, _ = models["classifier"]
    stu, hist = ttrain.distill_classifier(
        tparams, tcfg, [_x(b=8, seed=4)], 60, device="cpu",
        generator=torch.Generator().manual_seed(2),
        dcfg=ttrain.DistillConfig(cache_targets=True, lr=3e-2))
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"]
    assert stu["head"] is not tparams["head"]
