"""Training in the port (``repro_torch.launch.train`` and
``repro_torch.models.backbone.loss_fn``) held against the JAX package on
the CPU.

* The ECG classifier's and autoencoder's launcher losses
  (``make_ecg_loss``) at B = 8, T = 24: value and every gradient leaf
  against ``jax.value_and_grad`` of the reference's ``make_ecg_loss`` on
  JAX's params (carried by ``bridge.from_numpy_params``).
* Three ``Trainer`` steps of the classifier against the JAX ``Trainer``
  (jitted), microbatches 1 and 2, gradient compression none, bf16 and
  int8: the loss history and the params.
* REDUCED qwen3 and mamba2: ``loss_fn`` value and gradients against JAX's
  ``loss_fn`` (remat on in both), JAX's gradient tree mapped leaf by leaf
  by ``bridge.from_numpy_backbone``.
* ``_chunked_xent`` at an S the chunk does not divide (S = 12, chunk 5:
  chunks of 4), value and the gradient of the hidden state.
* In the port, ``remat=True`` bit-equal to ``remat=False``: the loss and
  every gradient leaf.

The JAX work is small: each JAX program is compiled once (a module
fixture a model) at these sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import autoencoder as jae, classifier as jclf  # noqa: E402
from repro.core import mcd as jmcd, prng as jprng  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import backbone as jbb, layers as jlayers  # noqa: E402
from repro.train import optimizer as jopt, trainer as jtr  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import autoencoder as tae, classifier as tclf  # noqa: E402
from repro_torch.core import mcd as tmcd, prng as tprng  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.train import optimizer as topt, trainer as ttr  # noqa: E402

B, T = 8, 24
ECG_LOSS_TOL = 1e-6   # ECG loss: equal on these inputs (0 seen)
ECG_GRAD_TOL = 1e-6   # ECG gradients: the port's gate sums add one
                      # product at a time, XLA's einsum in its own order
                      # (1.5e-7 seen)
TRAIN_TOL = 1e-5      # params after 3 steps (3.3e-6 seen at bf16
                      # compression, where a gradient element rounds to
                      # the other bf16 neighbour; 6e-8 without)
TRAIN_LOSS_TOL = 1e-6  # the loss history (2.4e-7 seen)
LM_LOSS_TOL = 1e-5    # REDUCED LM loss (4.8e-7 seen)
LM_GRAD_TOL = 2e-5    # REDUCED LM gradients, per leaf (2.0e-6 seen)

_rng = np.random.default_rng(0)
X = _rng.standard_normal((B, T, 1)).astype(np.float32)
Y = _rng.integers(0, 4, (B,)).astype(np.int32)
BATCHES = [(_rng.standard_normal((B, T, 1)).astype(np.float32),
            _rng.integers(0, 4, (B,)).astype(np.int32)) for _ in range(3)]


def _ecg_cfgs(task):
    """(JAX config, port config) as the launcher builds them (seed 0)."""
    placement = "YNYN" if task == "ecg-ae" else "YNY"
    jm = jmcd.MCDConfig(p=0.125, placement=placement, n_samples=30, seed=0)
    tm = tmcd.MCDConfig(p=0.125, placement=placement, n_samples=30, seed=0)
    if task == "ecg-ae":
        return (jae.AutoencoderConfig(hidden=16, num_layers=2, mcd=jm),
                tae.AutoencoderConfig(hidden=16, num_layers=2, mcd=tm))
    return (jclf.ClassifierConfig(hidden=8, num_layers=3, mcd=jm),
            tclf.ClassifierConfig(hidden=8, num_layers=3, mcd=tm))


def _jax_params(task, cfg):
    init = jae.init if task == "ecg-ae" else jclf.init
    return init(jax.random.key(0), cfg)


def _port_params(jp):
    return bridge.from_numpy_params(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _port_value_and_grad(loss_fn, params, *args):
    """(loss, metrics, gradient leaves) of ``loss_fn(params, *args)``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), *args)
    return loss, metrics, torch.autograd.grad(loss, leaves)


def _assert_leaves(got, want, atol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("task", ["ecg-clf", "ecg-ae"])
def test_ecg_loss_and_grads_match_jax(task):
    jcfg, tcfg = _ecg_cfgs(task)
    jp = _jax_params(task, jcfg)
    (jl, _), jg = jax.value_and_grad(
        jtrain.make_ecg_loss(task, jcfg), has_aux=True)(
        jp, (jnp.asarray(X), jnp.asarray(Y)), 0)
    loss, _, grads = _port_value_and_grad(
        ttrain.make_ecg_loss(task, tcfg), _port_params(jp),
        (torch.from_numpy(X), torch.from_numpy(Y)), 0)
    assert abs(float(loss.detach()) - float(jl)) <= ECG_LOSS_TOL
    _assert_leaves(grads, jax.tree_util.tree_leaves(jg), ECG_GRAD_TOL,
                   f"{task} gradients")


@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_steps_match_jax(microbatches, compression):
    """Three classifier steps: the port's eager step against the jitted
    JAX step from the same params on the same batches."""
    jcfg, tcfg = _ecg_cfgs("ecg-clf")
    jp = _jax_params("ecg-clf", jcfg)
    kw = dict(microbatches=microbatches, grad_compression=compression,
              log_every=0)
    jt = jtr.Trainer(jtrain.make_ecg_loss("ecg-clf", jcfg), jp,
                     jtr.TrainConfig(adamw=jopt.AdamWConfig(lr=1e-3), **kw))
    jh = jt.run(((jnp.asarray(x), jnp.asarray(y)) for x, y in BATCHES), 3)
    tt = ttr.Trainer(ttrain.make_ecg_loss("ecg-clf", tcfg), _port_params(jp),
                     ttr.TrainConfig(adamw=topt.AdamWConfig(lr=1e-3), **kw))
    th = tt.run(((torch.from_numpy(x), torch.from_numpy(y))
                 for x, y in BATCHES), 3)
    assert len(th) == len(jh) == 3
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= TRAIN_LOSS_TOL
    _assert_leaves(tree_leaves(tt.params),
                   jax.tree_util.tree_leaves(jt.params), TRAIN_TOL,
                   "params after 3 steps")


# -- the LMs -----------------------------------------------------------------

LM_B, LM_S, LM_STEP = 4, 8, 3


@pytest.fixture(scope="module", params=["qwen3-1.7b", "mamba2-370m"])
def lm(request):
    """JAX's REDUCED params, its loss_fn value and gradients at step
    LM_STEP (the step folded into the seed, as the launcher does)."""
    arch = request.param
    jcfg, tcfg = jget(arch, reduced=True), tget(arch, reduced=True)
    jp = jbb.init_params(jax.random.key(0), jcfg, jnp.float32)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (LM_B, LM_S + 1), dtype=np.int32)
    ctx = jlayers.Ctx(jnp.arange(LM_B, dtype=jnp.uint32),
                      jprng.fold_ids(jcfg.mcd.seed, LM_STEP), jcfg.mcd)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jbb.loss_fn(p, jcfg, jnp.asarray(toks[:, :-1]),
                              jnp.asarray(toks[:, 1:]), ctx),
        has_aux=True)(jp)
    return dict(arch=arch, tcfg=tcfg, toks=toks, loss=float(jl),
                nll=float(jm["nll"]),
                params=bridge.from_numpy_backbone(
                    jax.tree.map(np.asarray, jp), tcfg, device="cpu"),
                grads=bridge.from_numpy_backbone(
                    jax.tree.map(np.asarray, jg), tcfg, device="cpu"))


def _lm_loss(lm, remat=True):
    cfg, toks = lm["tcfg"], lm["toks"]

    def loss(params):
        ctx = tlayers.Ctx(torch.arange(LM_B),
                          tprng.fold_ids(cfg.mcd.seed, LM_STEP), cfg.mcd)
        return tbb.loss_fn(params, cfg, torch.from_numpy(toks[:, :-1]),
                           torch.from_numpy(toks[:, 1:]), ctx, remat=remat)
    return loss


def test_lm_loss_fn_matches_jax(lm):
    loss, metrics, grads = _port_value_and_grad(_lm_loss(lm), lm["params"])
    assert abs(float(loss.detach()) - lm["loss"]) <= LM_LOSS_TOL, lm["arch"]
    assert abs(float(metrics["nll"].detach()) - lm["nll"]) <= LM_LOSS_TOL
    aux = metrics["aux"]
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert float(aux.detach()) == 0
    _assert_leaves(grads, tree_leaves(lm["grads"]), LM_GRAD_TOL,
                   f"{lm['arch']} gradients")


def test_remat_is_bit_neutral(lm):
    """Checkpointed periods recompute the same masks and values: the loss
    and every gradient leaf equal the un-checkpointed ones bit for bit."""
    on = _port_value_and_grad(_lm_loss(lm, remat=True), lm["params"])
    off = _port_value_and_grad(_lm_loss(lm, remat=False), lm["params"])
    assert torch.equal(on[0], off[0])
    for i, (a, b) in enumerate(zip(on[2], off[2], strict=True)):
        assert torch.equal(a, b), f"{lm['arch']} gradient leaf {i}"


def test_chunked_xent_ragged_chunk_matches_jax():
    """S = 12 with chunk 5: both packages take chunks of 4 (the largest
    divisor of S at most 5); the value and the hidden state's gradient
    within LM_GRAD_TOL, and the port's value equal to one whole chunk's
    within an fp32 rounding of the sum."""
    jcfg = jget("qwen3-1.7b", reduced=True)
    tcfg = tget("qwen3-1.7b", reduced=True)
    jp = jbb.init_params(jax.random.key(2), jcfg, jnp.float32)
    tp = bridge.from_numpy_backbone(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    t = rng.integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jv, jg = jax.value_and_grad(
        lambda hh: jbb._chunked_xent(jp["embed"], hh, jnp.asarray(t), 5))(
        jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    tv = tbb._chunked_xent(tp["embed"], ht, torch.from_numpy(t), 5)
    (tg,) = torch.autograd.grad(tv, ht)
    assert abs(float(tv.detach()) - float(jv)) <= LM_LOSS_TOL
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=LM_GRAD_TOL)
    whole = tbb._chunked_xent(tp["embed"], ht.detach(),
                              torch.from_numpy(t), 12)
    assert abs(float(whole) - float(tv.detach())) <= LM_LOSS_TOL


def test_ssd_decay_backward_is_finite_where_the_reference_is_nan():
    """One 64-step chunk whose log-decay sums to -128: the reference's
    ``_ssd_chunked`` exponentiates the masked (positive) entries, which
    overflow to inf, and its gradient is NaN (0 * inf).  The port masks
    before the exp: the forward within LM_LOSS_TOL of JAX's, the
    gradient of dt (which the log-decay is made of) finite."""
    from repro.models import mamba2 as jm2
    from repro_torch.models import mamba2 as tm2
    rng = np.random.default_rng(4)
    B, L, H, P, N = 1, 64, 2, 4, 4
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.full((B, L, H), 2.0, np.float32)
    a = np.full((H,), -1.0, np.float32)
    bm = rng.standard_normal((B, L, 1, N)).astype(np.float32)
    cm = rng.standard_normal((B, L, 1, N)).astype(np.float32)
    d = np.ones((H,), np.float32)

    def jloss(dd):
        y, h = jm2._ssd_chunked(jnp.asarray(x), dd, jnp.asarray(a),
                                jnp.asarray(bm), jnp.asarray(cm),
                                jnp.asarray(d), L)
        return jnp.sum(y) + jnp.sum(h), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jg)).all()
    dtt = torch.from_numpy(dt).requires_grad_(True)
    y, h = tm2._ssd_chunked(torch.from_numpy(x), dtt,
                            *(torch.from_numpy(v) for v in (a, bm, cm, d)),
                            L)
    (g,) = torch.autograd.grad(y.sum() + h.sum(), dtt)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=LM_LOSS_TOL)
