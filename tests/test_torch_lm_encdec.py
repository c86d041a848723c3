"""The encoder–decoder (``family="audio"``) and VLM (``family="vlm"``)
paths of the port held against the JAX package on the CPU.

Neither package's registry has such a config, so both are built inline
with ``ArchConfig``, qwen3-like at d_model 64 (4 q / 2 KV heads, d_ff 128,
vocab 256, qk_norm): audio has 2 ``enc_attn.mlp`` encoder layers, 2
``dec_attn.cross.mlp`` decoder layers and ``encoder_seq`` 12; vlm has 2
``attn.mlp`` layers and ``num_patches`` 5.  JAX's
``backbone.init_params(key(0), float32)`` goes through
``bridge.from_numpy_backbone``; the same numpy-seeded tokens, frames,
patches and MC context (2 requests x 2 chains, p = 0.1, placement "Y")
go through both.  Compared:

* ``layers.cross_attention`` / ``cross_kv``, qk_norm on and off, masked,
  on both port backends: within 1e-6 (fp32);
* ``forward``, ``prefill`` (its caches and cross K/V) and 3 teacher-forced
  ``decode_step`` calls on both backends: logits within 1e-5;
* the site masks at the encoder's layer ids (from 10_000) and at
  ``SITE_CROSS``: bits and the kernel path's values exactly equal;
* ``BayesianEngine.generate(frames=, patches=)`` against the JAX engine:
  tokens equal, entropy and MI within 1e-5; its decode graph's static
  cross K/V refilled by a second ``generate`` with other frames; a VLM's
  ``max_len`` counts its patches;
* ``loss_fn`` and its gradients (LM_LOSS_TOL / LM_GRAD_TOL of
  ``tests/test_torch_train.py``);
* ``shardings.param_specs`` / ``cache_specs``, ``specs.model_input_specs``
  and the probes' names, multipliers and argument shapes equal to JAX's;
  ``analysis.active_params`` / ``model_flops`` equal to JAX's; a fake
  ``analysis.count`` equal to the real one on small cells;
* ``stack_repeats`` -> ``unstack_repeats`` round-trips an encoder–decoder
  tree, whose stacked shapes are JAX's;
* the serve launcher on both configs.

One JAX init and one pass of each kind per config, cached for the module.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.core import mcd as jmcd  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import mesh as jmesh, shardings as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import backbone as jbb, layers as jlayers  # noqa: E402
from repro.models.config import (ArchConfig as JArch,  # noqa: E402
                                 SHAPES as JSHAPES, Stage as JStage)
from repro.serve.engine import BayesianEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.checkpoint import (tree_leaves,  # noqa: E402
                                         tree_unflatten)
from repro_torch.core import mcd as tmcd  # noqa: E402
from repro_torch.launch import (analysis as tanalysis,  # noqa: E402
                                mesh as tmesh, serve as tserve, shardings,
                                specs)
from repro_torch.models import backbone as tbb, layers as tlayers  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.config import (ArchConfig as TArch,  # noqa: E402
                                       ShapeCell, Stage as TStage)
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

ATOL = 1e-5            # logits, entropy and MI (fp32), the LMs' decode gate
LAYER_ATOL = 1e-6      # one cross-attention sublayer
LM_LOSS_TOL = 1e-5     # tests/test_torch_train.py's
LM_GRAD_TOL = 2e-5
B, S, L, SEED = 2, 2, 6, 5
N_NEW = 4
ENC_SEQ, PATCHES, D = 12, 5, 64
FAMILIES = ("audio", "vlm")


def _configs(family, qk_norm=True):
    """(JAX config, port config) of one family, field for field equal."""
    kw = dict(name=f"tiny-{family}", family=family, d_model=D, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=256, qk_norm=qk_norm,
              rope_theta=1000000.0)
    out = []
    for arch, stage, mcd in ((JArch, JStage, jmcd), (TArch, TStage, tmcd)):
        fam = dict(stages=(stage(("attn.mlp",), 2),), num_patches=PATCHES)
        if family == "audio":
            fam = dict(stages=(stage(("dec_attn.cross.mlp",), 2),),
                       encoder_stages=(stage(("enc_attn.mlp",), 2),),
                       encoder_seq=ENC_SEQ)
        out.append(arch(**kw, **fam, mcd=mcd.MCDConfig(
            p=0.1, placement="Y", n_samples=S)))
    return tuple(out)


def _inputs(family, rng, batch):
    """{"frames": [batch, 12, D]} or {"patches": [batch, 5, D]}, fp32."""
    if family == "audio":
        return {"frames": rng.standard_normal((batch, ENC_SEQ, D)).astype(
            np.float32)}
    return {"patches": rng.standard_normal((batch, PATCHES, D)).astype(
        np.float32)}


def _max_len(family, n=N_NEW):
    return L + n + (PATCHES if family == "vlm" else 0)


def _np(a):
    return np.asarray(a)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _jax_layers(caches):
    """JAX per-stage tuples of stacked [repeat, ...] leaves -> one tuple of
    numpy leaves per (stage, repeat, position), None kept."""
    out = []
    for stage in caches:
        reps = next(_np(leaf).shape[0] for c in stage if c is not None
                    for leaf in jax.tree_util.tree_leaves(c))
        for r in range(reps):
            for c in stage:
                out.append(None if c is None else tuple(
                    _np(a)[r] for a in jax.tree_util.tree_leaves(c)))
    return out


def _port_layers(caches):
    return [None if c is None else tuple(a.numpy() for a in tree_leaves(c))
            for stage in caches for rep in stage for c in rep]


@pytest.fixture(scope="module", params=FAMILIES)
def ref(request):
    """One config's JAX params and passes: forward, prefill + 3 decode
    steps, the engine, loss_fn and its gradients."""
    family = request.param
    jcfg, tcfg = _configs(family)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (S * B, L), dtype=np.int32)
    inputs = _inputs(family, rng, S * B)
    decode = rng.integers(0, jcfg.vocab_size, (3, S * B, 1), dtype=np.int32)
    prompts = rng.integers(0, jcfg.vocab_size, (B, L), dtype=np.int32)
    req = _inputs(family, rng, B)
    req2 = _inputs(family, rng, B)
    params = jbb.init_params(jax.random.key(0), jcfg, jnp.float32)
    ctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, jcfg.mcd)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    out = dict(family=family, jcfg=jcfg, tcfg=tcfg, tokens=tokens,
               inputs=inputs, decode=decode, prompts=prompts, req=req,
               req2=req2, tree=jax.tree.map(np.asarray, params))
    out["forward"] = _np(jbb.forward(params, jcfg, jnp.asarray(tokens), ctx,
                                     **jin)[0])
    lg, st = jbb.prefill(params, jcfg, jnp.asarray(tokens), ctx,
                         _max_len(family), **jin)
    out["prefill"], out["pos"] = _np(lg), int(st.pos)
    out["prefill_caches"] = _jax_layers(st.caches)
    out["cross"] = None if st.cross is None else _jax_layers(st.cross)
    out["decode_logits"] = []
    for tok in decode:
        lg, st = jbb.decode_step(params, jcfg, jnp.asarray(tok), st, ctx)
        out["decode_logits"].append(_np(lg))
    out["decode_caches"] = _jax_layers(st.caches)
    eng = JEngine(params, jcfg, max_len=_max_len(family), seed=SEED)
    out["generate"] = []
    for r in (req, req2):
        res = eng.generate(jnp.asarray(prompts), N_NEW,
                           **{k: jnp.asarray(v) for k, v in r.items()})
        out["generate"].append({
            "tokens": _np(res.tokens), "entropy": _np(res.predictive_entropy),
            "mi": _np(res.mutual_information)})
    lctx = jlayers.Ctx(jnp.arange(S * B, dtype=jnp.uint32), SEED, jcfg.mcd)
    targets = np.roll(tokens, -1, axis=1)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jbb.loss_fn(p, jcfg, jnp.asarray(tokens),
                              jnp.asarray(targets), lctx, **jin),
        has_aux=True)(params)
    out.update(targets=targets, loss=float(loss), nll=float(metrics["nll"]),
               grads=jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def port(ref):
    return bridge.from_numpy_backbone(ref["tree"], ref["tcfg"], device="cpu")


def _ctx(cfg):
    return tlayers.Ctx(tmcd.sample_rows(B, S), SEED, cfg.mcd)


def _tin(ref):
    return {k: torch.from_numpy(v) for k, v in ref["inputs"].items()}


# -- the cross-attention sublayer --------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk", "noqk"])
def test_cross_attention_and_cross_kv_match_jax(qk_norm, backend):
    """One masked cross-attention over an encoder output, with the
    reference's init scales and non-unit norm scales: ``q_scale`` /
    ``k_scale`` are None with qk_norm off."""
    rng = np.random.default_rng(1)
    jp = jlayers.init_attn(jax.random.key(2), D, 4, 2, 16, qk_norm,
                           jnp.float32)
    if qk_norm:
        jp = jp._replace(q_scale=jnp.asarray(rng.uniform(0.5, 1.5, 16),
                                             jnp.float32),
                         k_scale=jnp.asarray(rng.uniform(0.5, 1.5, 16),
                                             jnp.float32))
    jp = jp._replace(norm=jnp.asarray(rng.uniform(0.5, 1.5, D), jnp.float32))
    x = rng.standard_normal((S * B, 3, D)).astype(np.float32)
    enc = rng.standard_normal((S * B, ENC_SEQ, D)).astype(np.float32)
    mcd_cfg = jmcd.MCDConfig(p=0.1, placement="Y", n_samples=S)
    jctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, mcd_cfg)
    jm = jlayers.site_mask(jctx, True, 1, jlayers.SITE_CROSS, D, jnp.float32)
    jk, jv = jlayers.cross_kv(jp, jnp.asarray(enc))
    want = _np(jlayers.cross_attention(jp, jnp.asarray(x), jk, jv, jm, 0.1))

    tp = tlayers.AttnParams(*(None if a is None else
                              torch.from_numpy(np.array(a)) for a in jp))
    assert (tp.q_scale is None) == (not qk_norm)
    tctx = tlayers.Ctx(tmcd.sample_rows(B, S), SEED, tmcd.MCDConfig(
        p=0.1, placement="Y", n_samples=S))
    tm = tlayers.site_mask(tctx, True, 1, tlayers.SITE_CROSS)
    tk, tv = tlayers.cross_kv(tp, torch.from_numpy(enc))
    _close(tk.numpy(), jk, LAYER_ATOL)
    _close(tv.numpy(), jv, LAYER_ATOL)
    got = tlayers.cross_attention(tp, torch.from_numpy(x), tk, tv, tm, 0.1,
                                  backend)
    assert got.shape == (S * B, 3, D)
    _close(got.numpy(), want, LAYER_ATOL)
    # the mask matters: unmasked differs
    plain = tlayers.cross_attention(tp, torch.from_numpy(x), tk, tv, None,
                                    0.1, backend)
    assert not np.allclose(plain.numpy(), want, atol=1e-3)


def test_site_masks_at_encoder_layers_and_the_cross_site():
    """Bits and the kernel path's values (``masked_activation``'s plain
    version, keyed by (seed, rows, layer, site)) at the encoder's layer
    ids and at SITE_CROSS equal the reference's exactly."""
    _, tcfg = _configs("audio")
    jctx = jlayers.Ctx(jmcd.sample_rows(B, S), SEED, _configs("audio")[0].mcd)
    x = np.random.default_rng(3).standard_normal((S * B, 4, D)).astype(
        np.float32)
    off = tbb.ENCODER_LAYER_OFFSET
    assert off == 10_000
    cases = [(off, tlayers.SITE_ATTN), (off + 1, tlayers.SITE_MLP),
             (off + 1, tlayers.SITE_ATTN), (0, tlayers.SITE_CROSS),
             (1, tlayers.SITE_CROSS)]
    seen = []
    for layer, site in cases:
        jm = jlayers.site_mask(jctx, True, layer, site, D, jnp.float32)
        tm = tlayers.site_mask(_ctx(tcfg), True, layer, site)
        assert np.array_equal(tm.bits(D, torch.float32).numpy(), _np(jm))
        want = _np(jlayers.apply_site_mask(jnp.asarray(x), jm, 0.1))
        for backend in ("cuda", "reference"):
            got = tlayers.apply_site_mask(torch.from_numpy(x), tm, 0.1,
                                          backend).numpy()
            assert np.array_equal(got, want)
        seen.append(_np(jm))
    # five different streams
    assert len({m.tobytes() for m in seen}) == len(cases)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_forward_matches_jax(ref, port, backend):
    tcfg = ref["tcfg"]
    lg, aux, caches = tbb.forward(port, tcfg, torch.from_numpy(ref["tokens"]),
                                  _ctx(tcfg), backend=backend, **_tin(ref))
    extra = PATCHES if ref["family"] == "vlm" else 0
    assert lg.shape == (S * B, L + extra, tcfg.vocab_size)
    assert caches is None
    _close(lg.numpy(), ref["forward"])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefill_and_teacher_forced_decode_match_jax(ref, port, backend):
    tcfg, family = ref["tcfg"], ref["family"]
    ctx = _ctx(tcfg)
    lg, st = tbb.prefill(port, tcfg, torch.from_numpy(ref["tokens"]), ctx,
                         _max_len(family), backend=backend, **_tin(ref))
    assert int(st.pos) == ref["pos"] == L + (PATCHES if family == "vlm"
                                             else 0)
    _close(lg.numpy(), ref["prefill"])
    for got, want in zip(_port_layers(st.caches), ref["prefill_caches"],
                         strict=True):
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape
            _close(a, b)
    if family == "audio":
        cross = _port_layers(st.cross)
        assert len(cross) == 2
        for got, want in zip(cross, ref["cross"], strict=True):
            for a, b in zip(got, want, strict=True):
                assert a.shape == b.shape == (S * B, ENC_SEQ, 2, 16)
                _close(a, b)
    else:
        assert st.cross is None and ref["cross"] is None
    for tok, want in zip(ref["decode"], ref["decode_logits"]):
        lg, st = tbb.decode_step(port, tcfg, torch.from_numpy(tok), st, ctx,
                                 backend=backend)
        _close(lg.numpy(), want)
    assert int(st.pos) == ref["pos"] + 3
    for got, want in zip(_port_layers(st.caches), ref["decode_caches"],
                         strict=True):
        for a, b in zip(got, want, strict=True):
            _close(a, b)


def test_init_decode_state_holds_zero_cross_kv():
    for family in FAMILIES:
        jcfg, tcfg = _configs(family)
        want = jbb.init_decode_state(jcfg, 3, 9, jnp.float32)
        got = tbb.init_decode_state(tcfg, 3, 9, device="cpu")
        assert int(got.pos) == 0
        if family == "vlm":
            assert got.cross is None and want.cross is None
            continue
        cross = _port_layers(got.cross)
        assert [[a.shape for a in c] for c in cross] == \
            [[a.shape for a in c] for c in _jax_layers(want.cross)]
        assert all(not a.any() for c in cross for a in c)
        assert len({id(a) for a in tree_leaves(got.cross)}) == 4


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_generate_matches_the_jax_engine(ref, port, backend):
    """Tokens equal, entropy and MI within 1e-5, for two requests on one
    engine with other frames (patches): on ``cuda`` the second
    ``generate`` replays the decode step over static buffers (on the
    CPU, without capture) whose cross K/V it must refill."""
    tcfg, family = ref["tcfg"], ref["family"]
    eng = BayesianEngine(port, tcfg, max_len=_max_len(family), seed=SEED,
                         device="cpu", backend=backend)
    for req, want in zip((ref["req"], ref["req2"]), ref["generate"]):
        res = eng.generate(ref["prompts"], N_NEW, **req)
        assert np.array_equal(res.tokens.numpy(), want["tokens"])
        _close(res.predictive_entropy.numpy(), want["entropy"])
        _close(res.mutual_information.numpy(), want["mi"])
        assert (res.mutual_information.numpy() > 1e-4).all()
    assert not np.array_equal(*(g["tokens"] for g in ref["generate"])) or \
        not np.allclose(*(g["entropy"] for g in ref["generate"]))
    if backend == "cuda":
        (entry,) = eng._graphs.values()
        assert int(entry.state.pos) == _max_len(family)
        if family == "audio":
            # the static cross K/V hold the last request's, bit for bit
            fresh = BayesianEngine(port, tcfg, max_len=_max_len(family),
                                   seed=SEED, device="cpu")
            fresh.generate(ref["prompts"], N_NEW, **ref["req2"])
            (other,) = fresh._graphs.values()
            for a, b in zip(tree_leaves(entry.state.cross),
                            tree_leaves(other.state.cross), strict=True):
                assert torch.equal(a, b)


def test_vlm_max_len_counts_the_patches():
    """Patches + prompt + new tokens up to ``max_len`` serve; one more
    raises at the decode step past the cache, and a prompt whose patches
    pass ``max_len`` raises at prefill."""
    tcfg = _configs("vlm")[1]
    params = tbb.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, tcfg.vocab_size, (B, L), dtype=np.int32)
    req = _inputs("vlm", rng, B)
    eng = BayesianEngine(params, tcfg, max_len=_max_len("vlm", 2),
                         seed=SEED, device="cpu")
    res = eng.generate(prompts, 2, **req)
    assert res.tokens.shape == (B, 2)
    with pytest.raises(ValueError, match="past the cache"):
        eng.generate(prompts, 3, **req)
    with pytest.raises(ValueError, match="exceeds max_len"):
        BayesianEngine(params, tcfg, max_len=L + PATCHES - 1, seed=SEED,
                       device="cpu").generate(prompts, 1, **req)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_fn_and_gradients_match_jax(ref, port, remat):
    tcfg = ref["tcfg"]
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(port)]
    params = tree_unflatten(port, leaves)
    ctx = tlayers.Ctx(torch.arange(S * B), SEED, tcfg.mcd)
    loss, metrics = tbb.loss_fn(params, tcfg,
                                torch.from_numpy(ref["tokens"]),
                                torch.from_numpy(ref["targets"]), ctx,
                                remat=remat, **_tin(ref))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - ref["loss"]) <= LM_LOSS_TOL
    assert abs(float(metrics["nll"].detach()) - ref["nll"]) <= LM_LOSS_TOL
    want = tree_leaves(bridge.from_numpy_backbone(ref["grads"], tcfg,
                                                  device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g.numpy(), w.numpy(), LM_GRAD_TOL)
    # the encoder's parameters get gradients through the cross K/V
    if ref["family"] == "audio":
        enc = {id(t) for t in tree_leaves(params["encoder_stages"])}
        assert all(float(g.abs().max()) > 0
                   for t, g in zip(leaves, grads) if id(t) in enc)


# -- the parameter tree -------------------------------------------------------

def test_stack_unstack_round_trips_an_encoder_decoder_tree(ref, port):
    stacked = tbb.stack_repeats(port)
    want = jax.tree_util.tree_leaves(ref["tree"])
    got = tree_leaves(stacked)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    back = tbb.unstack_repeats(stacked)
    assert set(back) == set(port)
    for a, b in zip(tree_leaves(back), tree_leaves(port), strict=True):
        assert torch.equal(a, b)
    if ref["family"] == "audio":
        assert set(port) == {"embed", "stages", "encoder_stages",
                             "encoder_norm"}
        assert set(port["stages"][0][1][0]) == {"mixer", "cross", "ffn"}


def test_init_params_has_the_reference_structure():
    for family in FAMILIES:
        jcfg, tcfg = _configs(family)
        want = jax.eval_shape(lambda k: jbb.init_params(k, jcfg,
                                                        jnp.float32),
                              jax.random.key(0))
        got = tbb.stack_repeats(tbb.init_params(
            tcfg, torch.Generator().manual_seed(0), device="cpu"))
        assert [tuple(t.shape) for t in tree_leaves(got)] == \
            [a.shape for a in jax.tree_util.tree_leaves(want)]


# -- the planning stack -------------------------------------------------------

AXES = {"data": 16, "model": 16}


def _jleaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _tleaves(tree):
    return [tuple(s) for s in tree_leaves(tree)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_shardings_equal_jax(family, fsdp):
    jcfg, tcfg = _configs(family)
    jpo = jsh.Policy(axes=AXES, dp=("data",), fsdp=fsdp)
    tpo = shardings.Policy(axes=AXES, dp=("data",), fsdp=fsdp)
    got = shardings.param_specs(tcfg, tpo)
    assert _tleaves(tbb.stack_repeats(got, stack=shardings.stack_specs)) == \
        _jleaves(jsh.param_specs(jcfg, jpo))
    for batch in (128, 1):
        want = jsh.cache_specs(jcfg, jpo, batch)
        st = shardings.cache_specs(tcfg, tpo, batch)
        def stacked(tree):
            return tbb.stack_repeats({"stages": tree},
                                     stack=shardings.stack_specs)["stages"]

        assert _tleaves(stacked(st.caches)) == _jleaves(want.caches)
        if family == "audio":
            assert _tleaves(stacked(st.cross)) == _jleaves(want.cross)
        else:
            assert st.cross is None and want.cross is None


def _jsig(tree):
    out = []
    for leaf in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, jlayers.Ctx)):
        if isinstance(leaf, jlayers.Ctx):
            out.append(("ctx", tuple(leaf.rows.shape)))
        else:
            out.append((tuple(leaf.shape), str(leaf.dtype)))
    return out


def _tsig(tree):
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, tlayers.Ctx):
            out.append(("ctx", tuple(leaf.rows.shape)))
        else:
            out.append((tuple(leaf.shape),
                        str(leaf.dtype).removeprefix("torch.")))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_input_specs_and_probes_equal_jax(family):
    """``model_input_specs`` (frames; patches with seq - num_patches
    tokens) and every probe's name, multiplier and argument shapes at the
    four cells, against the reference on its host mesh."""
    jcfg, tcfg = _configs(family)
    jpo = jsh.Policy(axes=AXES, dp=("data",))
    tpo = shardings.Policy(axes=AXES, dp=("data",))
    for targets in (False, True):
        ja, js = jspecs.model_input_specs(jcfg, 128, 64, with_targets=targets,
                                          po=jpo)
        ta, ts = specs.model_input_specs(tcfg, 128, 64, with_targets=targets,
                                         po=tpo)
        assert sorted(ta) == sorted(ja)
        assert _tsig(ta) == _jsig(ja)
        assert {k: tuple(v) for k, v in ts.items()} == \
            {k: tuple(v) for k, v in js.items()}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        want = jspecs.probe_jobs(jcfg, shape, jmesh.make_host_mesh())
        got = specs.probe_jobs(tcfg, shape, tmesh.make_production_mesh())
        assert [(p.name, p.multiplier) for p in got] == \
            [(p.name, p.multiplier) for p in want]
        if family == "audio" and shape != "decode_32k":
            assert [p.name for p in got if p.name.startswith("enc")] == \
                ["enc0.0:enc_attn.mlp"]
        for g, w in zip(got, want):
            args = g.args
            if g.name == "opt:adamw":      # the reference's stacked layout
                p, gr, opt = args
                args = (shardings.stacked(p), shardings.stacked(gr),
                        opt._replace(m=shardings.stacked(opt.m),
                                     v=shardings.stacked(opt.v)))
            assert _tsig(args) == _jsig(w.args), (shape, g.name)


@pytest.mark.parametrize("family", FAMILIES)
def test_active_params_and_model_flops_equal_jax(family):
    jcfg, tcfg = _configs(family)
    assert tanalysis.active_params(tcfg) == janalysis.active_params(jcfg)
    for shape in JSHAPES:
        for chips in (1, 256):
            assert tanalysis.model_flops(tcfg, tconfig.SHAPES[shape],
                                         chips) == \
                janalysis.model_flops(jcfg, JSHAPES[shape], chips)


SMALL = {"train_4k": ShapeCell("train_4k", 16, 4, "train"),
         "prefill_32k": ShapeCell("prefill_32k", 32, 2, "prefill"),
         "decode_32k": ShapeCell("decode_32k", 16, 2, "decode")}


@pytest.mark.parametrize("family", FAMILIES)
def test_fake_count_equals_real_count(family, monkeypatch):
    """``analysis.count`` runs on both configs' jobs and probes: on fake
    tensors exactly what it counts on real CPU tensors, and for decode
    the probes' flops compose to the whole step's."""
    for name, cell in SMALL.items():
        monkeypatch.setitem(tconfig.SHAPES, name, cell)
    tcfg = _configs(family)[1]
    mesh = tmesh.make_production_mesh()
    for shape in SMALL:
        fake = specs.probe_jobs(tcfg, shape, mesh)
        real = specs.probe_jobs(tcfg, shape, mesh, device="cpu", fake=False)
        total = 0
        for f, r in zip(fake, real, strict=True):
            cf = tanalysis.count(f.fn, *f.args)
            cr = tanalysis.count(r.fn, *r.args)
            assert cf.flops > 0 or f.name == "opt:adamw"
            assert (cf.flops, cf.bytes, cf.ops) == (cr.flops, cr.bytes,
                                                    cr.ops), (shape, f.name)
            total += cf.flops * f.multiplier
        jf = specs.make_job(tcfg, shape, mesh)
        jr = specs.make_job(tcfg, shape, mesh, device="cpu", fake=False)
        whole = tanalysis.count(jf.fn, *jf.args)
        assert (whole.flops, whole.bytes) == tuple(
            getattr(tanalysis.count(jr.fn, *jr.args), k)
            for k in ("flops", "bytes"))
        if shape == "decode_32k":
            assert total == whole.flops


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_launcher_serves_frames_and_patches(family, monkeypatch, capsys):
    tcfg = _configs(family)[1]
    monkeypatch.setattr(tserve, "get_config",
                        lambda arch, reduced=True: tcfg)
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "4", "--new-tokens", "3", "--samples", "2"])
    assert res.tokens.shape == (2, 3)
    assert np.isfinite(res.predictive_entropy.numpy()).all()
    out = capsys.readouterr().out
    assert f"arch=tiny-{family} S=2" in out and "req 1:" in out


def test_configs_are_field_for_field_equal():
    for family in FAMILIES:
        for qk in (True, False):
            jcfg, tcfg = _configs(family, qk)
            assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
