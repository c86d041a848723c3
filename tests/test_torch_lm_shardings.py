"""The port's sharding rules (``repro_torch.launch.shardings``) held
against the JAX package's ``repro.launch.shardings`` on the CPU.

* ``param_specs`` leaf for leaf equal to the reference's, as tuples,
  through the stacked layout (``backbone.stack_repeats`` with
  ``shardings.stack_specs``: the reference prefixes ``None`` for a stacked
  repeat), for all six configs x {tp, tp+fsdp} on the 16 x 16 axes (and
  the 2 x 16 x 16 pod axes);
* ``cache_specs`` equal at batch 128 and 1, with and without ``kv_quant``;
* ``optstate_specs`` equal for llama3-8b (the reference's parameter shapes
  from ``jax.eval_shape``, the port's fake tensors);
* ``batch_spec`` equal;
* every sharded dim of the port's own full-width fake shapes divides its
  axes; ``shard_bytes`` prices a tree as its splits say.

No JAX program is compiled: the reference's specs are Python, its shapes
``jax.eval_shape``.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves  # noqa: E402
from repro_torch.configs import ALIASES, get_config as tget  # noqa: E402
from repro_torch.launch import shardings as tsh, specs  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

ARCHS = sorted(ALIASES)
AXES = {"data": 16, "model": 16}
POD_AXES = {"pod": 2, "data": 16, "model": 16}
POLICIES = {
    "tp": dict(axes=AXES, dp=("data",)),
    "tp+fsdp": dict(axes=AXES, dp=("data",), fsdp=True),
    "pod+fsdp": dict(axes=POD_AXES, dp=("pod", "data"), fsdp=True),
}


def _jleaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _tleaves(tree):
    return [tuple(s) for s in tree_leaves(tree)]


def _stacked(tree):
    return tbb.stack_repeats(tree, stack=tsh.stack_specs)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, policy):
    kw = POLICIES[policy]
    want = jsh.param_specs(jget(arch), jsh.Policy(**kw))
    got = tsh.param_specs(tget(arch), tsh.Policy(**kw))
    assert _tleaves(_stacked(got)) == _jleaves(want)
    # the unstacked tree holds one block spec a repeat, as the port's
    # parameters hold one block a repeat
    cfg = tget(arch)
    assert [len(sp) for sp in got["stages"]] == [st.repeat
                                                 for st in cfg.stages]
    # and specs of the reference's stacked layout only prepend None
    for sp, jsp in zip(got["stages"], want["stages"]):
        for j, blk in enumerate(sp[0]):
            assert [(None, *s) for s in _tleaves(blk)] == _jleaves(jsp[j])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv", "kv8"])
@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, batch, kv_quant):
    for policy in ("tp", "pod+fsdp"):
        kw = POLICIES[policy]
        want = jsh.cache_specs(jget(arch), jsh.Policy(**kw), batch,
                               kv_quant=kv_quant)
        got = tsh.cache_specs(tget(arch), tsh.Policy(**kw), batch,
                              kv_quant=kv_quant)
        assert tuple(got.pos) == tuple(want.pos)
        assert got.cross is None and want.cross is None
        stacked = _stacked({"stages": got.caches})["stages"]
        assert _tleaves(stacked) == _jleaves(want.caches)
        # the port's block caches have the shapes these specs name
        st0 = tget(arch).stages[0]
        cache = tbb.init_block_cache(tget(arch), st0.pattern[0], batch,
                                     8, kv_quant=kv_quant, device="cpu")
        assert [len(s) for s in tree_leaves(got.caches[0][0][0])] == \
            [t.dim() for t in tree_leaves(cache)]


@pytest.mark.parametrize("policy", ["tp", "tp+fsdp"])
def test_optstate_specs_equal_jax_for_llama3(policy):
    kw = POLICIES[policy]
    jcfg, tcfg = jget("llama3-8b"), tget("llama3-8b")
    jpo, tpo = jsh.Policy(**kw), tsh.Policy(**kw)
    shapes = jax.eval_shape(functools.partial(
        jbb.init_params, cfg=jcfg, dtype=jnp.bfloat16), jax.random.key(0))
    want = jsh.optstate_specs(jsh.param_specs(jcfg, jpo), jpo, shapes)
    build = specs._Build()
    with build.mode:
        params = build.params(tcfg)
    got = tsh.optstate_specs(tsh.param_specs(tcfg, tpo), tpo, params)
    assert tuple(got.step) == tuple(want.step)
    assert _tleaves(got.m) == _jleaves(want.m)
    assert _tleaves(got.v) == _jleaves(want.v)
    # the stand-ins carry the reference's stacked shapes
    assert [s.shape for s in tree_leaves(tsh.stacked(params))] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]


def test_batch_spec_equal_jax():
    for kw in POLICIES.values():
        for batch in (1, 2, 16, 32, 128, 256, 100):
            assert tsh.batch_spec(batch, tsh.Policy(**kw)) == \
                jsh.batch_spec(batch, jsh.Policy(**kw))


def _divides(tree, spec_tree, axes, what):
    for t, s in zip(tree_leaves(tree), tree_leaves(spec_tree), strict=True):
        assert len(s) <= t.dim(), (what, s, t.shape)
        for dim, part in zip(t.shape, s):
            if part is not None:
                n = tsh.shard_factor(tsh.P(part), axes)
                assert dim % n == 0, (what, s, t.shape)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_dims_divide_their_axes(arch, policy):
    """The port's own full-width fake parameters, moments and caches under
    their specs: every split dim divides by its axes' sizes."""
    cfg = tget(arch)
    po = tsh.Policy(**POLICIES[policy])
    build = specs._Build()
    with build.mode:
        params = build.params(cfg)
        states = [tbb.init_decode_state(cfg, b, 4096, torch.bfloat16,
                                        kv_quant=q, device="cpu")
                  for b in (128, 1) for q in (False, True)]
    pspecs = tsh.param_specs(cfg, po)
    _divides(params, pspecs, po.axes, "params")
    ospecs = tsh.optstate_specs(pspecs, po, params)
    _divides(tsh.stacked(params), ospecs.m, po.axes, "moments")
    for st, (b, q) in zip(states, [(128, False), (128, True), (1, False),
                                   (1, True)]):
        _divides(st, tsh.cache_specs(cfg, po, b, q), po.axes, "caches")
    # shard_bytes: each leaf's bytes over its split
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    got = tsh.shard_bytes(params, pspecs, po.axes)
    assert 0 < got <= total
    assert tsh.shard_bytes(params, tsh.param_specs(
        cfg, tsh.Policy(axes={"data": 1, "model": 1}, dp=("data",))),
        {"data": 1, "model": 1}) == total


def test_p_is_a_leaf_and_compares_as_its_tuple():
    p = tsh.P(None, ("pod", "data"), "model")
    assert tuple(p) == tuple(JP(None, ("pod", "data"), "model"))
    assert p == (None, ("pod", "data"), "model") and len(p) == 3
    assert tree_leaves({"a": [p, None, tsh.P()]}) == [p, tsh.P()]
    with pytest.raises(ValueError, match="disagree"):
        tsh.stack_specs([tsh.P("model"), tsh.P(None)])
