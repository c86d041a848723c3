"""The port's LM planning stack (``repro_torch.launch.specs``, ``dryrun``,
``hillclimb`` over ``launch.analysis.count``) held against the JAX
package's ``repro.launch.specs`` on the CPU.

* Probe names and multipliers equal to the reference's ``probe_jobs`` (on
  ``make_host_mesh()``) for all six configs x the applicable shapes, and
  every argument's shape and dtype equal to the reference's
  ``ShapeDtypeStruct`` (full width: ``jax.eval_shape`` on one side, fake
  tensors on the other); the whole jobs' arguments too, through the
  stacked layout.
* On REDUCED configs and small cells: a fake-tensor count equal to the
  count of the same probe on real CPU tensors, exactly (flops, bytes,
  ops: the counterpart of the card's check); the probe composition
  against the whole step's count.
* The hillclimb variants: ``moe_shard`` and ``seqpar`` give bit-equal
  outputs and counts; ``moe_group``, ``kv8``, ``chunkN`` and
  ``flash_block`` move the counts they should.
* ``dryrun.main`` exits 0 on a reduced cell (and 1 on an error record);
  ``hillclimb.main`` runs.

No JAX program is compiled: the reference's side is ``jax.eval_shape``.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import mesh as jmesh, specs as jspecs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves  # noqa: E402
from repro_torch.configs import ALIASES, get_config as tget  # noqa: E402
from repro_torch.launch import (analysis, dryrun, hillclimb,  # noqa: E402
                                mesh as tmesh, shardings, specs)
from repro_torch.models import layers as tlayers, moe as tmoe  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402

ARCHS = sorted(ALIASES)
#: Small cells for the counts that run for real on the CPU.
SMALL = {"train_4k": ShapeCell("train_4k", 16, 4, "train"),
         "prefill_32k": ShapeCell("prefill_32k", 32, 2, "prefill"),
         "decode_32k": ShapeCell("decode_32k", 16, 2, "decode"),
         "long_500k": ShapeCell("long_500k", 24, 1, "decode")}
#: The whole train step against its probes.  Flops: the same products,
#: but the whole step checkpoints a repeat's period of blocks (remat) and
#: a probe one block, and non-reentrant checkpointing stops recomputing
#: once the tensors the backward reads are back: the products at the tail
#: of a segment, whose outputs no backward reads, are not recomputed.  A
#: probe skips such a tail every block, the whole step once a period: the
#: flops are equal where every period is one block, and within
#: TRAIN_FLOPS_RTOL for jamba's period of 8 (0.54% on REDUCED).  Bytes:
#: an unfused count of different programs (the whole step's gradient
#: sums and global norm, the probes' per-block checkpoints), within
#: TRAIN_BYTES_RTOL.
TRAIN_FLOPS_RTOL = 0.01
TRAIN_BYTES_RTOL = 0.10


@pytest.fixture
def small_cells(monkeypatch):
    for name, cell in SMALL.items():
        monkeypatch.setitem(tconfig.SHAPES, name, cell)


@pytest.fixture
def reduced_hillclimb(monkeypatch):
    monkeypatch.setattr(hillclimb, "get_config",
                        lambda a: tget(a, reduced=True))


def _applicable(arch):
    return [s for s in sorted(JSHAPES)
            if tconfig.shape_applicable(tget(arch), s)[0]]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_probes_equal_jax(arch):
    """Names, multipliers and argument shapes of every probe."""
    jcfg, tcfg = jget(arch), tget(arch)
    for shape in _applicable(arch):
        want = jspecs.probe_jobs(jcfg, shape, jmesh.make_host_mesh())
        got = specs.probe_jobs(tcfg, shape, tmesh.make_production_mesh())
        assert [(p.name, p.multiplier) for p in got] == \
            [(p.name, p.multiplier) for p in want]
        for g, w in zip(got, want):
            args = g.args
            if g.name == "opt:adamw":      # the reference's stacked layout
                p, gr, opt = args
                args = (shardings.stacked(p), shardings.stacked(gr),
                        opt._replace(m=shardings.stacked(opt.m),
                                     v=shardings.stacked(opt.v)))
            assert _tsig(args) == _jsig(w.args), (shape, g.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_job_arguments_equal_jax(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    for shape in _applicable(arch):
        want = jspecs.make_job(jcfg, shape, jmesh.make_host_mesh())
        got = specs.make_job(tcfg, shape, tmesh.make_production_mesh())
        assert got.kind == want.kind and got.name == want.name
        args = list(got.args)
        args[0] = shardings.stacked(args[0])
        if got.kind == "train":
            opt = args[1]
            args[1] = opt._replace(m=shardings.stacked(opt.m),
                                   v=shardings.stacked(opt.v))
        if got.kind == "decode":
            st = args[2]
            args[2] = st._replace(caches=shardings.stacked(
                {"stages": st.caches})["stages"])
        assert _tsig(args) == _jsig(want.args), shape


def _count_equal(a, b):
    return (a.flops, a.bytes, a.ops) == (b.flops, b.bytes, b.ops)


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_count_equals_real_count(arch, small_cells):
    """The counterpart of the card's check: each probe counted on fake
    tensors and on real CPU tensors, exactly equal."""
    cfg = tget(arch, reduced=True)
    mesh = tmesh.make_production_mesh()
    for shape in _applicable(arch):
        with tlayers.attention_override(
                **specs._attn_blocks_for(SMALL[shape].seq_len)):
            fake = specs.probe_jobs(cfg, shape, mesh)
            real = specs.probe_jobs(cfg, shape, mesh, device="cpu",
                                    fake=False)
            for f, r in zip(fake, real):
                cf = analysis.count(f.fn, *f.args)
                cr = analysis.count(r.fn, *r.args)
                assert cf.flops > 0 or f.name == "opt:adamw"
                assert _count_equal(cf, cr), (shape, f.name, cf, cr)
            if shape == "decode_32k":
                jf = specs.make_job(cfg, shape, mesh)
                jr = specs.make_job(cfg, shape, mesh, device="cpu",
                                    fake=False)
                assert _count_equal(analysis.count(jf.fn, *jf.args),
                                    analysis.count(jr.fn, *jr.args))


def _composition(cfg, shape, mesh):
    tot_f = tot_b = 0
    head = None
    for pr in specs.probe_jobs(cfg, shape, mesh):
        c = analysis.count(pr.fn, *pr.args)
        tot_f += c.flops * pr.multiplier
        tot_b += c.bytes * pr.multiplier
        if pr.name.startswith("head"):
            head = c
    return tot_f, tot_b, head


@pytest.mark.parametrize("arch", ARCHS)
def test_composition_against_the_whole_step(arch, small_cells):
    """Σ body x repeat + head (+ opt) against one count of the whole step.
    Decode: flops equal.  Prefill: equal once the head probe's logits over
    all S positions (the reference's probe) are counted at the one
    position a prefill takes.  Train: see TRAIN_FLOPS_RTOL."""
    cfg = tget(arch, reduced=True)
    mesh = tmesh.make_production_mesh()
    for shape in _applicable(arch):
        cell = SMALL[shape]
        with tlayers.attention_override(
                **specs._attn_blocks_for(cell.seq_len)):
            job = specs.make_job(cfg, shape, mesh)
            whole = analysis.count(job.fn, *job.args)
            flops, nbytes, head = _composition(cfg, shape, mesh)
        if cell.kind == "prefill":
            B, V, D = cell.global_batch, cfg.vocab_size, cfg.d_model
            assert head.flops == 2 * B * cell.seq_len * D * V
            flops -= head.flops - head.flops // cell.seq_len
        one_block = all(len(st.pattern) == 1 for st in cfg.stages)
        if cell.kind != "train" or one_block:
            assert flops == whole.flops, (shape, flops, whole.flops)
        else:
            assert 0 < 1 - flops / whole.flops <= TRAIN_FLOPS_RTOL
        if cell.kind == "train":
            assert abs(nbytes / whole.bytes - 1) <= TRAIN_BYTES_RTOL


def _probe(cfg, shape, name, variants=(), **kw):
    mesh = tmesh.make_production_mesh()
    with hillclimb.variant_ctx(set(variants), mesh):
        pr = next(p for p in specs.probe_jobs(cfg, shape, mesh,
                                              device="cpu", fake=False,
                                              **kw)
                  if p.name.startswith(name))
        return analysis.count(pr.fn, *pr.args)


def _same_out(a, b):
    la = [t for t in tree_leaves(a) if isinstance(t, torch.Tensor)]
    lb = [t for t in tree_leaves(b) if isinstance(t, torch.Tensor)]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("variant,arch,shape,probe", [
    ("moe_shard", "olmoe-1b-7b", "train_4k", "blk"),
    ("moe_shard", "jamba-1.5-large-398b", "prefill_32k", "blk0.1"),
    ("seqpar", "qwen3-1.7b", "train_4k", "blk"),
    ("seqpar", "deepseek-v2-lite-16b", "prefill_32k", "blk1.0"),
])
def test_identity_variants_change_nothing(variant, arch, shape, probe,
                                          small_cells):
    """``moe_shard`` and ``seqpar`` only name mesh axes: on the port's one
    device the outputs are bit-equal and the counts equal."""
    cfg = tget(arch, reduced=True)
    base = _probe(cfg, shape, probe)
    var = _probe(cfg, shape, probe, (variant,))
    assert _count_equal(base, var)
    assert _same_out(base.out, var.out)


def test_counting_variants_move_their_counts(small_cells,
                                             reduced_hillclimb):
    olmoe = tget("olmoe-1b-7b", reduced=True)
    base = _probe(olmoe, "prefill_32k", "blk")
    grouped = _probe(olmoe, "prefill_32k", "blk", ("moe_group",))
    # 16 dispatches of 4 tokens, each at the least capacity (8 slots)
    assert grouped.ops > base.ops and grouped.bytes > base.bytes
    qwen = tget("qwen3-1.7b", reduced=True)
    kv = _probe(qwen, "decode_32k", "dec")
    kv8 = _probe(qwen, "decode_32k", "dec", kv_quant=True)
    assert kv8.bytes != kv.bytes
    m = hillclimb.measure("mamba2-370m", "prefill_32k", set())
    m8 = hillclimb.measure("mamba2-370m", "prefill_32k", {"chunk8"})
    assert m8["flops"] != m["flops"]
    for v in ("moe_shard", "seqpar"):
        r = hillclimb.measure("olmoe-1b-7b", "train_4k", {v})
        b = hillclimb.measure("olmoe-1b-7b", "train_4k", set())
        assert (r["flops"], r["bytes"]) == (b["flops"], b["bytes"])


def test_flash_block_moves_bytes_not_flops(reduced_hillclimb, monkeypatch):
    monkeypatch.setitem(tconfig.SHAPES, "prefill_32k",
                        ShapeCell("prefill_32k", 1024, 1, "prefill"))
    base = hillclimb.measure("qwen3-1.7b", "prefill_32k", set(),
                             probe_filter="blk")
    flash = hillclimb.measure("qwen3-1.7b", "prefill_32k", {"flash_block"},
                              probe_filter="blk")
    assert flash["flops"] == base["flops"]
    assert flash["bytes"] != base["bytes"]


def test_dryrun_main_on_a_reduced_cell(small_cells, monkeypatch, tmp_path,
                                       capsys):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tget(a, reduced=True))
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "qwen3-1.7b", "--shape", "decode_32k",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    assert dryrun.main([*argv, "--measure", "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "ok"]
    rec = recs[1]
    assert rec["chips"] == 256 and rec["per_device"].startswith("ideal")
    assert rec["composition_flops"] == rec["whole_flops"]
    assert rec["raw_flops_per_device"] == rec["whole_flops"] / 256
    assert rec["memory"]["params"] > 0 and rec["memory"]["caches"] > 0
    assert rec["gpu_model"]["hw"] == {"data": 16, "model": 16, "pod": 1,
                                      "microbatches": 1, "fsdp": False,
                                      "remat": True}
    assert [m["probe"] for m in rec["measured"]] == [
        p["probe"] for p in rec["probes"]]
    assert all(m["equal"] and m["device"] == "cpu" for m in rec["measured"])
    # the bound moves each input and output once: no more than the plain
    # path's unfused count at the same flops
    assert all(0 < m["bound_ms"] <= m["t_unfused_ms"]
               for m in rec["measured"])
    # a long_500k cell of a full-attention arch is skipped, as JAX's
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k"]) == 0
    # an error record exits 1
    monkeypatch.setattr(specs, "make_job", lambda *a, **k: 1 / 0)
    assert dryrun.main(argv[:4]) == 1
    assert "ZeroDivisionError" in capsys.readouterr().out


def test_io_bytes_counts_each_tensor_once():
    """``analysis.io_bytes``: each distinct input read once, an output that
    is one of the inputs (a cache updated in place) not counted again, a
    new output written once."""
    cache = torch.zeros((4, 8), dtype=torch.bfloat16)
    w = torch.ones((8, 3))

    def fn(cache, w, same):
        cache[0] = 1.0
        return cache, cache[0].float() @ w

    out = fn(cache, w, w)
    assert analysis.io_bytes((cache, w, w), out) == 64 + 96 + 12


def test_hillclimb_main_runs(small_cells, reduced_hillclimb, capsys):
    recs = hillclimb.main(["--arch", "olmoe-1b-7b", "--shape", "train_4k",
                           "--variants", "base;moe_group;moe_shard+seqpar"])
    out = capsys.readouterr().out
    assert [r["variant"] for r in recs] == ["base", "moe_group",
                                            "moe_shard+seqpar"]
    assert recs[2]["flops"] == recs[0]["flops"]
    assert "the identity on the port's one device" in out


def test_widened_experts_under_autograd_equal_one_product(monkeypatch):
    """The fault the dry run found: a bf16 MoE layer past WIDEN_BYTES
    multiplied into ``out=``, which autograd refuses (jamba's train step).
    The pieces are now assigned into slices of one buffer, which autograd
    records: the same output and gradients as one product."""
    cfg = dataclasses.replace(tget("olmoe-1b-7b", reduced=True).moe)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, 32, cfg, torch.bfloat16, "cpu")
    x = torch.randn((cfg.num_experts, 5, 32), generator=gen).to(
        torch.bfloat16)

    def run():
        wi = p.wi.detach().requires_grad_(True)
        xe = x.detach().requires_grad_(True)
        y = tmoe._experts(xe, p._replace(wi=wi))
        y.float().sum().backward()
        return y, wi.grad, xe.grad

    whole = run()
    monkeypatch.setattr(tmoe, "WIDEN_BYTES", p.wi[0].numel() * 4)
    pieces = run()
    for a, b in zip(whole, pieces):
        assert torch.equal(a, b)
