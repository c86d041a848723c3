"""The LM half of the design-space exploration in the port
(``repro_torch.launch.analysis``, ``repro_torch.dse.gpu_model``'s LM half,
``repro_torch.examples.codesign_search``'s mesh half) held against the JAX
package's ``repro.launch.analysis``, ``repro.dse.tpu_model`` and
``examples/codesign_search.py`` on the CPU.

* ``active_params`` float-equal for all six configs, full and REDUCED;
  ``model_flops`` for all six x ``SHAPES`` x chips {1, 256, 512}.
* With the port's peaks set to the reference's (197e12, 819e9, 50e9):
  ``step_model`` and ``memory_model`` bit-equal to ``tpu_model``'s for all
  six x the four shapes x a grid of hardware points; ``search_hw`` the
  same rows in the same order under the reference's 16 GB, pods 1 and 2;
  the example's mesh picks the reference example's.
* At the H100's own peaks: the bf16 peak is the LM's, the recurrent half
  keeps its fp32 CUDA-core peak.

Pure arithmetic on both sides: no JAX program is traced.
"""

import contextlib
import dataclasses
import io
import itertools
import pathlib
import runpy

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.dse import tpu_model  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro_torch.configs import ALIASES, get_config as tget  # noqa: E402
from repro_torch.dse import gpu_model  # noqa: E402
from repro_torch.examples import codesign_search  # noqa: E402
from repro_torch.launch import analysis as tanalysis  # noqa: E402
from repro_torch.models.config import SHAPES as TSHAPES  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(ALIASES)
#: The reference's roofline peaks (``repro.launch.analysis``).
REF_PEAKS = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}
HW_GRID = [dict(data=d, model=m, pod=pod, microbatches=mb, fsdp=fsdp,
                remat=remat)
           for (d, m), pod, mb, fsdp, remat in itertools.product(
               ((16, 16), (1, 1), (256, 1), (4, 64), (32, 8)), (1, 2),
               (1, 4), (False, True), (True, False))]


@pytest.fixture
def ref_peaks(monkeypatch):
    """The port's LM roofline priced at the reference's peaks."""
    for name, value in REF_PEAKS.items():
        monkeypatch.setattr(tanalysis, name, value)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_equal_jax(arch, reduced):
    want = janalysis.active_params(jget(arch, reduced))
    got = tanalysis.active_params(tget(arch, reduced))
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("shape", sorted(TSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch, shape):
    assert dataclasses.asdict(TSHAPES[shape]) == \
        dataclasses.asdict(JSHAPES[shape])
    for chips in (1, 256, 512):
        assert tanalysis.model_flops(tget(arch), TSHAPES[shape], chips) == \
            janalysis.model_flops(jget(arch), JSHAPES[shape], chips)


def test_hw_config_equals_tpu_config():
    fields = [f.name for f in dataclasses.fields(gpu_model.GpuHwConfig)]
    assert fields == [f.name for f in dataclasses.fields(
        tpu_model.TpuHwConfig)]
    assert gpu_model.GpuHwConfig() == gpu_model.GpuHwConfig(
        **dataclasses.asdict(tpu_model.TpuHwConfig()))
    for kw in HW_GRID:
        g, t = gpu_model.GpuHwConfig(**kw), tpu_model.TpuHwConfig(**kw)
        assert (g.chips, g.dp) == (t.chips, t.dp)


@pytest.mark.parametrize("shape", sorted(TSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_and_memory_model_bit_equal_at_the_reference_peaks(
        arch, shape, ref_peaks):
    tcfg, jcfg = tget(arch), jget(arch)
    for kw in HW_GRID:
        got = gpu_model.step_model(tcfg, TSHAPES[shape],
                                   gpu_model.GpuHwConfig(**kw))
        want = tpu_model.step_model(jcfg, JSHAPES[shape],
                                    tpu_model.TpuHwConfig(**kw))
        assert got == want, (kw, got, want)
        assert gpu_model.memory_model(
            tcfg, TSHAPES[shape], gpu_model.GpuHwConfig(**kw)) == \
            tpu_model.memory_model(jcfg, JSHAPES[shape],
                                   tpu_model.TpuHwConfig(**kw))


def _rows(rows):
    return [({k: v for k, v in r.items() if k != "hw"},
             dataclasses.asdict(r["hw"])) for r in rows]


@pytest.mark.parametrize("pod", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_search_hw_equal_jax_at_the_reference_peaks(arch, pod, ref_peaks):
    for shape in sorted(TSHAPES):
        got = gpu_model.search_hw(tget(arch), TSHAPES[shape], chips=256,
                                  hbm_limit=16e9, pod=pod)
        want = tpu_model.search_hw(jget(arch), JSHAPES[shape], chips=256,
                                   hbm_limit=16e9, pod=pod)
        assert got and _rows(got) == _rows(want)


def _picks_line(arch, pods, best):
    hw = best["hw"]
    return (f"{arch:24s} → pods={pods} mesh=({hw.data}×{hw.model}) "
            f"mb={hw.microbatches} fsdp={hw.fsdp} "
            f"mem={best['mem']/1e9:.1f} GB t_step={best['t_step']:.2f}s "
            f"bound={'C' if best['t_compute']==best['t_step'] else 'M/X'}")


def test_example_mesh_picks_equal_the_reference_example(ref_peaks):
    """The reference example's TPU lines (run as a script) against the
    port's picks under the reference's 16 GB and peaks, field for field
    (the reference's own format)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / "codesign_search.py"),
                       run_name="__main__")
    want = out.getvalue().split("=== TPU DSE")[1].strip().splitlines()[1:]
    picks = codesign_search.mesh_picks(hbm_limit=16e9)
    got = [_picks_line(a, *p) if p else f"{a:24s} infeasible even at 2 pods"
           for a, p in picks.items()]
    assert got == want
    # and the picks are those search_hw ranks first
    for arch, (pods, best) in picks.items():
        rows = tpu_model.search_hw(jget(arch), JSHAPES["train_4k"],
                                   chips=256, hbm_limit=16e9, pod=pods)
        first = next(r for r in rows if r["feasible"])
        assert dataclasses.asdict(first["hw"]) == \
            dataclasses.asdict(best["hw"])


def test_the_h100_peaks_are_the_lm_models():
    """The LM half prices at the bf16 tensor-core peak; the recurrent
    half keeps its fp32 CUDA-core peak (the two are named apart)."""
    assert tanalysis.PEAK_FLOPS == 989e12
    assert tanalysis.HBM_BW == gpu_model.HBM_BW == 3.35e12
    assert gpu_model.PEAK_FLOPS == 67e12
    cfg, cell = tget("llama3-8b"), TSHAPES["decode_32k"]
    got = gpu_model.step_model(cfg, cell, gpu_model.GpuHwConfig())
    assert got["t_compute"] == got["flops"] / 989e12
    assert got["t_memory"] == got["bytes"] / 3.35e12
    assert got["t_collective"] == got["coll"] / tanalysis.ICI_BW


def test_example_prints_both_halves(capsys):
    picks = codesign_search.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== FPGA DSE" in out and "=== GPU DSE" in out
    assert set(picks["mesh"]) == set(codesign_search.MESH_ARCHS)
    for arch, got in picks["mesh"].items():
        assert got is not None and got[1]["feasible"]
        assert got[1]["mem"] <= 80e9
