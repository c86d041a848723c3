"""Rules the port keeps: it never imports JAX or the reference package, its
entry points run on CUDA unless the caller asks for the CPU (and raise
without a GPU instead of falling back), and what is not ported yet raises.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import classifier as clf, mcd, rnn  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import stream as launch_stream  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in (ROOT / "src" / "repro_torch").rglob("*.py"))


_IMPORT_EACH_FIRST = """
import importlib, sys
for mod in sys.argv[1:]:
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    importlib.import_module(mod)
"""


def test_each_module_imports_first():
    """Each port module imports with no other port module loaded before it:
    no import cycle depends on which module a caller happens to import
    first (one interpreter; the port's modules are dropped between tries).
    """
    out = subprocess.run([sys.executable, "-c", _IMPORT_EACH_FIRST,
                          *PORT_MODULES], capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "triton"), \
            f"{path.name} imports {mod}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_model():
    cfg = clf.ClassifierConfig(mcd=mcd.MCDConfig(placement="YNY",
                                                 n_samples=2))
    return cfg, clf.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")


def test_entry_points_raise_without_gpu(no_gpu):
    cfg, params = _cpu_model()
    x = torch.zeros((2, 3, 1))
    rows = torch.arange(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clf.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clf.apply(params, x, rows, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rnn.run_stack(params["encoder"], x, rnn.stack_mask_plan(cfg.mcd, 3),
                      0.125, backend="cuda_seq", rows=rows)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_stream.main(["--sessions", "1"])


EXAMPLES = ("quickstart", "anomaly_detection", "ecg_monitoring",
            "fleet_monitoring", "uncertainty_serving", "codesign_search")


def test_rules_cover_the_examples_and_the_train_launcher():
    """The import rule above walks every file of the package: the
    training launcher and the six examples among them."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    want = ["src/repro_torch/launch/train.py"] + [
        f"src/repro_torch/examples/{n}.py" for n in EXAMPLES]
    assert not [w for w in want if w not in names]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_and_train_launcher_raise_without_gpu(no_gpu, name):
    import importlib
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(f"repro_torch.examples.{name}").main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])


def _fleet_specs():
    from repro_torch.serve import TenantSpec
    cfg, params = _cpu_model()
    return [TenantSpec(name="a", cfg=cfg, params=params),
            TenantSpec(name="b", cfg=cfg, params=params, n_samples=1)]


def test_fleet_entry_points_raise_without_gpu(no_gpu, tmp_path):
    from repro_torch.serve import FleetEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetEngine(_fleet_specs())
    table = tmp_path / "fleet.json"
    table.write_text('{"tenants": [{"name": "a", "samples": 2}]}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_stream.main(["--tenants", str(table)])
    assert len(FleetEngine(_fleet_specs(), device="cpu").groups) == 1


def test_fleet_mesh_raises():
    """The fleet takes a mesh (sharding is ported); a mesh that is no
    ``launch.mesh.Mesh`` is refused, and on a mesh S joins the launch-group
    signature, as in the reference: tenants at S 2 and S 1 fold into one
    group without a mesh, two on one."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.serve import FleetEngine
    with pytest.raises(TypeError, match="Mesh"):
        FleetEngine(_fleet_specs(), device="cpu", mesh=object())
    fleet = FleetEngine(_fleet_specs(), mesh=make_data_mesh(2, device="cpu"))
    assert fleet.device == torch.device("cpu")
    assert len(fleet.groups) == 2
    assert {g.engine._shards for g in fleet.groups.values()} == {2}


def test_fleet_reconfigure_to_shards_raises():
    """``reconfigure_tenant`` to ``shards`` other than 1 builds the
    tenant's engine on a data mesh of that many entries (the CPU
    repeated); back at 1 it drops the mesh; a count below 1 raises and
    leaves the fleet as it was."""
    import types
    from repro_torch.serve import FleetEngine, ServingConfig
    fleet = FleetEngine(_fleet_specs(), device="cpu")
    groups = [list(g.tenants) for g in fleet.groups.values()]
    with pytest.raises(ValueError, match="shards"):
        fleet.reconfigure_tenant("a", types.SimpleNamespace(n_samples=2,
                                                            shards=0))
    assert [list(g.tenants) for g in fleet.groups.values()] == groups
    for new, shards in ((types.SimpleNamespace(n_samples=2, shards=4), 4),
                        (types.SimpleNamespace(n_samples=2, precision=None,
                                               chunk_capacity=0, shards=2),
                         2),
                        (ServingConfig(n_samples=2, shards=4), 4),
                        (ServingConfig(n_samples=2), 1)):
        eng = fleet.reconfigure_tenant("a", new)
        assert eng._shards == shards
        assert (eng.mesh is None) == (shards == 1)
        if shards > 1:
            assert eng.mesh.device_list == [torch.device("cpu")] * shards
        assert fleet.group_of("a").engine is eng
    # A config without ``shards`` keeps the tenant's engine's count.
    eng = fleet.reconfigure_tenant("b", ServingConfig(n_samples=1,
                                                      shards=2))
    assert fleet.reconfigure_tenant(
        "b", types.SimpleNamespace(n_samples=1))._shards == 2


def test_dse_and_predict_are_port_files():
    """``dse/`` and ``core/bayesian.py`` fall under the import rule above,
    and the GPU roofline states the H100's peaks, no TPU constant."""
    port = ROOT / "src" / "repro_torch"
    want = {port / "dse" / f"{name}.py" for name in (
        "__init__", "fpga_model", "search", "gpu_model", "calibrate")}
    want.add(port / "core" / "bayesian.py")
    assert want <= set(PORT_FILES)
    tree = ast.parse((port / "dse" / "gpu_model.py").read_text())
    numbers = {node.value for node in ast.walk(tree)
               if isinstance(node, ast.Constant)
               and isinstance(node.value, float)}
    # The reference's roofline (``repro.launch.analysis``): bf16 per chip,
    # HBM bytes/s, ICI bytes/s per link.
    assert not numbers & {197e12, 819e9, 50e9}
    from repro_torch.dse import gpu_model
    assert (gpu_model.PEAK_FLOPS, gpu_model.HBM_BW) == (67e12, 3.35e12)


def test_sharding_modules_are_port_files():
    """``launch/mesh.py`` and ``launch/rnn_shardings.py`` fall under the
    import rule above, and importing them touches no device."""
    port = ROOT / "src" / "repro_torch" / "launch"
    assert {port / "mesh.py", port / "rnn_shardings.py"} <= set(PORT_FILES)
    from repro_torch.launch import mesh, rnn_shardings
    assert mesh.Mesh(["cpu"] * 2).size == 2
    assert rnn_shardings.DEFAULT_POLICY.strategy == "auto"


def test_cpu_when_asked(no_gpu):
    cfg, params = _cpu_model()
    logits = clf.apply(params, torch.zeros((2, 3, 1)), torch.arange(2), cfg,
                       backend="cuda_seq", device="cpu")
    assert logits.shape == (2, 4) and torch.isfinite(logits).all()


def test_only_cpu_and_cuda_devices():
    cfg, params = _cpu_model()
    with pytest.raises(ValueError, match="unsupported device"):
        rnn.run_stack(params["encoder"], torch.zeros((2, 3, 1)),
                      rnn.stack_mask_plan(cfg.mcd, 3), 0.125,
                      backend="cuda_seq", rows=torch.arange(2),
                      device="meta")


@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"precision": "bf16"}, {"precision": "int8"},
    {"early_exit_threshold": 0.1}, {"student": object()}])
def test_engine_unported_options_raise(kw):
    cfg, params = _cpu_model()
    if "mesh" in kw:
        # Sharding is ported: the engine takes a launch.mesh.Mesh, refuses
        # a mesh that is none, and refuses beside a mesh what the
        # reference refuses (early exit, students).
        from repro_torch.launch.mesh import make_data_mesh
        with pytest.raises(TypeError, match="Mesh"):
            StreamingEngine(params, cfg, device="cpu", **kw)
        mesh = make_data_mesh(2, device="cpu")
        assert StreamingEngine(params, cfg, mesh=mesh)._shards == 2
        for bad in ({"early_exit_threshold": 0.1}, {"student": object()}):
            with pytest.raises(ValueError, match="incompatible with mesh"):
                StreamingEngine(params, cfg, mesh=mesh, **bad)
        return
    if "precision" in kw:
        # The serving precisions are ported: the engine takes them, and a
        # precision that is none of them is refused.
        assert StreamingEngine(params, cfg, device="cpu",
                               **kw).precision == kw["precision"]
        with pytest.raises(ValueError, match="precision"):
            StreamingEngine(params, cfg, device="cpu", precision="fp8")
        return
    if "early_exit_threshold" in kw:
        # Early exit is ported: the engine takes a threshold and refuses a
        # negative one, as the reference does.
        assert StreamingEngine(params, cfg, device="cpu",
                               **kw).early_exit_threshold == 0.1
        with pytest.raises(ValueError, match="threshold"):
            StreamingEngine(params, cfg, device="cpu",
                            early_exit_threshold=-1.0)
        return
    if "student" in kw:
        # Distilled students are ported: the engine takes heads, and
        # mode="student" without them is refused.
        assert StreamingEngine(params, cfg, device="cpu",
                               **kw).student is kw["student"]
        eng = StreamingEngine(params, cfg, device="cpu")
        with pytest.raises(ValueError, match="student"):
            eng.open_session("s", mode="student")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingEngine(params, cfg, device="cpu", **kw)


def test_engine_unported_calls_raise():
    cfg, params = _cpu_model()
    eng = StreamingEngine(params, cfg, device="cpu")
    # Student sessions are ported: without student= heads they are
    # refused as the reference refuses them.
    for call in (lambda: eng.open_session("s", mode="student"),
                 lambda: eng.admit("s", mode="student")):
        with pytest.raises(ValueError, match="student"):
            call()
    # snapshot / restore are ported: a directory with no snapshot is a
    # missing file, not an unported call.
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        eng.restore(str(ROOT / "build" / "no-such-snapshot"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingEngine(params, object(), device="cpu")
    # The GRU is ported, and its stack takes a mesh (sharding is ported):
    # a mesh that is no launch.mesh.Mesh is refused.
    gru = rnn.init_stack(torch.Generator(), 1, (8,), cell="gru",
                         device="cpu")
    plan = rnn.stack_mask_plan(cfg.mcd, 1)
    with pytest.raises(TypeError, match="Mesh"):
        rnn.run_stack(gru, torch.zeros((2, 3, 1)), plan, 0.125,
                      backend="cuda_seq", rows=torch.arange(2), cell="gru",
                      device="cpu", mesh=object())
    # ... and serves the precisions: h in the activation dtype.
    _, (h,) = rnn.run_stack(gru, torch.zeros((2, 3, 1)), plan, 0.125,
                            backend="cuda_seq", rows=torch.arange(2),
                            cell="gru", device="cpu", precision="bf16")
    assert h.dtype == torch.bfloat16


def test_cli_serves_on_cpu(tmp_path):
    out = tmp_path / "ticks.jsonl"
    agg = launch_stream.main(["--device", "cpu", "--sessions", "2",
                              "--samples", "2", "--beats", "1",
                              "--chunk-len", "70", "--ragged",
                              "--capacity", "auto",
                              "--metrics-out", str(out)])
    assert agg["ticks"] >= 2 and agg["launches"] == 0
    lines = out.read_text().splitlines()
    assert len(lines) == agg["ticks"]


@pytest.mark.parametrize("cell,backend", [("gru", "cuda_step"),
                                          ("gru", "reference"),
                                          ("lstm", "cuda_step")])
def test_cli_cell_and_backend_flags(cell, backend):
    agg = launch_stream.main(["--device", "cpu", "--sessions", "2",
                              "--samples", "2", "--beats", "1",
                              "--chunk-len", "70", "--cell", cell,
                              "--backend", backend])
    assert agg["ticks"] == 2 and agg["launches"] == 0
    with pytest.raises(SystemExit):
        launch_stream.main(["--device", "cpu", "--backend", "pallas_seq"])


def test_evicted_session_reattaches_with_its_draw():
    cfg, params = _cpu_model()
    eng = StreamingEngine(params, cfg, max_sessions=1, device="cpu")
    eng.open_session("a")
    eng.step({"a": np.ones((3, 1), np.float32)})
    sess = eng.close_session("a")
    assert eng.admit("b") is not None
    assert eng.admit("a", session=sess) is None        # waits for a row
    assert eng.queued_sessions == ["a"]
    eng.close_session("b")                             # frees it: a resumes
    assert eng.active_sessions == ["a"]
    assert eng.store.get("a") is sess and sess.steps == 3
    assert np.array_equal(sess.rows, [0, 1])
    assert eng.store.next_row == 4


def test_init_is_seeded():
    cfg = clf.ClassifierConfig()
    a = clf.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = clf.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for la, lb in zip(a["encoder"], b["encoder"]):
        assert all(torch.equal(u, v) for u, v in zip(la, lb))
        assert np.array_equal(la.b[1].numpy(), np.ones(cfg.hidden))


def test_library_name_tracks_sources_and_shared_headers(tmp_path,
                                                        monkeypatch):
    """An edited .cu or shared .cuh names a new library: no stale load."""
    (tmp_path / "k.cu").write_text('#include "m.cuh"\n')
    (tmp_path / "m.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "m.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "m.cuh"\n// edit\n')
    assert build.library_path("k") not in (first, second)
    real = pathlib.Path(build.__file__).parent / "csrc"
    assert {p.stem for p in real.glob("*.cu")} == {
        "mcd_lstm_seq", "mcd_gru_seq", "mcd_lstm_step", "mcd_gru_step",
        "masked_activation", "mcd_matmul", "decode_attn", "ssd_chunk"}
