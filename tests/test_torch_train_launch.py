"""The port's drivers on the CPU: the training launcher
(``repro_torch.launch.train``), the kernel entry points' grad guard, the
stream launcher's admission flags and the examples
(``repro_torch.examples``).

* ``launch.train.main`` with ``--device cpu``, 2 steps of each task.
* ``--ckpt-dir`` kill -> resume: a run that dies mid-step after its step-4
  checkpoint, relaunched, ends bit-equal to an uninterrupted run.
* A JAX launcher checkpoint resumes in the port's launcher, and a port
  checkpoint in JAX's.
* Every kernel entry point (the ``ops`` functions and the wrappers they
  call) raises when grad mode is on and an operand requires grad, and runs
  under ``torch.no_grad()``; no training task reaches a kernel.
* ``launch.stream --overload / --max-pending``: the same admissions, the
  same streams a tick and the same refusal as the JAX launcher on the
  ``reference`` backend.
* Each example's ``main`` at smoke size returns.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves  # noqa: E402
from repro_torch.kernels import (bernoulli_mask, common, decode_attn,  # noqa: E402
                                 mcd_gru, mcd_gru_seq, mcd_lstm,
                                 mcd_lstm_seq, mcd_matmul, ops, ssd_chunk)
from repro_torch.launch import stream as tstream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

CPU = ["--device", "cpu"]


def _train(argv):
    return ttrain.main([*argv, *CPU])


@pytest.mark.parametrize("argv", [
    ["--task", "ecg-clf"], ["--task", "ecg-ae"],
    ["--task", "lm", "--arch", "qwen3-1.7b"],
    ["--task", "lm", "--arch", "mamba2-370m"]],
    ids=["ecg-clf", "ecg-ae", "lm-qwen3", "lm-mamba2"])
def test_train_main_two_steps(argv, capsys):
    out = _train([*argv, "--steps", "2", "--batch", "8", "--seq", "9"])
    hist = out["history"]
    assert len(hist) == 2 and out["trainer"].step == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in capsys.readouterr().out
    for p in tree_leaves(out["trainer"].params):
        assert p.device.type == "cpu" and not p.requires_grad


def test_lm_stream_is_the_reference_at_odd_seq():
    """At an odd --seq (where the reference's assignment broadcasts) the
    token stream is the reference's expression, byte for byte; at an even
    one the port fills the same columns the reference would have."""
    cfg = ttrain.get_config("qwen3-1.7b", reduced=True)
    for seq in (9, 8):
        got = next(ttrain.lm_batches(cfg, 3, seq, 7))
        rng = np.random.default_rng(7)
        t = rng.integers(0, cfg.vocab_size, (3, seq + 1), dtype=np.int32)
        n = t[:, 1::2].shape[1]
        t[:, 1::2] = (t[:, 0::2][:, :n] + 1) % cfg.vocab_size
        assert np.array_equal(got[0], t[:, :-1])
        assert np.array_equal(got[1], t[:, 1:])


class _Crash(Exception):
    pass


def _crash_after(batches, n):
    for i, b in enumerate(batches):
        if i == n:
            raise _Crash(f"killed fetching batch {i}")
        yield b


def test_kill_resume_is_bit_equal(tmp_path, monkeypatch):
    """ckpt_every 2; the first run dies fetching its 6th batch (mid step
    5), after the step-4 checkpoint.  The same command relaunched resumes
    at step 4, skips the 4 batches those steps took, and ends at step 8
    bit-equal to a run never interrupted."""
    setup = ttrain.setup
    crash = {"at": 5}

    def setup_every_2(args, device):
        loss, params, batches, tcfg, cfg = setup(args, device)
        if crash["at"] is not None:
            batches = _crash_after(batches, crash["at"])
        return (loss, params, batches,
                dataclasses.replace(tcfg, ckpt_every=2), cfg)

    argv = ["--task", "ecg-clf", "--steps", "8", "--batch", "8"]
    gold = _train(argv)["trainer"]
    monkeypatch.setattr(ttrain, "setup", setup_every_2)
    ck = str(tmp_path / "ck")
    with pytest.raises(_Crash):
        _train([*argv, "--ckpt-dir", ck])
    assert checkpoint.latest_step(ck) == 4
    crash["at"] = None
    out = _train([*argv, "--ckpt-dir", ck])
    assert len(out["history"]) == 4 and out["trainer"].step == 8
    for a, b in zip(tree_leaves(out["trainer"].params),
                    tree_leaves(gold.params), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(out["trainer"].opt_state),
                    tree_leaves(gold.opt_state), strict=True):
        assert torch.equal(a, b)


def _jax_train(argv, monkeypatch):
    jtrain = pytest.importorskip("repro.launch.train")
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jtrain.main()


def test_checkpoints_cross_the_launchers(tmp_path, monkeypatch, capsys):
    """A JAX launcher checkpoint (step 2) resumes in the port's launcher,
    which trains one more step; a port checkpoint (step 2) resumes in the
    JAX launcher, which ends at step 3."""
    argv = ["--task", "ecg-clf", "--batch", "8"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_train([*argv, "--steps", "2", "--ckpt-dir", jdir], monkeypatch)
    out = _train([*argv, "--steps", "3", "--ckpt-dir", jdir])
    assert len(out["history"]) == 1 and out["trainer"].step == 3
    assert checkpoint.latest_step(jdir) == 3
    _train([*argv, "--steps", "2", "--ckpt-dir", tdir])
    capsys.readouterr()
    _jax_train([*argv, "--steps", "3", "--ckpt-dir", tdir], monkeypatch)
    assert "after 3 steps" in capsys.readouterr().out


# -- the grad guard ----------------------------------------------------------

def _r(g, *shape, k=0.3):
    return torch.randn(shape, generator=g) * k


def _entry_points():
    """(name, call(requires_grad_tensor_factory)) for every kernel entry
    point, at small shapes; ``mk`` makes the float operands."""
    g = torch.Generator().manual_seed(0)
    B, T, I, H = 3, 4, 2, 8
    rows = torch.arange(B, dtype=torch.int64)
    lk, gk = mcd_lstm.gate_keys(0, 0), mcd_gru.gate_keys(0, 0)

    def rec(gates, mk):
        return dict(x=mk(B, T, I), wx=mk(I, gates, H), wh=mk(H, gates, H),
                    b=mk(gates, H))

    def core(gates, mk):
        return dict(wx=mk(gates, I, H), wh=mk(gates, H, H), b=mk(gates, H),
                    x=mk(B, T, I))

    def seq_lstm(mk):
        d = rec(4, mk)
        return mcd_lstm_seq.mcd_lstm_seq(d["x"], d["wx"], d["wh"], d["b"],
                                         rows, lk, 0.125)

    def seq_gru(mk):
        d = rec(3, mk)
        return mcd_gru_seq.mcd_gru_seq(d["x"], d["wx"], d["wh"], d["b"],
                                       rows, gk, 0.125)

    def step_lstm(mk):
        d = rec(4, mk)
        return mcd_lstm.mcd_lstm_step(d["x"][:, 0], mk(B, H), mk(B, H),
                                      d["wx"], d["wh"], d["b"], rows, lk,
                                      0.125)

    def step_gru(mk):
        d = rec(3, mk)
        return mcd_gru.mcd_gru_step(d["x"][:, 0], mk(B, H), d["wx"],
                                    d["wh"], d["b"], rows, gk, 0.125)

    def stack(cell, seq):
        def call(mk):
            d = core(4 if cell == "lstm" else 3, mk)
            fn = ops.lstm_stack_layer if cell == "lstm" else \
                ops.gru_stack_layer
            return fn(d["wx"], d["wh"], d["b"], d["x"], rows, 0, 0, 0.125,
                      seq=seq)
        return call

    def fused(cell, seq):
        def call(mk):
            d = rec(4 if cell == "lstm" else 3, mk)
            fn = {("lstm", True): ops.fused_lstm_seq,
                  ("lstm", False): ops.fused_lstm_layer,
                  ("gru", True): ops.fused_gru_seq,
                  ("gru", False): ops.fused_gru_layer}[cell, seq]
            return fn(d["wx"], d["wh"], d["b"], d["x"], rows, 0, 0, 0.125)
        return call

    def attn(mk, wrapper):
        fn = decode_attn.decode_attention if wrapper else \
            ops.flash_decode_attention
        return fn(mk(2, 4, 8), mk(2, 6, 2, 8), mk(2, 6, 2, 8), 3)

    def ssd(mk, wrapper):
        Bb, L, Hh, P, N = 1, 8, 2, 4, 4
        args = (mk(Bb, L, Hh, P), torch.rand((Bb, L, Hh), generator=g),
                -torch.rand((Hh,), generator=g), mk(Bb, L, 1, N),
                mk(Bb, L, 1, N), mk(Hh))
        if wrapper:
            x, dt, a, bm, cm, d = args
            return ssd_chunk.ssd_chunk_scan(x, dt, a, bm[:, :, 0],
                                            cm[:, :, 0], d, q_chunk=4)
        return ops.ssd_scan(*args, chunk=4)

    return {
        "mcd_lstm_seq": seq_lstm, "mcd_gru_seq": seq_gru,
        "mcd_lstm_step": step_lstm, "mcd_gru_step": step_gru,
        "masked_activation": lambda mk: bernoulli_mask.masked_activation(
            mk(B, 16), rows, 7, 0.1),
        "mcd_matmul": lambda mk: mcd_matmul.mcd_matmul(
            mk(B, 16), mk(16, 5), rows, 7, 0.1),
        "decode_attention": lambda mk: attn(mk, True),
        "ssd_chunk_scan": lambda mk: ssd(mk, True),
        "ops.flash_decode_attention": lambda mk: attn(mk, False),
        "ops.mcd_dense": lambda mk: ops.mcd_dense(mk(B, 16), mk(16, 5),
                                                  rows, 0, 1, 2, 0.1),
        "ops.mcd_mask_apply": lambda mk: ops.mcd_mask_apply(
            mk(B, 16), rows, 0, 1, 2, 0.1),
        "ops.ssd_scan": lambda mk: ssd(mk, False),
        "ops.fused_lstm_seq": fused("lstm", True),
        "ops.fused_lstm_layer": fused("lstm", False),
        "ops.fused_gru_seq": fused("gru", True),
        "ops.fused_gru_layer": fused("gru", False),
        "ops.lstm_stack_layer[seq]": stack("lstm", True),
        "ops.lstm_stack_layer[step]": stack("lstm", False),
        "ops.gru_stack_layer[seq]": stack("gru", True),
        "ops.gru_stack_layer[step]": stack("gru", False),
    }


ENTRY_POINTS = sorted(_entry_points())


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_kernel_entry_refuses_grad(name):
    """One operand requiring grad (the first float one made) raises under
    grad mode, before any work; the same call runs under no_grad."""
    call = _entry_points()[name]
    g = torch.Generator().manual_seed(1)
    made = []

    def mk(*shape):
        t = _r(g, *shape)
        if not made:
            t.requires_grad_(True)
        made.append(t)
        return t

    with pytest.raises(RuntimeError, match="no kernel has a backward"):
        call(mk)
    made.clear()
    with torch.no_grad():
        call(mk)


def test_training_reaches_no_kernel(monkeypatch):
    """One step of each task with every kernel wrapper made to fail: the
    training paths run the plain ``reference`` path only."""
    def no_kernel(name, t):
        raise AssertionError(f"training reached the kernel wrapper {name}")

    monkeypatch.setattr(common, "check_device", no_kernel)
    for argv in (["--task", "ecg-clf"], ["--task", "ecg-ae"],
                 ["--task", "lm", "--arch", "qwen3-1.7b"],
                 ["--task", "lm", "--arch", "mamba2-370m"]):
        _train([*argv, "--steps", "1", "--batch", "4", "--seq", "9"])


# -- launch/stream.py --overload / --max-pending ------------------------------

STREAM = ["--sessions", "2", "--samples", "2", "--beats", "1",
          "--chunk-len", "70", "--backend", "reference"]


def _ticks(out):
    admits = re.findall(r"^admit (ecg-\d+): (live|queued)$", out, re.M)
    ticks = [re.findall(r"(ecg-\d+)@\s*(\d+)", line)
             for line in out.splitlines() if line.startswith("tick ")]
    return admits, ticks


def test_overload_admissions_match_jax(monkeypatch, capsys):
    jstream = pytest.importorskip("repro.launch.stream")
    argv = [*STREAM, "--overload", "5"]
    tstream.main([*argv, "--device", "cpu"])
    got = _ticks(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["stream", *argv])
    jstream.main()
    want = _ticks(capsys.readouterr().out)
    assert got == want
    assert got[0] == [(f"ecg-{k}", "live" if k < 2 else "queued")
                      for k in range(5)]
    assert len(got[1]) == 6 and {s for t in got[1] for s, _ in t} == {
        f"ecg-{k}" for k in range(5)}


def test_max_pending_refuses_as_jax(monkeypatch):
    jstream = pytest.importorskip("repro.launch.stream")
    argv = [*STREAM, "--sessions", "1", "--overload", "4",
            "--max-pending", "2"]
    with pytest.raises(Exception) as port_err:
        tstream.main([*argv, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["stream", *argv])
    with pytest.raises(Exception) as jax_err:
        jstream.main()
    assert type(port_err.value).__name__ == "QueueFull"
    assert type(jax_err.value).__name__ == "QueueFull"
    assert str(port_err.value) == str(jax_err.value)


# -- the examples --------------------------------------------------------------

def _example(name):
    import importlib
    return importlib.import_module(f"repro_torch.examples.{name}")


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("codesign_search", []),
    ("anomaly_detection", ["--steps", "2", "--test-beats", "64"]),
    ("ecg_monitoring", ["--smoke"]),
    ("ecg_monitoring", ["--smoke", "--kill-resume", "--early-exit",
                        "--controller"]),
    ("ecg_monitoring", ["--smoke", "--cell", "gru", "--precision", "int8",
                        "--backend", "pallas_step"]),
    ("fleet_monitoring", ["--smoke"]),
    ("uncertainty_serving", ["--new-tokens", "3", "--arch", "qwen3-1.7b"]),
    ("uncertainty_serving", ["--new-tokens", "3", "--arch", "mamba2-370m"]),
], ids=["quickstart", "codesign_search", "anomaly_detection",
        "ecg_monitoring-smoke", "ecg_monitoring-modes",
        "ecg_monitoring-gru-int8-step", "fleet_monitoring",
        "uncertainty_serving-qwen3", "uncertainty_serving-mamba2"])
def test_example_runs(name, argv, tmp_path, capsys):
    if name == "anomaly_detection":
        argv = [*argv, "--ckpt-dir", str(tmp_path / "ck")]
    assert _example(name).main([*argv, *CPU]) is not None
    assert capsys.readouterr().out


def test_uncertainty_serving_olmoe_waits_for_a9():
    """Neither olmoe-1b-7b nor jamba waits any longer: the MoE FFN is
    ported and olmoe is the example's default again, as in the reference;
    jamba's hybrid blocks are ported and serve too."""
    res = _example("uncertainty_serving").main(["--new-tokens", "2", *CPU])
    assert res.tokens.shape == (2, 2)
    res = _example("uncertainty_serving").main(
        ["--arch", "jamba-1.5-large-398b", "--new-tokens", "2", *CPU])
    assert res.tokens.shape == (2, 2)
    assert torch.isfinite(res.mutual_information).all()

