"""LM checkpoints in the reference's layout: a checkpoint of the JAX
launcher (``repro.launch.train --task lm``) resumes in the port's, and the
reverse, for qwen3-1.7b and jamba-1.5-large-398b REDUCED.

The reference keeps a stage's repeats stacked (``params["stages"][i][j]``,
every leaf ``[repeat, ...]``); the port keeps one block dict a repeat.
The port's launcher writes the reference's leaves (``Trainer(...,
layout=(backbone.stack_repeats, backbone.unstack_repeats))``) and unstacks
them at restore.  Each test trains 2 steps in one launcher and resumes in
the other; the manifests' leaf names, dtypes and shapes are equal, and a
JAX checkpoint restored by the port and saved again is the same bytes
(every leaf's sha256).  The ECG checkpoints cross in
``test_torch_train_launch.py``.
"""

import json
import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.ckpt.checkpoint import tree_leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import backbone  # noqa: E402
from repro_torch.models.config import Stage  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

ARCHS = ("qwen3-1.7b", "jamba-1.5-large-398b")


def _argv(arch):
    return ["--task", "lm", "--arch", arch, "--batch", "2", "--seq", "9"]


def _jax_train(argv, monkeypatch):
    jtrain = pytest.importorskip("repro.launch.train")
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jtrain.main()


def _manifest(directory, step):
    with open(os.path.join(directory, f"step-{step:010d}",
                           "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["leaves"]}


def _layout(m):
    return {k: (e["dtype"], tuple(e["shape"])) for k, e in m.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_checkpoints_cross_the_launchers(arch, tmp_path, monkeypatch,
                                            capsys):
    """JAX step 2 -> the port trains step 3; the port's step 2 -> the JAX
    launcher ends at step 3.  Both step-2 checkpoints hold the same
    leaves; the port re-saves JAX's byte for byte."""
    argv = _argv(arch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_train([*argv, "--steps", "2", "--ckpt-dir", jdir], monkeypatch)
    jax_m = _manifest(jdir, 2)

    again = str(tmp_path / "again")
    shutil.copytree(jdir, again)
    out = ttrain.main([*argv, "--device", "cpu", "--steps", "2",
                       "--ckpt-dir", again])
    assert out["history"] == [] and out["trainer"].step == 2
    assert {k: e["sha256"] for k, e in _manifest(again, 2).items()} == \
        {k: e["sha256"] for k, e in jax_m.items()}

    out = ttrain.main([*argv, "--device", "cpu", "--steps", "3",
                       "--ckpt-dir", jdir])
    assert len(out["history"]) == 1 and out["trainer"].step == 3
    assert np.isfinite(out["history"][0]["loss"])

    ttrain.main([*argv, "--device", "cpu", "--steps", "2", "--ckpt-dir",
                 tdir])
    assert _layout(_manifest(tdir, 2)) == _layout(jax_m)
    capsys.readouterr()
    _jax_train([*argv, "--steps", "3", "--ckpt-dir", tdir], monkeypatch)
    assert "after 3 steps" in capsys.readouterr().out
    assert checkpoint.latest_step(tdir) == 3


def test_stack_repeats_round_trips_on_the_host():
    """``stack_repeats`` writes each leaf [repeat, ...] on the host and
    ``unstack_repeats`` gives the port's tree back bit for bit, AdamW's
    moments too; a checkpoint of it restores in place."""
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    cfg = cfg.replace(stages=(Stage(cfg.stages[0].pattern[:3], 3),))
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    st = backbone.stack_repeats(params)
    assert st["stages"][0][1]["mixer"].in_proj.shape[0] == 3
    back = backbone.unstack_repeats(st)
    for a, b in zip(tree_leaves(back), tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    opt = optimizer.init(params)
    assert len(tree_leaves(backbone.stack_repeats(opt.m))) == \
        len(tree_leaves(st))


def test_the_lm_launcher_kills_and_resumes_bit_equal(tmp_path):
    """2 steps, then a relaunch to 4 from the stacked checkpoint, equal
    bit for bit to 4 uninterrupted steps (jamba REDUCED)."""
    argv = [*_argv("jamba-1.5-large-398b"), "--device", "cpu"]
    gold = ttrain.main([*argv, "--steps", "4"])["trainer"]
    ck = str(tmp_path / "ck")
    ttrain.main([*argv, "--steps", "2", "--ckpt-dir", ck])
    tr = ttrain.main([*argv, "--steps", "4", "--ckpt-dir", ck])["trainer"]
    assert tr.step == 4
    for a, b in zip(tree_leaves((tr.params, tr.opt_state)),
                    tree_leaves((gold.params, gold.opt_state)),
                    strict=True):
        assert torch.equal(a, b)
