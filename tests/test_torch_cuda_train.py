"""Training on the card: one launcher step of each ECG task on the GPU
against the same step on the CPU, and the kernels' grad guard on CUDA
tensors.

Marked ``cuda``: each test skips (in a fixture, at run time) where there
is no GPU; run them on a GPU machine with
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda_train.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import tree_leaves  # noqa: E402
from repro_torch.kernels import mcd_lstm, mcd_lstm_seq, ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

pytestmark = pytest.mark.cuda

LOSS_TOL = 1e-5    # the loss of one step, card vs CPU
PARAM_TOL = 1e-4   # params after one AdamW step (lr 1e-3): a tenth of the
                   # update; the devices' exp / tanh and sum orders differ
                   # in the last bits


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _one_step(task, device, batch):
    args = train.parser().parse_args(["--task", task, "--batch", "16"])
    loss, params, batches, tcfg, _ = train.setup(args, device)
    b = next(batches) if batch is None else batch
    tr = trainer.Trainer(loss, params, tcfg)
    (h,) = tr.run([tuple(torch.as_tensor(a, device=device) for a in b)], 1)
    return b, h["loss"], [p.detach().cpu() for p in tree_leaves(tr.params)]


@pytest.mark.parametrize("task", ["ecg-clf", "ecg-ae"])
def test_one_training_step_card_vs_cpu(dev, task):
    b, loss_card, card = _one_step(task, dev, None)
    _, loss_cpu, cpu = _one_step(task, torch.device("cpu"), b)
    assert abs(loss_card - loss_cpu) <= LOSS_TOL
    for a, c in zip(card, cpu, strict=True):
        assert (a - c).abs().max().item() <= PARAM_TOL


def test_grad_guard_on_cuda_tensors(dev):
    """A CUDA operand that requires grad is refused before any launch."""
    B, T, I, H = 3, 4, 1, 8
    x = torch.randn((B, T, I), device=dev, requires_grad=True)
    wx = torch.randn((I, 4, H), device=dev)
    wh = torch.randn((H, 4, H), device=dev)
    b = torch.zeros((4, H), device=dev)
    rows = torch.arange(B, device=dev)
    before = mcd_lstm_seq.mcd_lstm_seq.launches
    with pytest.raises(RuntimeError, match="no kernel has a backward"):
        mcd_lstm_seq.mcd_lstm_seq(x, wx, wh, b, rows,
                                  mcd_lstm.gate_keys(0, 0), 0.125)
    with pytest.raises(RuntimeError, match="no kernel has a backward"):
        ops.mcd_dense(torch.randn((4, 8), device=dev), torch.randn(
            (8, 5), device=dev, requires_grad=True), rows[:1].repeat(4),
            0, 1, 2, 0.1)
    assert mcd_lstm_seq.mcd_lstm_seq.launches == before
    with torch.no_grad():
        mcd_lstm_seq.mcd_lstm_seq(x, wx, wh, b, rows,
                                  mcd_lstm.gate_keys(0, 0), 0.125)
    assert mcd_lstm_seq.mcd_lstm_seq.launches == before + 1
