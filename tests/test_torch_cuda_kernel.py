"""The CUDA kernels (``mcd_lstm_seq``, ``mcd_gru_seq``, ``mcd_lstm_step``,
``mcd_gru_step``, the LM's ``masked_activation``, ``mcd_matmul``,
``decode_attention``, and the Mamba2 scan ``ssd_chunk_scan``) against their
plain PyTorch versions, on the card.
Marked ``cuda``: each test skips (in a fixture, at run time) where there
is no GPU; run them on a GPU machine with
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernel.py`` (``--noconftest``: the suite's conftest
releases JAX caches, and a GPU machine need not have JAX).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import autoencoder as ae  # noqa: E402
from repro_torch.core import classifier as clf, mcd, rnn  # noqa: E402
from repro_torch.kernels import common, mcd_gru  # noqa: E402
from repro_torch.kernels import mcd_gru_seq as gseq  # noqa: E402
from repro_torch.kernels import mcd_lstm, mcd_lstm_seq as seq  # noqa: E402
from repro_torch.serve import StreamingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import bernoulli_mask, decode_attn  # noqa: E402
from repro_torch.kernels import mcd_matmul as mm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import backbone, layers  # noqa: E402
from repro_torch.serve.engine import BayesianEngine  # noqa: E402

pytestmark = pytest.mark.cuda

ATOL = 1e-5     # fp32 gate; the recurrent kernels round every product and
                # sum alone, in the plain versions' order, and are
                # bit-equal to them where a test asserts torch.equal


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, B, T, I, H, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return (torch.randn(shape, generator=g) * k).to(dev)

    rows = torch.arange(B, dtype=torch.int64) * 3 + 5
    rows[::7] |= mcd.STUDENT_ROW_FLAG
    lens = torch.randint(1, T + 1, (B,), generator=g).to(torch.int32)
    return dict(x=r(B, T, I), wx=r(I, 4, H, k=0.4), wh=r(H, 4, H, k=0.4),
                b=r(4, H, k=0.1), rows=rows.to(dev), h0=r(B, H, k=0.5),
                c0=r(B, H, k=0.5), lengths=lens.to(dev))


@pytest.mark.parametrize("B,T,I,H,path", [
    (33, 17, 1, 8, "warp"), (20, 9, 8, 8, "warp"), (67, 140, 1, 8, "warp"),
    (67, 140, 8, 8, "warp"), (67, 140, 1, 16, "warp"),
    (67, 140, 16, 8, "warp"), (67, 140, 8, 16, "warp"),
    (67, 140, 16, 16, "warp"), (37, 11, 40, 32, "warp"),
    (5, 6, 40, 24, "block"), (7, 4, 128, 128, "block")])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_kernel_matches_plain(dev, B, T, I, H, path, p):
    """Both paths bit-equal to the plain version at the classifier's and
    the autoencoder's widths (and a generic-I warp layer, H = 24 and 128 on
    the block path): B not a multiple of the rows a warp, ragged lengths,
    student rows, non-zero h0 and c0."""
    assert seq.lstm_seq_plan(B, I, H)["path"] == path
    d = _layer(dev, B, T, I, H)
    keys = mcd_lstm.gate_keys(3, 1)
    args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
    kw = dict(h0=d["h0"], c0=d["c0"], lengths=d["lengths"])
    before = seq.mcd_lstm_seq.launches
    got = seq.mcd_lstm_seq(*args, **kw)
    torch.cuda.synchronize()
    assert seq.mcd_lstm_seq.launches == before + 1
    ref = seq.mcd_lstm_seq_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and torch.isfinite(g).all()
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("I,H", [(1, 8), (8, 8), (1, 16), (16, 8),
                                 (128, 128)])
def test_kernel_mask_bits_equal(dev, cell, I, H):
    rows = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31 + 3, 2 ** 30 + 5, 77],
                        device=dev)
    keys = (mcd_lstm if cell == "lstm" else mcd_gru).gate_keys(9, 2)
    kx, kh = common.kernel_mask_factors(keys, rows, I, H, 0.125)
    px, ph = common.gate_mask_factors(keys, rows, I, H, 0.125)
    assert torch.equal(kx, px) and torch.equal(kh, ph)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    d = _layer(dev, 4, 3, 2, 8)
    keys = mcd_lstm.gate_keys(0, 0)
    with pytest.raises(TypeError):
        seq.mcd_lstm_seq(d["x"].double(), d["wx"], d["wh"], d["b"],
                         d["rows"], keys, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        seq.mcd_lstm_seq(d["x"].transpose(0, 1).contiguous().transpose(0, 1),
                         d["wx"], d["wh"], d["b"], d["rows"], keys, 0.1)
    with pytest.raises(ValueError, match="shape"):
        seq.mcd_lstm_seq(d["x"], d["wx"][:1], d["wh"], d["b"], d["rows"],
                         keys, 0.1)


def test_engine_serves_through_the_kernel(dev):
    cfg = clf.ClassifierConfig(mcd=mcd.MCDConfig(placement="YNY",
                                                 n_samples=4, seed=2))
    params = clf.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    sig = {f"s{k}": rng.standard_normal((24, 1)).astype(np.float32)
           for k in range(3)}
    eng = StreamingEngine(params, cfg, chunk_capacity=8, max_sessions=3,
                          device=dev)
    for sid in sig:
        eng.open_session(sid)
    while any(eng.store.get(s).steps < 24 for s in sig):
        chunks = {}
        for sid in sig:
            pos = eng.store.get(sid).steps
            if pos < 24:
                chunks[sid] = sig[sid][pos:pos + int(rng.integers(1, 9))]
        eng.step(chunks)
        assert eng.last_metrics.launches == cfg.num_layers
    x = torch.from_numpy(np.concatenate([np.repeat(sig[s][None], 4, 0)
                                         for s in sig])).to(dev)
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(s).rows for s in sig]).astype(np.int64)).to(dev)
    _, states = clf.apply(params, x, rows, cfg, backend="cuda_seq",
                          lengths=torch.full((12,), 24, device=dev),
                          return_state=True, device=dev)
    for li, (h, c) in enumerate(states):
        for k, sid in enumerate(sig):
            sh, sc = eng.store.get(sid).state[li]
            assert torch.equal(sh, h[4 * k:4 * k + 4])
            assert torch.equal(sc, c[4 * k:4 * k + 4])


# -- the GRU sequence kernel and the two step kernels ----------------------

def _gru_layer(dev, B, T, I, H, seed=0):
    d = _layer(dev, B, T, I, H, seed)
    g = torch.Generator().manual_seed(seed + 100)
    return dict(d, wx=(torch.randn((I, 3, H), generator=g) * 0.4).to(dev),
                wh=(torch.randn((H, 3, H), generator=g) * 0.4).to(dev),
                b=(torch.randn((3, H), generator=g) * 0.1).to(dev))


@pytest.mark.parametrize("B,T,I,H,path", [
    (33, 17, 1, 16, "warp"), (20, 9, 16, 8, "warp"), (21, 9, 1, 8, "warp"),
    (37, 11, 16, 32, "warp"), (9, 5, 40, 32, "warp"), (33, 7, 8, 16, "warp"),
    (5, 6, 40, 24, "block"), (7, 4, 128, 128, "block")])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_gru_seq_kernel_matches_plain(dev, B, T, I, H, path, p):
    """Both paths bit-equal to the plain version: every product and sum of
    the cell is rounded alone, in the plain version's order
    (csrc/mcd_cells.cuh); B not a multiple of the rows a warp or block,
    ragged lengths, student rows, a non-zero h0."""
    assert gseq.gru_seq_plan(B, I, H)["path"] == path
    d = _gru_layer(dev, B, T, I, H)
    keys = mcd_gru.gate_keys(3, 1)
    args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
    kw = dict(h0=d["h0"], lengths=d["lengths"])
    before = gseq.mcd_gru_seq.launches
    got = gseq.mcd_gru_seq(*args, **kw)
    torch.cuda.synchronize()
    assert gseq.mcd_gru_seq.launches == before + 1
    ref = gseq.mcd_gru_seq_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert g.is_cuda and torch.isfinite(g).all()
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,I,H", [(33, 1, 16), (20, 16, 8), (5, 40, 24)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_step_kernel_matches_plain(dev, cell, B, I, H, p):
    if cell == "lstm":
        d = _layer(dev, B, 1, I, H)
        mod, step, plain = mcd_lstm, mcd_lstm.mcd_lstm_step, \
            mcd_lstm.mcd_lstm_step_plain
        args = (d["x"][:, 0].contiguous(), d["h0"], d["c0"], d["wx"],
                d["wh"], d["b"], d["rows"], mod.gate_keys(3, 1), p)
    else:
        d = _gru_layer(dev, B, 1, I, H)
        mod, step, plain = mcd_gru, mcd_gru.mcd_gru_step, \
            mcd_gru.mcd_gru_step_plain
        args = (d["x"][:, 0].contiguous(), d["h0"], d["wx"], d["wh"],
                d["b"], d["rows"], mod.gate_keys(3, 1), p)
    before = step.launches
    got = step(*args)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    ref = plain(*args)
    got, ref = (got, ref) if cell == "lstm" else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert g.is_cuda and torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= ATOL


def _step_args(dev, cell, B, I, H, p, seed=0):
    """A step wrapper, its plain version, its arguments and its gate
    count."""
    if cell == "lstm":
        d = _layer(dev, B, 1, I, H, seed=seed)
        return (mcd_lstm.mcd_lstm_step, mcd_lstm.mcd_lstm_step_plain,
                (d["x"][:, 0].contiguous(), d["h0"], d["c0"], d["wx"],
                 d["wh"], d["b"], d["rows"], mcd_lstm.gate_keys(3, 1), p), 4)
    d = _gru_layer(dev, B, 1, I, H, seed=seed)
    return (mcd_gru.mcd_gru_step, mcd_gru.mcd_gru_step_plain,
            (d["x"][:, 0].contiguous(), d["h0"], d["wx"], d["wh"], d["b"],
             d["rows"], mcd_gru.gate_keys(3, 1), p), 3)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("I,H", [(1, 8), (8, 8), (1, 16), (16, 8), (8, 16),
                                 (16, 16), (40, 32), (3, 4), (70, 2)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_step_warp_path_bit_equal(dev, cell, I, H, p):
    """The step kernel's warp path (H divides 32) at B = 33, rows that do
    not fill the last warp, every 7th a student row: bit-equal to its plain
    version, one launch."""
    B = 33
    step, plain, args, gates = _step_args(dev, cell, B, I, H, p, seed=I + H)
    assert common.step_plan(gates, B, I, H)["path"] == "warp"
    before = step.launches
    got = step(*args)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    for g, r in zip(_outs(got), _outs(plain(*args)), strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,I,H", [(5, 40, 24), (3, 128, 128)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_step_block_path_bit_equal(dev, cell, B, I, H, p):
    step, plain, args, gates = _step_args(dev, cell, B, I, H, p)
    assert common.step_plan(gates, B, I, H)["path"] == "block"
    got = step(*args)
    torch.cuda.synchronize()
    for g, r in zip(_outs(got), _outs(plain(*args)), strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_step_takes_host_key_tuples(dev, cell):
    """The keys as a tuple of host ints (as the step backend passes them;
    their launch argument is built once, common.keys_arg) launch the same
    bits as the tensor keys."""
    step, _, args, _ = _step_args(dev, cell, 40, 8, 16, 0.125)
    host = tuple(args[-2].reshape(-1).tolist())
    got = step(*args[:-2], host, args[-1])
    want = step(*args)
    for g, r in zip(_outs(got), _outs(want), strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_step_backend_agrees_with_seq_backend(dev, cell):
    """Bitwise: the step and sequence kernels (the GRU's on its warp path
    at H = 16 and 8) run the one cell body of csrc/mcd_cells.cuh."""
    hiddens = (16, 8)
    params = rnn.init_stack(torch.Generator().manual_seed(1), 1, hiddens,
                            cell=cell, device=dev)
    cfg = mcd.MCDConfig(p=0.125, placement="YN", seed=4)
    d = _layer(dev, 40, 12, 1, 16)
    outs = {}
    for backend in ("cuda_step", "cuda_seq"):
        outs[backend] = rnn.run_stack(
            params, d["x"], rnn.stack_mask_plan(cfg, 2), cfg.p,
            backend=backend, rows=d["rows"], seed=cfg.seed,
            lengths=d["lengths"], return_all_states=True, cell=cell,
            device=dev)
    (ys, st), (yq, sq) = outs["cuda_step"], outs["cuda_seq"]
    assert torch.equal(ys, yq)
    for a, b in zip(st, sq):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_engine_serves_autoencoder_through_the_kernels(dev, cell):
    cfg = ae.AutoencoderConfig(cell=cell, mcd=mcd.MCDConfig(
        placement="YNYN", n_samples=4, seed=2))
    params = ae.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    sig = {f"s{k}": rng.standard_normal((24, 1)).astype(np.float32)
           for k in range(3)}
    eng = StreamingEngine(params, cfg, chunk_capacity=8, max_sessions=3,
                          device=dev)
    for sid in sig:
        eng.open_session(sid)
    while any(eng.store.get(s).steps < 24 for s in sig):
        chunks = {}
        for sid in sig:
            pos = eng.store.get(sid).steps
            if pos < 24:
                chunks[sid] = sig[sid][pos:pos + int(rng.integers(1, 9))]
        eng.step(chunks)
        assert eng.last_metrics.launches == 2 * cfg.num_layers
    x = torch.from_numpy(np.concatenate([np.repeat(sig[s][None], 4, 0)
                                         for s in sig])).to(dev)
    rows = torch.from_numpy(np.concatenate(
        [eng.store.get(s).rows for s in sig]).astype(np.int64)).to(dev)
    *_, states = ae.apply(params, x, rows, cfg, backend="cuda_seq",
                          lengths=torch.full((12,), 24, device=dev),
                          return_state=True, device=dev)
    for li, layer in enumerate(states):
        for k, sid in enumerate(sig):
            for part, full in zip(eng.store.get(sid).state[li], layer):
                assert torch.equal(part, full[4 * k:4 * k + 4])


# -- the LM kernels ----------------------------------------------------------

LM_ROWS = [0, 1, 2 ** 31 + 3, 77, 2 ** 31 - 1, 2 ** 32 - 1, 5, 9]
MM_ATOL = 1e-4   # K-long fp32 sums in another order than cuBLAS's


# -- serving precisions: bf16 operands, int8 / int4 weights ----------------

PRECISIONS = ("bf16", "int8", "int4")


def _prec_layer(dev, cell, precision, B, T, I, H, seq, seed=0):
    """One layer's operands at a serving precision, as the stack hands them
    to the kernel (``ops._precision_weights`` from fp32 master weights):
    x and h0 bf16, c0 fp32, codes and scales for the sequence kernel at
    int8 / int4, dequantized bf16 weights for the step kernel."""
    from repro_torch.kernels import ops
    d = (_layer if cell == "lstm" else _gru_layer)(dev, B, T, I, H, seed)
    wx, wh, x, qkw = ops._precision_weights(d["wx"], d["wh"], d["x"],
                                            precision, seq=seq)
    return dict(d, x=x, wx=wx, wh=wh, h0=d["h0"].bfloat16(), qkw=qkw)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("B,T,I,H,path", [
    (67, 40, 1, 8, "warp"), (67, 40, 8, 8, "warp"), (67, 40, 16, 16, "warp"),
    (67, 40, 1, 16, "warp"), (37, 11, 40, 32, "warp"),
    (9, 6, 16, 9, "block"), (7, 4, 128, 128, "block")])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_seq_kernel_bit_equal_at_precision(dev, cell, precision, B, T, I, H,
                                           path, p):
    """The sequence kernels at bf16, int8 and int4 (dequantized at kernel
    entry on the warp path, at each read on the block path; H = 9 pads the
    int4 codes) bit-equal to their plain versions: ys, h_T bf16, c_T fp32;
    ragged lengths, student rows, non-zero h0 / c0."""
    mod = seq if cell == "lstm" else gseq
    fn = mod.mcd_lstm_seq if cell == "lstm" else mod.mcd_gru_seq
    plain = (mod.mcd_lstm_seq_plain if cell == "lstm"
             else mod.mcd_gru_seq_plain)
    gates = 4 if cell == "lstm" else 3
    assert common.seq_plan(gates, B, I, H, 2)["path"] == path
    d = _prec_layer(dev, cell, precision, B, T, I, H, seq=True, seed=H)
    keys = (mcd_lstm if cell == "lstm" else mcd_gru).gate_keys(3, 1)
    kw = dict(h0=d["h0"], lengths=d["lengths"], **d["qkw"])
    if cell == "lstm":
        kw["c0"] = d["c0"]
    args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*args, **kw)
    assert got[0].dtype == torch.bfloat16
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and torch.isfinite(g).all()
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("B,I,H", [(33, 1, 8), (33, 8, 16), (33, 16, 8),
                                   (33, 40, 32), (5, 40, 24), (3, 128, 128)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_step_kernel_bit_equal_at_precision(dev, cell, precision, B, I, H,
                                            p):
    """The step kernels on bf16 operands (the int8 / int4 weights
    dequantized outside, as the reference hands them): bit-equal to their
    plain versions on both paths."""
    d = _prec_layer(dev, cell, precision, B, 1, I, H, seq=False, seed=I)
    x = d["x"][:, 0].contiguous()
    if cell == "lstm":
        step, plain = mcd_lstm.mcd_lstm_step, mcd_lstm.mcd_lstm_step_plain
        args = (x, d["h0"], d["c0"], d["wx"], d["wh"], d["b"], d["rows"],
                mcd_lstm.gate_keys(3, 1), p)
    else:
        step, plain = mcd_gru.mcd_gru_step, mcd_gru.mcd_gru_step_plain
        args = (x, d["h0"], d["wx"], d["wh"], d["b"], d["rows"],
                mcd_gru.gate_keys(3, 1), p)
    got = step(*args)
    torch.cuda.synchronize()
    for g, r in zip(_outs(got), _outs(plain(*args)), strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert _outs(got)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_mask_bits_equal_at_bf16(dev, cell):
    """The factors at bf16: the same keep bits, the scale rounded to bf16
    as the reference's jnp.asarray(1 / (1 - p), bf16)."""
    rows = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31 + 3, 77], device=dev)
    keys = (mcd_lstm if cell == "lstm" else mcd_gru).gate_keys(9, 2)
    for p in (0.125, 0.1, 0.3):
        kx, kh = common.kernel_mask_factors(keys, rows, 16, 8, p,
                                            torch.bfloat16)
        px, ph = common.gate_mask_factors(keys, rows, 16, 8, p,
                                          torch.bfloat16)
        assert torch.equal(kx, px.float()) and torch.equal(kh, ph.float())


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_step_backend_agrees_with_seq_backend_at_precision(dev, cell,
                                                            precision):
    """Bitwise at each precision: the sequence kernel on codes and the step
    kernel on the dequantized weights."""
    params = rnn.init_stack(torch.Generator().manual_seed(1), 1, (16, 8),
                            cell=cell, device=dev)
    cfg = mcd.MCDConfig(p=0.125, placement="YN", seed=4)
    d = _layer(dev, 40, 12, 1, 16)
    outs = {}
    for backend in ("cuda_step", "cuda_seq"):
        outs[backend] = rnn.run_stack(
            params, d["x"], rnn.stack_mask_plan(cfg, 2), cfg.p,
            backend=backend, rows=d["rows"], seed=cfg.seed,
            lengths=d["lengths"], return_all_states=True, cell=cell,
            precision=precision, device=dev)
    (ys, st), (yq, sq) = outs["cuda_step"], outs["cuda_seq"]
    assert ys.dtype == torch.bfloat16 and torch.equal(ys, yq)
    for a, b in zip(st, sq):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and torch.equal(u, v)


def test_seq_wrapper_rejects_what_the_kernel_does_not_take(dev):
    d = _prec_layer(dev, "lstm", "int8", 4, 3, 2, 8, seq=True)
    keys = mcd_lstm.gate_keys(0, 0)
    args = (d["wx"], d["wh"], d["b"], d["rows"], keys, 0.1)
    with pytest.raises(TypeError, match="bf16"):      # int8 over fp32 x
        seq.mcd_lstm_seq(d["x"].float(), *args, **d["qkw"])
    with pytest.raises(ValueError, match="wh_scale"):
        seq.mcd_lstm_seq(d["x"], *args, weight_bits=8,
                         wx_scale=d["qkw"]["wx_scale"])
    with pytest.raises(TypeError):                    # codes read as int4
        seq.mcd_lstm_seq(d["x"], *args, **dict(d["qkw"], weight_bits=4))
    with pytest.raises(TypeError):                    # a bf16 h0 is needed
        seq.mcd_lstm_seq(d["x"], *args, h0=torch.zeros(
            (4, 8), device=dev), **d["qkw"])


# -- the wide path: the cluster split of H, the step kernels' slices -------

def _wide_layer(dev, cell, precision, B, T, I, H, seq, seed=0):
    """A wide layer's operands (weights scaled by 1/sqrt(fan-in), so a gate
    sum stays O(1)) at ``precision`` as the stack hands them to the kernel;
    fp32 as it is."""
    from repro_torch.kernels import ops
    G = 4 if cell == "lstm" else 3
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return (torch.randn(shape, generator=g) * k).to(dev)

    k = (I + H) ** -0.5
    rows = torch.arange(B, dtype=torch.int64) * 3 + 5
    rows[::7] |= mcd.STUDENT_ROW_FLAG
    lens = torch.randint(1, T + 1, (B,), generator=g).to(torch.int32)
    d = dict(x=r(B, T, I), wx=r(I, G, H, k=k), wh=r(H, G, H, k=k),
             b=r(G, H, k=0.1), rows=rows.to(dev), h0=r(B, H, k=0.5),
             c0=r(B, H, k=0.5), lengths=lens.to(dev), qkw={})
    if precision == "fp32":
        return d
    wx, wh, x, qkw = ops._precision_weights(d["wx"], d["wh"], d["x"],
                                            precision, seq=seq)
    return dict(d, x=x, wx=wx, wh=wh, h0=d["h0"].bfloat16(), qkw=qkw)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", ("fp32",) + PRECISIONS)
@pytest.mark.parametrize("B,T,I,H", [(33, 5, 64, 1100), (16, 4, 1, 2048),
                                     (8, 3, 2048, 2048), (9, 3, 20000, 8)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_seq_wide_path_bit_equal(dev, cell, precision, B, T, I, H, p):
    """The sequence kernels' cluster path (H above 1024, a ragged last
    slice at H = 1100; an input too wide for the block path at I = 20000)
    at every precision bit-equal to the plain versions: one launch, ys,
    h_T (and the LSTM's c_T), ragged lengths, student rows, non-zero
    h0 / c0."""
    gates = 4 if cell == "lstm" else 3
    act_bytes = 4 if precision == "fp32" else 2
    assert common.seq_plan(gates, B, I, H, act_bytes)["path"] == "cluster"
    d = _wide_layer(dev, cell, precision, B, T, I, H, seq=True, seed=I + H)
    mod = seq if cell == "lstm" else gseq
    fn = mod.mcd_lstm_seq if cell == "lstm" else mod.mcd_gru_seq
    plain = (mod.mcd_lstm_seq_plain if cell == "lstm"
             else mod.mcd_gru_seq_plain)
    keys = (mcd_lstm if cell == "lstm" else mcd_gru).gate_keys(3, 1)
    kw = dict(h0=d["h0"], lengths=d["lengths"], **d["qkw"])
    if cell == "lstm":
        kw["c0"] = d["c0"]
    args = (d["x"], d["wx"], d["wh"], d["b"], d["rows"], keys, p)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for g, r in zip(got, plain(*args, **kw), strict=True):
        assert g.dtype == r.dtype and torch.isfinite(g).all()
        assert torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", ("fp32",) + PRECISIONS)
@pytest.mark.parametrize("B,I,H", [(33, 64, 1100), (16, 1, 2048),
                                   (9, 20000, 24)])
@pytest.mark.parametrize("p", [0.0, 0.125])
def test_step_wide_path_bit_equal(dev, cell, precision, B, I, H, p):
    """The step kernels' split path (the int8 / int4 weights dequantized
    outside, as the reference hands them) bit-equal to their plain
    versions."""
    gates = 4 if cell == "lstm" else 3
    assert common.step_plan(gates, B, I, H)["path"] == "split"
    d = _wide_layer(dev, cell, precision, B, 1, I, H, seq=False, seed=I)
    x = d["x"][:, 0].contiguous()
    if cell == "lstm":
        step, plain = mcd_lstm.mcd_lstm_step, mcd_lstm.mcd_lstm_step_plain
        args = (x, d["h0"], d["c0"], d["wx"], d["wh"], d["b"], d["rows"],
                mcd_lstm.gate_keys(3, 1), p)
    else:
        step, plain = mcd_gru.mcd_gru_step, mcd_gru.mcd_gru_step_plain
        args = (x, d["h0"], d["wx"], d["wh"], d["b"], d["rows"],
                mcd_gru.gate_keys(3, 1), p)
    before = step.launches
    got = step(*args)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    for g, r in zip(_outs(got), _outs(plain(*args)), strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("precision", [None, "bf16", "int4"])
def test_step_backend_agrees_with_seq_backend_wide(dev, cell, precision):
    """Two H = 1100 layers: the step kernels' split path (T launches a
    layer) and the sequence kernels' cluster path (one) bitwise equal."""
    params = rnn.init_stack(torch.Generator().manual_seed(2), 1,
                            (1100, 1100), cell=cell, device=dev)
    cfg = mcd.MCDConfig(p=0.125, placement="YN", seed=4)
    d = _layer(dev, 20, 7, 1, 8)
    outs = {}
    for backend in ("cuda_step", "cuda_seq"):
        outs[backend] = rnn.run_stack(
            params, d["x"], rnn.stack_mask_plan(cfg, 2), cfg.p,
            backend=backend, rows=d["rows"], seed=cfg.seed,
            lengths=d["lengths"], return_all_states=True, cell=cell,
            precision=precision, device=dev)
    (ys, st), (yq, sq) = outs["cuda_step"], outs["cuda_seq"]
    assert torch.isfinite(ys.float()).all() and torch.equal(ys, yq)
    for a, b in zip(st, sq, strict=True):
        for u, v in zip(a, b, strict=True):
            assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_mask_bits_equal_wide(dev, cell):
    """The card's mask factors at a wide H and a wide input: the plain
    stream's bits."""
    rows = torch.tensor([0, 1, 2 ** 31 + 3, 77], device=dev)
    keys = (mcd_lstm if cell == "lstm" else mcd_gru).gate_keys(9, 2)
    for I, H in ((64, 2048), (60000, 24)):
        kx, kh = common.kernel_mask_factors(keys, rows, I, H, 0.125)
        px, ph = common.gate_mask_factors(keys, rows, I, H, 0.125)
        assert torch.equal(kx, px) and torch.equal(kh, ph)


def _lm_rows(dev, n):
    return torch.tensor((LM_ROWS * n)[:n], dtype=torch.int64, device=dev)


@pytest.mark.parametrize("B,F", [(8, 64), (8, 2048), (6, 37)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_masked_activation_kernel_bit_equal(dev, B, F, p):
    x = torch.randn((B, F), generator=torch.Generator().manual_seed(F)).to(dev)
    rows = _lm_rows(dev, B)
    before = bernoulli_mask.masked_activation.launches
    got = bernoulli_mask.masked_activation(x, rows, 0x9E3779B9, p)
    torch.cuda.synchronize()
    assert bernoulli_mask.masked_activation.launches == before + 1
    want = bernoulli_mask.masked_activation_plain(x, rows, 0x9E3779B9, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("B,F,misaligned", [
    (1, 2048, False), (64, 1024, False), (6, 37, False), (64, 2047, False),
    (8, 2048, True), (5, 1024, True), (65537, 8, False),
    (65537, 5, False)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_masked_activation_edge_cases_bit_equal(dev, B, F, misaligned, p):
    """One row, mamba2's width, F off the 16-byte path, views 4 bytes past
    a 16-byte boundary (the scalar path) and 65537 rows (past gridDim.y's
    limit: a second launch for the last two rows), with rows
    whose bit 31 is set (masked too): bitwise equal to the plain version,
    and the keep bits equal to the plain stream."""
    g = torch.Generator().manual_seed(B * F)
    if misaligned:
        x = torch.randn((B * F + 1,), generator=g).to(dev)[1:].view(B, F)
        assert x.data_ptr() % 16 != 0
    else:
        x = torch.randn((B, F), generator=g).to(dev)
    rows = _lm_rows(dev, B)
    before = bernoulli_mask.masked_activation.launches
    got = bernoulli_mask.masked_activation(x, rows, 0x9E3779B9, p)
    torch.cuda.synchronize()
    assert bernoulli_mask.masked_activation.launches == before + 1
    want = bernoulli_mask.masked_activation_plain(x, rows, 0x9E3779B9, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if p:
        bits = bernoulli_mask.masked_activation(
            torch.ones((B, F), device=dev), rows, 0x9E3779B9, p) != 0
        assert torch.equal(bits, common.gate_mask(0x9E3779B9, rows, F, p))


_MM_EDGES = [(M, K, N) for M in (1, 63, 65, 129) for K in (37, 2049)
             for N in (1, 47, 12288)]


@pytest.mark.parametrize("M,K,N", [(5, 37, 70), (64, 2048, 256),
                                   (130, 96, 65), (8192, 64, 1000),
                                   (4100, 37, 1001)]
                         + _MM_EDGES)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mcd_matmul_kernel_matches_plain(dev, M, K, N, p):
    """Across both tiles' ragged edges (K and N off the 16-byte path
    included), rows with bit 31 set: within MM_ATOL of the cuBLAS plain
    version, whose own order of summation varies with the shape, and two
    calls bitwise equal (the kernel sums K in order, no atomics)."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g).to(dev)
    w = (torch.randn((K, N), generator=g) * K ** -0.5).to(dev)
    rows = _lm_rows(dev, M)
    before = mm.mcd_matmul.launches
    got = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=torch.float32)
    again = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.mcd_matmul.launches == before + 2
    want = mm.mcd_matmul_plain(x, w, rows, 12345, p, torch.float32)
    assert got.shape == (M, N) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= MM_ATOL
    assert torch.equal(got, again)


def _attn(dev, B, H, KV, hd, S, seed=0):
    g = torch.Generator().manual_seed(seed + hd + S)
    return [torch.randn(shape, generator=g).to(dev) for shape in
            [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)]]


# (B, H, KV, hd, S): one split (decode_plan) at qwen3's serving shape and
# at 70 rows; splits and the merge kernel for one prompt's 8 rows, a
# 4096-position cache, rep = 5 at hd = 12, and rep = 8 at hd = 256.
ATTN_SHAPES = [(64, 16, 8, 128, 160), (70, 16, 8, 128, 100),
               (8, 16, 8, 128, 160), (8, 16, 8, 128, 4096),
               (2, 40, 8, 12, 33), (1, 8, 1, 256, 70)]


@pytest.mark.parametrize("B,H,KV,hd,S", [(3, 4, 2, 16, 40),
                                         (2, 16, 8, 128, 160),
                                         (1, 8, 1, 256, 70)]
                         + ATTN_SHAPES[:5])
def test_decode_attention_kernel_matches_plain(dev, B, H, KV, hd, S):
    """Split and unsplit plans within 1e-5 of the plain version, one count
    a call (the merge kernel included)."""
    q, kc, vc = _attn(dev, B, H, KV, hd, S)
    for pos in (0, S // 2, S - 1):
        before = decode_attn.decode_attention.launches
        got = decode_attn.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 1
        want = decode_attn.decode_attention_plain(q, kc, vc, pos)
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("B,H,KV,hd,S", ATTN_SHAPES[:3])
def test_decode_attention_tensor_pos_equals_int(dev, B, H, KV, hd, S):
    """A tensor pos read on the device gives the int's bits; past the
    cache every position is live, before it the output is zero (the TPU
    kernel's masked blocks)."""
    q, kc, vc = _attn(dev, B, H, KV, hd, S)
    for pos in (0, 17, S - 1):
        t = torch.tensor([pos], dtype=torch.int32, device=dev)
        assert torch.equal(decode_attn.decode_attention(q, kc, vc, t),
                           decode_attn.decode_attention(q, kc, vc, pos))
    last = decode_attn.decode_attention(q, kc, vc, S - 1)
    for pos in (S, S + 1000):
        t = torch.tensor([pos], dtype=torch.int32, device=dev)
        assert torch.equal(decode_attn.decode_attention(q, kc, vc, t), last)
    t = torch.tensor([-1], dtype=torch.int32, device=dev)
    assert torch.equal(decode_attn.decode_attention(q, kc, vc, t),
                       torch.zeros_like(q))


@pytest.mark.parametrize("B,H,KV,hd,S", ATTN_SHAPES[:3])
def test_decode_attention_graph_replay_equals_eager(dev, B, H, KV, hd, S):
    """One captured call with a tensor pos, replayed as pos moves, gives
    the eager call's bits: the launch shape does not depend on pos and no
    attribute is set inside the capture."""
    q, kc, vc = _attn(dev, B, H, KV, hd, S)
    t = torch.zeros(1, dtype=torch.int32, device=dev)
    decode_attn.decode_attention(q, kc, vc, t)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attn.decode_attention(q, kc, vc, t)
    for pos in (0, S // 3, S - 1):
        t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attn.decode_attention(q, kc, vc, pos))


@pytest.mark.parametrize("B,H,KV,hd,S", ATTN_SHAPES[:3])
def test_decode_attention_ignores_nan_past_pos(dev, B, H, KV, hd, S):
    """No position past pos is read: NaN there leaves the bits as they
    were, with an int pos and with a tensor pos."""
    q, kc, vc = _attn(dev, B, H, KV, hd, S)
    for pos in (0, 21, S - 2):
        want = decode_attn.decode_attention(q, kc, vc, pos)
        kn, vn = kc.clone(), vc.clone()
        kn[:, pos + 1:] = float("nan")
        vn[:, pos + 1:] = float("nan")
        t = torch.tensor([pos], dtype=torch.int32, device=dev)
        assert torch.equal(decode_attn.decode_attention(q, kn, vn, pos), want)
        assert torch.equal(decode_attn.decode_attention(q, kn, vn, t), want)


@pytest.mark.parametrize("B,H,KV,hd,S", ATTN_SHAPES)
def test_decode_attention_two_calls_bitwise_equal(dev, B, H, KV, hd, S):
    """Splits merge in split order and warps in warp order: no atomics."""
    q, kc, vc = _attn(dev, B, H, KV, hd, S)
    pos = S - 5
    assert torch.equal(decode_attn.decode_attention(q, kc, vc, pos),
                       decode_attn.decode_attention(q, kc, vc, pos))


def test_decode_attention_rejects_a_bad_tensor_pos(dev):
    q, kc, vc = _attn(dev, 2, 4, 2, 16, 40)
    for bad in (torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(2, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            decode_attn.decode_attention(q, kc, vc, bad)


def test_lm_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((2, 4, 16), device=dev)
    kc = torch.zeros((2, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="pos"):
        decode_attn.decode_attention(q, kc, kc, 8)
    with pytest.raises(NotImplementedError, match="precision"):
        decode_attn.decode_attention(q.double(), kc.double(), kc.double(), 0)
    with pytest.raises(NotImplementedError, match="precision"):
        bernoulli_mask.masked_activation(q[0].half(), _lm_rows(dev, 4),
                                         1, 0.1)
    with pytest.raises(NotImplementedError, match="precision"):
        mm.mcd_matmul(q[0].half(), torch.zeros((16, 3), device=dev).half(),
                      _lm_rows(dev, 4), 1, 0.1)
    with pytest.raises(NotImplementedError, match="precision"):
        decode_attn.decode_attention(q.half(), kc.half(), kc.half(), 0)
    with pytest.raises(ValueError, match="shape"):
        mm.mcd_matmul(q[0], torch.zeros((15, 3), device=dev),
                      _lm_rows(dev, 4), 1, 0.1)


def test_lm_engine_serves_through_the_kernels(dev):
    cfg = configs.get_config("qwen3-1.7b", reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=4))
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    names = (bernoulli_mask.masked_activation, mm.mcd_matmul,
             decode_attn.decode_attention)
    for fn in names:
        fn.launches = 0
    res = BayesianEngine(params, cfg, max_len=12, seed=1,
                         device=dev).generate(prompts, 4, keep_logits=True)
    L = cfg.num_layers
    assert [fn.launches for fn in names] == [L * 5, L * 5, L * 4]
    ref = BayesianEngine(params, cfg, max_len=12, seed=1, device=dev,
                         backend="reference").generate(
        prompts, 4, teacher_tokens=res.tokens, keep_logits=True)
    assert (res.logits - ref.logits).abs().max().item() <= 1e-4
    assert (res.mutual_information - ref.mutual_information).abs().max() \
        .item() <= 1e-4


# -- the Mamba2 scan --------------------------------------------------------

SSD_ATOL = 1e-4  # fp32: outputs of a few units; log-decays of ~10^2
                 # summed in order as torch's scan along the chunk axis
                 # does; 128- and 256-long sums in another order


def _ssd_inputs(dev, B, L, H, P, N, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, k=1.0):
        return torch.randn(shape, generator=g) * k

    dt = torch.nn.functional.softplus(r(B, L, H, k=0.5) - 3.0)
    a = -torch.linspace(1.0, 16.0, H)
    return [t.to(dev) for t in (r(B, L, H, P), dt, a, r(B, L, N, k=0.3),
                                r(B, L, N, k=0.3), torch.linspace(0.5, 1.5,
                                                                  H))]


@pytest.mark.parametrize("B,L,H,P,N,q", [(3, 40, 2, 8, 16, 16),
                                         (2, 320, 4, 64, 128, 256),
                                         (2, 150, 3, 40, 72, 64),
                                         (1, 400, 2, 20, 100, 256)])
def test_ssd_chunk_scan_kernel_matches_plain(dev, B, L, H, P, N, q):
    ins = _ssd_inputs(dev, B, L, H, P, N, seed=L)
    before = ssd_chunk.ssd_chunk_scan.launches
    y, h = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
    torch.cuda.synchronize()
    assert ssd_chunk.ssd_chunk_scan.launches == before + 1
    wy, wh = ssd_chunk.ssd_chunk_scan_plain(*ins, q_chunk=q)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert (y - wy).abs().max().item() <= SSD_ATOL
    assert (h - wh).abs().max().item() <= SSD_ATOL


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ins = _ssd_inputs(dev, 1, 16, 2, 8, 16)
    with pytest.raises(NotImplementedError, match="precision"):
        ssd_chunk.ssd_chunk_scan(ins[0].half(), *ins[1:])
    with pytest.raises(ValueError, match="P="):
        ssd_chunk.ssd_chunk_scan(torch.zeros((1, 16, 2, 72), device=dev),
                                 *ins[1:])
    with pytest.raises(ValueError, match="shared memory"):
        big = _ssd_inputs(dev, 1, 512, 1, 64, 128)
        ssd_chunk.ssd_chunk_scan(*big, q_chunk=512)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk.ssd_chunk_scan(
            torch.zeros((1, 16, 4, 8), device=dev)[:, :, :2], *ins[1:])


def test_mamba_engine_serves_through_the_kernels(dev):
    cfg = configs.get_config("mamba2-370m", reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=4))
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    names = (bernoulli_mask.masked_activation, ssd_chunk.ssd_chunk_scan,
             mm.mcd_matmul, decode_attn.decode_attention)
    for fn in names:
        fn.launches = 0
    res = BayesianEngine(params, cfg, max_len=44, seed=1,
                         device=dev).generate(prompts, 4, keep_logits=True)
    L = cfg.num_layers
    assert [fn.launches for fn in names] == [L * 5, L, 0, 0]
    ref = BayesianEngine(params, cfg, max_len=44, seed=1, device=dev,
                         backend="reference").generate(
        prompts, 4, teacher_tokens=res.tokens, keep_logits=True)
    assert (res.logits - ref.logits).abs().max().item() <= 1e-4
    assert (res.mutual_information - ref.mutual_information).abs().max() \
        .item() <= 1e-4


# -- the LM kernels at bf16 ----------------------------------------------------

def _within_bf16_ulp(got, want, atol):
    """Every |got - want| <= atol + one bf16 ulp of want (2^(e-7) at |want|
    in [2^e, 2^(e+1))): fp32 results within ``atol`` of each other, each
    rounded once to bf16, differ by at most that."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2 ** -126)))
                     - 7)
    return bool(((g - w).abs() <= atol + ulp).all())


@pytest.mark.parametrize("B,F,misaligned", [
    (64, 2048, False), (64, 1024, False), (6, 37, False), (8, 2044, False),
    (8, 2048, True), (65537, 8, False)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_masked_activation_bf16_bit_equal(dev, B, F, misaligned, p):
    """The bf16 kernel on its 16-byte path (8 elements a thread) and off it
    (F % 8, a view 2 bytes past a 16-byte boundary), past the row-block
    limit: bitwise equal to the plain version, the keep bits the plain
    stream's, one launch a call."""
    g = torch.Generator().manual_seed(B + F)
    n = B * F + int(misaligned)
    x = torch.randn((n,), generator=g).bfloat16().to(dev)[int(misaligned):]
    x = x.view(B, F)
    rows = _lm_rows(dev, B)
    before = bernoulli_mask.masked_activation.launches
    got = bernoulli_mask.masked_activation(x, rows, 0x9E3779B9, p)
    torch.cuda.synchronize()
    assert bernoulli_mask.masked_activation.launches == before + 1
    assert got.dtype == torch.bfloat16
    want = bernoulli_mask.masked_activation_plain(x, rows, 0x9E3779B9, p)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if p:
        ones = torch.ones((B, F), device=dev, dtype=torch.bfloat16)
        bits = bernoulli_mask.masked_activation(ones, rows, 0x9E3779B9,
                                                p) != 0
        assert torch.equal(bits, common.gate_mask(0x9E3779B9, rows, F, p))


@pytest.mark.parametrize("M,K,N", [(64, 2048, 12288), (64, 2048, 256),
                                   (5, 37, 70), (130, 96, 65),
                                   (8192, 64, 1000), (65, 2050, 1001),
                                   (8192, 2050, 1001)])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("out", ["fp32", "bf16"])
def test_mcd_matmul_bf16_matches_plain(dev, M, K, N, p, out):
    """bf16 x and W (K and N off the 16-byte path included: the CUDA-core
    tiles, the wide one at M = 8192; on it: the tensor cores), the mask in
    bf16, fp32 sums: fp32 out within MM_ATOL of the plain version (the fp32
    product of the same bf16 values, in cuBLAS's order), bf16 out within
    one bf16 ulp of it; two calls bitwise equal, on the path the plan
    names."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g).bfloat16().to(dev)
    w = (torch.randn((K, N), generator=g) * K ** -0.5).bfloat16().to(dev)
    rows = _lm_rows(dev, M)
    od = torch.float32 if out == "fp32" else torch.bfloat16
    before = mm.mcd_matmul.launches
    got = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=od)
    again = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=od)
    torch.cuda.synchronize()
    assert mm.mcd_matmul.launches == before + 2
    assert mm.mcd_matmul.last_plan == mm.matmul_plan(M, N, K, 2)
    want = mm.mcd_matmul_plain(x, w, rows, 12345, p, od)
    assert got.dtype == od and got.shape == (M, N)
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    if od == torch.float32:
        assert (got - want).abs().max().item() <= MM_ATOL
    else:
        assert _within_bf16_ulp(got, want, MM_ATOL)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 130, 8192])
@pytest.mark.parametrize("N", [256, 1000, 12288])
@pytest.mark.parametrize("K", [64, 2048, 2056])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("out", ["fp32", "bf16"])
def test_mcd_matmul_bf16_tensor_cores_match_plain(dev, M, N, K, p, out):
    """The tensor-core path (K and N multiples of 8, aligned operands) on
    both tiles and their ragged edges in M, N and K, rows with bit 31 set
    masked like any other: fp32 out within MM_ATOL of the plain version
    (the tensor core sums each k16 step in its own order), bf16 out within
    one bf16 ulp of it plus MM_ATOL; two calls bitwise equal, one launch a
    call."""
    plan = mm.matmul_plan(M, N, K, 2)
    assert plan["path"] == "tensor_cores"
    assert plan["tile"] == ("tc_wide" if M == 8192 and N == 12288
                            else "tc_narrow")
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).bfloat16()
    rows = _lm_rows(dev, M)
    od = torch.float32 if out == "fp32" else torch.bfloat16
    before = mm.mcd_matmul.launches
    got = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=od)
    again = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=od)
    torch.cuda.synchronize()
    assert mm.mcd_matmul.launches == before + 2
    assert mm.mcd_matmul.last_plan == plan
    want = mm.mcd_matmul_plain(x, w, rows, 12345, p, od)
    assert got.dtype == od and got.shape == (M, N)
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    if od == torch.float32:
        assert (got - want).abs().max().item() <= MM_ATOL
    else:
        assert _within_bf16_ulp(got, want, MM_ATOL)


# The zoo's gate/up products at decode and prefill: jamba-1.5-large's
# mamba.mlp (K 8192, N 49152) and llama3-8b's (K 4096, N 28672).
@pytest.mark.parametrize("M", [64, 8192])
@pytest.mark.parametrize("K,N", [(8192, 49152), (4096, 28672)])
def test_mcd_matmul_bf16_zoo_shapes_match_plain(dev, M, K, N):
    """On the tensor cores (the narrow tile at decode, the wide one at a
    prefill), fp32 out within MM_ATOL of the plain version at K = 8192 and
    4096, two calls bitwise equal, one launch a call."""
    plan = mm.matmul_plan(M, N, K, 2)
    assert (plan["path"], plan["tile"]) == (
        "tensor_cores", "tc_narrow" if M == 64 else "tc_wide")
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).bfloat16()
    rows = _lm_rows(dev, M)
    before = mm.mcd_matmul.launches
    got = mm.mcd_matmul(x, w, rows, 12345, 0.1, out_dtype=torch.float32)
    again = mm.mcd_matmul(x, w, rows, 12345, 0.1, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.mcd_matmul.launches == before + 2
    assert mm.mcd_matmul.last_plan == plan
    want = mm.mcd_matmul_plain(x, w, rows, 12345, 0.1, torch.float32)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got - want).abs().max().item() <= MM_ATOL


@pytest.mark.parametrize("M,K,N,tile", [(64, 2048, 256, "narrow"),
                                        (8192, 64, 1000, "wide")])
@pytest.mark.parametrize("operand", ["x", "w"])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mcd_matmul_bf16_misaligned_takes_the_cuda_cores(dev, M, K, N, tile,
                                                         operand, p):
    """An operand 2 bytes past a 16-byte boundary at a shape the tensor
    cores would take: the wrapper launches the CUDA-core tile of its plan
    (the wide one at a prefill), within MM_ATOL of the plain version, two
    calls bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(M + K + N)

    def operand_of(shape, k, off):
        n = shape[0] * shape[1]
        buf = torch.randn((n + off,), generator=g, device=dev) * k
        return buf.bfloat16()[off:].view(shape)

    x = operand_of((M, K), 1.0, 1 if operand == "x" else 0)
    w = operand_of((K, N), K ** -0.5, 1 if operand == "w" else 0)
    assert (x.data_ptr() % 16 != 0) == (operand == "x")
    assert (w.data_ptr() % 16 != 0) == (operand == "w")
    rows = _lm_rows(dev, M)
    before = mm.mcd_matmul.launches
    got = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=torch.float32)
    plan = mm.mcd_matmul.last_plan
    again = mm.mcd_matmul(x, w, rows, 12345, p, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.mcd_matmul.launches == before + 2
    assert (plan["path"], plan["tile"]) == ("cuda_cores", tile)
    assert mm.matmul_plan(M, N, K, 2)["path"] == "tensor_cores"
    want = mm.mcd_matmul_plain(x, w, rows, 12345, p, torch.float32)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got - want).abs().max().item() <= MM_ATOL


@pytest.mark.parametrize("B,H,KV,hd,S", [(3, 4, 2, 16, 40)] + ATTN_SHAPES[:4]
                         + [(1, 8, 1, 256, 70), (64, 64, 8, 128, 160),
                            (64, 32, 8, 128, 160)])
def test_decode_attention_bf16_matches_plain(dev, B, H, KV, hd, S):
    """bf16 q and caches, split and unsplit plans (the merge kernel
    writing bf16): within 1e-5 plus one bf16 ulp of the plain version
    (fp32 math on the same bf16 values, rounded once); a tensor pos equal to
    the int; one count a call."""
    q, kc, vc = (t.bfloat16() for t in _attn(dev, B, H, KV, hd, S))
    for pos in (0, S // 2, S - 1):
        before = decode_attn.decode_attention.launches
        got = decode_attn.decode_attention(q, kc, vc, pos)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        got_t = decode_attn.decode_attention(q, kc, vc, pos_t)
        torch.cuda.synchronize()
        assert decode_attn.decode_attention.launches == before + 2
        want = decode_attn.decode_attention_plain(q, kc, vc, pos)
        assert got.dtype == torch.bfloat16 and torch.equal(got, got_t)
        assert _within_bf16_ulp(got, want, 1e-5)


@pytest.mark.parametrize("B,L,H,P,N,q,misaligned,path", [
    (3, 40, 2, 8, 16, 16, False, "tensor_cores"),
    (2, 320, 4, 64, 128, 256, False, "tensor_cores"),      # Q = 160
    (1, 400, 2, 20, 100, 256, False, "widen"),             # P, N ragged
    (64, 512, 32, 64, 128, 256, False, "tensor_cores"),    # serving
    (8, 320, 32, 64, 128, 256, False, "tensor_cores"),     # Q = 160
    (64, 128, 256, 64, 128, 256, False, "tensor_cores"),   # jamba, Q = 128
    (2, 320, 4, 64, 128, 256, True, "widen")])             # x off 16 bytes
def test_ssd_chunk_scan_bf16_matches_plain(dev, B, L, H, P, N, q, misaligned,
                                           path):
    """bf16 x, B and C (dt, a and D fp32): y (bf16) within SSD_ATOL plus
    one bf16 ulp of the plain version, the state (fp32) within SSD_ATOL;
    one count a call; the path the plan names (``last_plan``), and two
    calls bitwise equal."""
    ins = _ssd_inputs(dev, B, L, H, P, N, seed=L)
    for i in (0, 3, 4):
        ins[i] = ins[i].bfloat16()
    if misaligned:
        buf = torch.empty(ins[0].numel() + 4, dtype=torch.bfloat16,
                          device=dev)
        ins[0] = buf[4:].view(ins[0].shape).copy_(ins[0])
        assert ins[0].data_ptr() % 16 == 8
    before = ssd_chunk.ssd_chunk_scan.launches
    y, h = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
    assert ssd_chunk.ssd_chunk_scan.last_plan["path"] == path
    y2, h2 = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=q)
    torch.cuda.synchronize()
    assert ssd_chunk.ssd_chunk_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    wy, wh = ssd_chunk.ssd_chunk_scan_plain(*ins, q_chunk=q)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert _within_bf16_ulp(y, wy, SSD_ATOL)
    assert (h - wh).abs().max().item() <= SSD_ATOL


def test_ssd_chunk_scan_bf16_y_unrounded(dev):
    """``y_dtype=torch.float32`` on the tensor-core path: y before its one
    rounding, within SSD_ATOL of the plain version's fp32 y, and rounding
    it gives the bf16 launch's y; off that path it raises."""
    ins = _ssd_inputs(dev, 2, 320, 4, 64, 128, seed=3)
    for i in (0, 3, 4):
        ins[i] = ins[i].bfloat16()
    yf, hf = ssd_chunk.ssd_chunk_scan(*ins, y_dtype=torch.float32)
    y, h = ssd_chunk.ssd_chunk_scan(*ins)
    torch.cuda.synchronize()
    assert yf.dtype == torch.float32 and torch.equal(hf, h)
    assert torch.equal(yf.bfloat16(), y)
    wy, _ = ssd_chunk.ssd_chunk_scan_plain(*(t.float() for t in ins))
    assert (yf - wy).abs().max().item() <= SSD_ATOL
    with pytest.raises(ValueError, match="y_dtype"):
        ssd_chunk.ssd_chunk_scan(*[t.float() if i in (0, 3, 4) else t
                                   for i, t in enumerate(ins)],
                                 y_dtype=torch.bfloat16)


@pytest.mark.parametrize("arch,prompt_len", [("qwen3-1.7b", 6),
                                             ("mamba2-370m", 40)])
def test_lm_engine_serves_bf16_through_the_kernels(dev, arch, prompt_len):
    """bf16 parameters: the launch counts of fp32, and the kernel backend
    within the bf16 tolerances of the reference backend, teacher-forced
    (qwen3's decode softmax is the TPU kernel's fp32 one on the kernel
    backend and the reference's bf16-rounded one on the other)."""
    cfg = configs.get_config(arch, reduced=True)
    cfg = cfg.replace(mcd=cfg.mcd.replace(n_samples=4))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (2, prompt_len))
    names = (bernoulli_mask.masked_activation, mm.mcd_matmul,
             decode_attn.decode_attention, ssd_chunk.ssd_chunk_scan)
    counts, runs = [], []
    for dtype in (torch.float32, torch.bfloat16):
        params = backbone.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=dtype)
        for fn in names:
            fn.launches = 0
        res = BayesianEngine(params, cfg, max_len=prompt_len + 4, seed=1,
                             device=dev).generate(prompts, 4,
                                                  keep_logits=True)
        counts.append([fn.launches for fn in names])
        runs.append((params, res))
    assert counts[0] == counts[1] and counts[0][0] > 0
    params, res = runs[1]
    ref = BayesianEngine(params, cfg, max_len=prompt_len + 4, seed=1,
                         device=dev, backend="reference").generate(
        prompts, 4, teacher_tokens=res.tokens, keep_logits=True)
    assert (res.logits - ref.logits).abs().max().item() <= 0.06


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_int8_kv_decode_runs_on_the_card(dev, backend):
    """decode_step from an int8 zero state: the codes and bf16 scales
    written in place, the bf16 decode_attention kernel on the dequantized
    cache (one launch a layer a step on the kernel backend)."""
    cfg = configs.get_config("qwen3-1.7b", reduced=True)
    params = backbone.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.bfloat16)
    st = backbone.init_decode_state(cfg, 4, 8, kv_quant=True, device=dev)
    ctx = layers.Ctx(mcd.sample_rows(2, 2, device=dev), 1, cfg.mcd)
    decode_attn.decode_attention.launches = 0
    for i in range(4):
        tok = torch.full((4, 1), 3 + i, dtype=torch.int32, device=dev)
        lg, st = backbone.decode_step(params, cfg, tok, st, ctx, backend)
    torch.cuda.synchronize()
    assert torch.isfinite(lg).all()
    k8, ks, _, _ = st.caches[0][0][0]
    assert k8.dtype == torch.int8 and ks[:, :4].abs().min() > 0
    assert not ks[:, 4:].any()
    want = 4 * cfg.num_layers if backend == "cuda" else 0
    assert decode_attn.decode_attention.launches == want
