"""The host-side plans of the redesigned kernels, on the CPU.

``mcd_matmul.matmul_plan`` picks the product's tile, grid, shared memory
and keep-bit scratch; ``mcd_gru_seq.gru_seq_plan`` and
``mcd_lstm_seq.lstm_seq_plan`` (both ``common.seq_plan``) pick a recurrent
layer's path (warp or block), rows a block, threads and shared memory;
``ssd_chunk.ssd_plan`` the SSD scan's chunk, grids, shared memory and
scores scratch; ``decode_attn.decode_plan`` the attention's position tiles,
splits, grid, shared memory and scratch of partials, from the shapes alone
(never ``pos``); ``bernoulli_mask.mask_plan`` the mask's 16-byte path
and 2-D grid; ``common.step_plan`` the LSTM and GRU step kernels'
path (warp or block), rows a block and threads.  The kernels run only on
the card; what they are launched with is checked here: every output and every row covered exactly once, the
warp path taken for H that divides 32, shared memory within the H100's 227
KB, the plans in step with the constants of the CUDA sources, and
unsupported shapes refused (with a pointer to ROADMAP.md where the port
queues them).  No JAX.
"""

import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import bernoulli_mask as bm  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels import decode_attn  # noqa: E402
from repro_torch.kernels import mcd_gru, mcd_lstm  # noqa: E402
from repro_torch.kernels import mcd_gru_seq as gseq  # noqa: E402
from repro_torch.kernels import mcd_lstm_seq as lseq  # noqa: E402
from repro_torch.kernels import mcd_matmul as mm  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402

SMEM_LIMIT = 227 * 1024


def _coverage(n, block, blocks):
    """How often each of n indices is covered by ``blocks`` tiles of
    ``block`` (tiles past n cover nothing)."""
    hits = np.zeros(blocks * block, dtype=np.int64)
    for b in range(blocks):
        hits[b * block:(b + 1) * block] += 1
    return hits[:n]


@pytest.mark.parametrize("M,N,K", [(1, 1, 1), (5, 70, 37), (63, 47, 2049),
                                   (64, 12288, 2048), (65, 12290, 2050),
                                   (129, 1, 37), (130, 65, 96),
                                   (8192, 12288, 2048)])
def test_matmul_grid_covers_every_output_once(M, N, K):
    plan = mm.matmul_plan(M, N, K)
    bm, bn = plan["block"]
    gx, gy = plan["grid"]
    assert np.all(_coverage(M, bm, gy) == 1)
    assert np.all(_coverage(N, bn, gx) == 1)
    assert (gy - 1) * bm < M and (gx - 1) * bn < N    # no idle block row
    assert plan["scratch_words"] == M * -(-K // 32)
    assert 0 < plan["smem"] <= SMEM_LIMIT


def test_matmul_tiles_of_the_serving_shapes():
    decode = mm.matmul_plan(64, 12288, 2048)
    prefill = mm.matmul_plan(8192, 12288, 2048)
    assert decode["tile"] == "narrow" and prefill["tile"] == "wide"
    # decode: one wave on the card, no split of K
    assert decode["grid"][0] * decode["grid"][1] <= common.SMS
    # prefill: at least two blocks an SM
    assert prefill["grid"][0] * prefill["grid"][1] >= 2 * common.SMS
    assert decode["scratch_words"] * 4 == 16 * 1024          # 16 KB
    assert prefill["scratch_words"] * 4 == 2 * 1024 * 1024   # 2 MB


def test_matmul_tiles_match_the_cuda_source():
    """Each TILES entry is the template the C entry launches for its id,
    and the shared memory the plan asks is the source's Tile::kSmem."""
    src = (build.CSRC / "mcd_matmul.cu").read_text()
    launched = dict(re.findall(
        r"if \(tile == (\d)\)\s*return launch_tile<([\d, ]+)>", src))
    assert len(launched) == len(mm.TILES)
    for name, (tid, bm, bn, threads, bk, stages) in mm.TILES.items():
        BM, BN, TM, TN, _VN, BK, STAGES, _ = (
            int(v) for v in launched[str(tid)].split(","))
        assert (BM, BN, BK, STAGES) == (bm, bn, bk, stages)
        assert (BM // TM) * (BN // TN) == threads
        plan = mm.matmul_plan(bm * 2 * common.SMS if name == "wide" else 1,
                              bn, bk)
        assert plan["tile"] == name
        stage = BM * BK + BK * BN + threads
        assert plan["smem"] == 4 * (STAGES * stage + 2 * BK * (BM + 4))


@pytest.mark.parametrize("M,N,K", [(0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_matmul_plan_refuses_empty_products(M, N, K):
    with pytest.raises(ValueError):
        mm.matmul_plan(M, N, K)


def test_matmul_plan_refuses_too_many_rows():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mm.matmul_plan(65536 * 128 + 1, 12288, 2048)


@pytest.mark.parametrize("B", [1, 5, 33, 1920])
@pytest.mark.parametrize("I,H", [(1, 16), (16, 8), (8, 16), (16, 16),
                                 (1, 8), (8, 8), (40, 32), (3, 4),
                                 (5, 24), (128, 128), (40, 1)])
def test_gru_plan_covers_every_row_once(B, I, H):
    plan = gseq.gru_seq_plan(B, I, H)
    rows, blocks = plan["rows"], plan["blocks"]
    assert np.all(_coverage(B, rows, blocks) == 1)
    assert (blocks - 1) * rows < B
    assert 0 < plan["smem"] <= SMEM_LIMIT
    if plan["path"] == "warp":
        # whole warps, 32 // H rows a warp, at most 4 warps a block
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 128
        assert rows == plan["threads"] // 32 * (32 // H)
    else:
        assert plan["threads"] == rows * H <= 1024


@pytest.mark.parametrize("H", list(range(1, 41)))
def test_gru_warp_path_iff_hidden_divides_32(H):
    for I in (1, 8, 16, 40):
        for B in (1, 33, 1920):
            path = gseq.gru_seq_plan(B, I, H)["path"]
            assert (path == "warp") == (32 % H == 0), (B, I, H)


def test_gru_plan_spreads_the_ecg_layers_over_every_sm():
    for I, H in ((1, 16), (16, 8), (8, 16), (16, 16), (1, 8), (8, 8)):
        plan = gseq.gru_seq_plan(1920, I, H)
        assert plan["path"] == "warp"
        assert plan["blocks"] >= 2 * common.SMS


def test_gru_plan_matches_the_cuda_source():
    """The warp path's shared memory is the source's warp_smem_bytes, and
    its x ring the source's kXRing."""
    src = (build.CSRC / "mcd_gru_seq.cu").read_text()
    assert re.search(rf"constexpr int kXRing = {gseq.X_RING};", src)
    for B, I, H in ((1920, 16, 16), (33, 40, 32), (7, 3, 4)):
        plan = gseq.gru_seq_plan(B, I, H)
        R = plan["rows"]
        assert plan["smem"] == 4 * (R * (3 * (I + H) + gseq.X_RING * I)
                                    + 3 * I * H)
    plan = gseq.gru_seq_plan(5, 40, 24)
    assert plan["smem"] == 4 * plan["rows"] * (3 * (40 + 24) + 40 + 24)


def test_gru_wide_input_takes_the_block_path():
    """An input too wide for the warp path's shared memory (wx alone is
    12 * I * H bytes) runs on the block path, which computes the same
    bits."""
    plan = gseq.gru_seq_plan(3, 8192, 8)
    assert plan["path"] == "block" and plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("I,H", [(8, 2048), (20000, 8), (60000, 24)])
def test_gru_plan_refuses_what_fits_no_path(I, H):
    """What fitted neither the warp nor the block path (H above 1024; a
    row's mask factors, x and h above a block's shared memory) takes the
    cluster path; the block path's own rule still refuses it."""
    plan = gseq.gru_seq_plan(4, I, H)
    assert plan == common.wide_plan(3, 4, I, H, "cluster")
    assert plan["path"] == "cluster" and plan["smem"] <= SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="wide path"):
        common.tile_rows(3, I, H)


# -- mcd_lstm_seq: the GRU's plan with four gates ----------------------------

CLF_AE_LAYERS = [(1, 8), (8, 8), (1, 16), (16, 8), (8, 16), (16, 16)]


@pytest.mark.parametrize("B", [1, 5, 33, 1920])
@pytest.mark.parametrize("I,H", CLF_AE_LAYERS + [(40, 32), (3, 4), (5, 24),
                                                  (128, 128), (40, 1)])
def test_lstm_plan_covers_every_row_once(B, I, H):
    plan = lseq.lstm_seq_plan(B, I, H)
    rows, blocks = plan["rows"], plan["blocks"]
    assert np.all(_coverage(B, rows, blocks) == 1)
    assert (blocks - 1) * rows < B
    assert 0 < plan["smem"] <= SMEM_LIMIT
    if plan["path"] == "warp":
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 128
        assert rows == plan["threads"] // 32 * (32 // H)
    else:
        assert plan["threads"] == rows * H <= 1024
        assert rows == lseq.tile_rows(I, H)


@pytest.mark.parametrize("H", list(range(1, 41)))
def test_lstm_warp_path_iff_hidden_divides_32(H):
    for I in (1, 8, 16, 40):
        for B in (1, 33, 1920):
            path = lseq.lstm_seq_plan(B, I, H)["path"]
            assert (path == "warp") == (32 % H == 0), (B, I, H)


def test_lstm_plan_spreads_the_ecg_layers_over_every_sm():
    for I, H in CLF_AE_LAYERS:
        plan = lseq.lstm_seq_plan(1920, I, H)
        assert plan["path"] == "warp"
        assert plan["blocks"] >= 2 * common.SMS


def test_lstm_plan_matches_the_cuda_source():
    """The warp path's shared memory is the source's warp_smem_bytes with
    four gates, its x ring the source's kXRing, and the GRU's plan is the
    same rule with three gates."""
    src = (build.CSRC / "mcd_lstm_seq.cu").read_text()
    assert re.search(r"constexpr int kGates = 4;", src)
    assert re.search(rf"constexpr int kXRing = {lseq.X_RING};", src)
    assert re.search(r"kGates \* \(I \+ H\) \+ kXRing \* I", src)
    for B, I, H in ((1920, 16, 16), (1920, 1, 8), (33, 40, 32), (7, 3, 4)):
        plan = lseq.lstm_seq_plan(B, I, H)
        R = plan["rows"]
        assert plan["smem"] == 4 * (R * (4 * (I + H) + lseq.X_RING * I)
                                    + 4 * I * H)
        assert gseq.gru_seq_plan(B, I, H) == common.seq_plan(3, B, I, H)
    plan = lseq.lstm_seq_plan(5, 40, 24)
    assert plan["smem"] == 4 * plan["rows"] * (4 * (40 + 24) + 40 + 24)


def test_lstm_wide_input_takes_the_block_path():
    """An input too wide for the warp path's shared memory (wx alone is
    16 * I * H bytes) runs on the block path, which computes the same
    bits."""
    plan = lseq.lstm_seq_plan(3, 8192, 8)
    assert plan["path"] == "block" and plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("I,H", [(8, 2048), (20000, 8), (50000, 24)])
def test_lstm_plan_refuses_what_fits_no_path(I, H):
    """What fitted neither the warp nor the block path takes the cluster
    path; the block path's own rule still refuses it."""
    plan = lseq.lstm_seq_plan(4, I, H)
    assert plan == common.wide_plan(4, 4, I, H, "cluster")
    assert plan["path"] == "cluster" and plan["smem"] <= SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="wide path"):
        lseq.tile_rows(I, H)


# -- the serving precisions: plans at each activation width ------------------

@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("B", [1, 33, 1920])
@pytest.mark.parametrize("I,H", CLF_AE_LAYERS + [(40, 32), (3, 4), (16, 9),
                                                  (128, 128), (1, 1)])
def test_seq_plan_at_each_activation_width(gates, B, I, H):
    """At bf16 (2-byte activations: bf16, int8 and int4 weights are
    staged dequantized at the activation width) the warp path stages wx in
    whole 4-byte words of 2-byte values, the factors and the x ring stay
    4-byte, the rows a block follow the same rule; the block path keeps x
    and h as fp32 values, so its plan is the fp32 one.  Every plan fits the
    H100's shared memory and covers every row once; the fp32 plan is the
    one taken with no width given."""
    fp32 = common.seq_plan(gates, B, I, H)
    assert common.seq_plan(gates, B, I, H, 4) == fp32
    plan = common.seq_plan(gates, B, I, H, 2)
    assert plan["path"] == fp32["path"] == ("warp" if 32 % H == 0
                                            else "block")
    assert 0 < plan["smem"] <= fp32["smem"] <= SMEM_LIMIT
    assert np.all(_coverage(B, plan["rows"], plan["blocks"]) == 1)
    if plan["path"] == "block":
        assert plan == fp32
        return
    R = plan["rows"]
    assert plan["smem"] == 4 * (R * (gates * (I + H) + common.X_RING * I)
                                + -(-2 * gates * I * H // 4))
    assert plan["smem"] % 4 == 0


def test_fp32_seq_plans_unchanged():
    """The fp32 plans of the ECG layers at B = 1920 (rows a block, threads,
    shared memory; both gate counts), pinned as the fp32 kernels were
    launched before the serving precisions came."""
    want = {(1, 8): (32, 832, 656), (8, 8): (32, 3072, 2560),
            (1, 16): (64, 1472, 1136), (16, 8): (32, 5632, 4736),
            (8, 16): (64, 4608, 3712), (16, 16): (64, 8192, 6656)}
    for (I, H), (threads, lstm, gru) in want.items():
        for gates, smem in ((4, lstm), (3, gru)):
            assert common.seq_plan(gates, 1920, I, H) == {
                "path": "warp", "rows": 4, "threads": threads,
                "blocks": 480, "smem": smem}


@pytest.mark.parametrize("source", ["mcd_lstm_seq", "mcd_gru_seq"])
def test_seq_sources_size_the_staged_weights_by_the_activation_width(
        source):
    """The sources' warp_smem_bytes pads the staged wx (``act_bytes`` a
    value) to 4-byte words, the precision kernel puts the x ring after it
    at the same offset, each launcher checks the plan with its
    activation's size, and the entry takes bf16 over 16-, 8- and 4-bit
    weights and fp32 over fp32 only."""
    src = (build.CSRC / f"{source}.cu").read_text()
    assert "((size_t)kGates * I * H * act_bytes + 3) / 4" in src
    assert "(I * kGates * H * (int)sizeof(A) + 3) / 4" in src
    assert "warp_smem_bytes(R, I, H, sizeof(A))" in src
    assert "warp_smem_bytes(R, I, H, sizeof(float))" in src
    for bits in (16, 8, 4):
        assert f"act == 1 && wbits == {bits}" in src
    assert "act != 0 || wbits != 32" in src


def _seq_call(gates, precision, B=33, T=5, I=8, H=16):
    """A sequence wrapper and its operands at ``precision`` on CPU tensors,
    as ``ops._precision_weights`` builds them."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(gates)
    x = torch.randn(B, T, I, generator=g)
    wx = torch.randn(I, gates, H, generator=g)
    wh = torch.randn(H, gates, H, generator=g)
    b = torch.randn(gates, H, generator=g)
    wx, wh, x, qkw = ops._precision_weights(wx, wh, x, precision, seq=True)
    h0 = torch.zeros(B, H, dtype=x.dtype)
    kw = dict(h0=h0, **qkw)
    if gates == 4:
        kw["c0"] = torch.zeros(B, H)
    fn = lseq.mcd_lstm_seq if gates == 4 else gseq.mcd_gru_seq
    keys = (mcd_lstm if gates == 4 else mcd_gru).gate_keys(3, 1)
    return fn, (x, wx, wh, b, torch.arange(B), keys, 0.125), kw, qkw


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("precision,act,bits", [
    ("fp32", 0, 32), ("bf16", 1, 16), ("int8", 1, 8), ("int4", 1, 4)])
def test_seq_wrapper_launches_the_plan_at_precision(monkeypatch, gates,
                                                    precision, act, bits):
    """The wrapper passes the plan at the activation width, then the
    activation code and the weight bits (the entry's ``int warp, int
    smem_bytes, int act, int wbits``), the scales after the weights (null
    pointers for unquantized weights) and the dropout scale rounded to the
    activation dtype (the launch itself recorded here, not run)."""
    calls = []
    monkeypatch.setattr(common, "check_device", lambda name, t: False)
    monkeypatch.setattr(common, "launch",
                        lambda wrapper, tensors, ints, keys, n, p, what,
                        act_dtype: calls.append((tensors, ints, act_dtype)))
    fn, args, kw, qkw = _seq_call(gates, precision)
    fn(*args, **kw)
    (tensors, ints, act_dtype), = calls
    B, T, I = args[0].shape
    H = args[2].shape[0]
    plan = common.seq_plan(gates, B, I, H, 4 if act == 0 else 2)
    assert ints == (B, T, I, H, plan["rows"], int(plan["path"] == "warp"),
                    plan["smem"], act, bits)
    assert act_dtype == (torch.float32 if act == 0 else torch.bfloat16)
    if qkw:
        assert tensors[3] is qkw["wx_scale"] and tensors[4] is \
            qkw["wh_scale"]
        wl = H if bits == 8 else -(-H // 2)
        assert tensors[1].shape == (I, gates, wl)
    else:
        assert tensors[3] is None and tensors[4] is None


@pytest.mark.parametrize("gates", [4, 3])
def test_step_wrapper_passes_the_bf16_code(monkeypatch, gates):
    """At bf16 the step wrappers pass act = 1 and the bf16 dropout scale."""
    calls = []
    monkeypatch.setattr(common, "check_device", lambda name, t: False)
    monkeypatch.setattr(common, "launch",
                        lambda wrapper, tensors, ints, keys, n, p, what,
                        act_dtype: calls.append((ints, act_dtype)))
    fn, args = _step_call(gates, 33, 8, 16)
    # x, h and the weights in bf16; c (LSTM) and the bias stay fp32
    act = (0, 1, 3, 4) if gates == 4 else (0, 1, 2, 3)
    bf = [a.bfloat16() if i in act else a for i, a in enumerate(args)]
    fn(*bf)
    (ints, act_dtype), = calls
    assert ints[-1] == 1 and act_dtype == torch.bfloat16


def test_step_plans_do_not_depend_on_the_precision():
    """The step kernels' warp path holds nothing in shared memory and the
    block path keeps x and h as fp32 values: one plan for every
    precision, and step_plan takes no width."""
    assert "act_bytes" not in inspect.signature(common.step_plan).parameters
    for I, H in CLF_AE_LAYERS:
        assert common.step_plan(4, 1920, I, H)["smem"] == 0


# -- ssd_chunk_scan: the scores pre-pass and the head kernel -----------------

SERVING_SSD = (64, 512, 32, 64, 128, 256)      # mamba2-370m prefill


def _cu_constants():
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}, src


def _score_tiles(Q, tile):
    """The causal tiles (kt, qt) the pre-pass's blocks take, in the order
    the source enumerates them."""
    nt = -(-Q // tile)
    out = []
    for t0 in range(nt * (nt + 1) // 2):
        t, kt = t0, 0
        while t >= nt - kt:
            t -= nt - kt
            kt += 1
        out.append((kt, kt + t))
    return out


@pytest.mark.parametrize("B,L,H,P,N,q", [SERVING_SSD,
                                         (8, 320, 32, 64, 128, 256),
                                         (3, 40, 2, 8, 16, 16),
                                         (2, 150, 3, 40, 72, 64),
                                         (1, 400, 2, 20, 100, 256),
                                         (64, 128, 256, 64, 128, 256)])
def test_ssd_plan_covers_every_output_once(B, L, H, P, N, q):
    plan = ssd_chunk.ssd_plan(B, L, H, P, N, q)
    Q = plan["Q"]
    assert Q == common.largest_divisor(L, q) and plan["chunks"] * Q == L
    assert plan["blocks"] == B * H and plan["threads"] == 256
    consts, _ = _cu_constants()
    tile = consts["kST"]
    tiles = _score_tiles(Q, tile)
    assert len(tiles) == plan["score_tiles"]
    assert plan["score_blocks"] == B * plan["chunks"] * len(tiles)
    hits = np.zeros((Q, Q), dtype=np.int64)        # [k, q]
    for kt, qt in tiles:
        assert qt >= kt
        hits[kt * tile:(kt + 1) * tile, qt * tile:(qt + 1) * tile] += 1
    causal = np.triu(np.ones((Q, Q), dtype=bool))  # k <= q
    assert np.all(hits[causal] == 1)
    assert plan["scores_bytes"] == 4 * B * (L // Q) * Q * Q
    assert plan["ct_bytes"] == 4 * B * (L // Q) * N * Q
    # the cumsum: one thread per (b, chunk, h), every chain once
    assert plan["cumsum_threads"] == B * (L // Q) * H
    assert (plan["cumsum_blocks"] - 1) * 256 < plan["cumsum_threads"] \
        <= plan["cumsum_blocks"] * 256
    # the query rows the head block holds: 8 warps x 2 groups of 16
    assert Q <= 16 * 2 * consts["kThreads"] // 32
    assert P <= consts["kPMax"] and N <= consts["kNMax"]
    assert 0 < plan["smem"] <= SMEM_LIMIT
    assert 0 < plan["score_smem"] <= SMEM_LIMIT


def test_ssd_plan_at_the_serving_shape():
    plan = ssd_chunk.ssd_plan(*SERVING_SSD)
    assert plan["Q"] == 256 and plan["chunks"] == 2
    assert plan["blocks_per_sm"] >= 2               # 16 warps an SM
    assert plan["blocks"] >= 2 * common.SMS
    assert plan["scores_bytes"] == 64 * 2 * 256 * 256 * 4   # 33.5 MB,
    assert plan["scores_bytes"] < 50e6                       # within L2


def test_ssd_plan_matches_the_cuda_source():
    consts, src = _cu_constants()
    assert (consts["kThreads"], consts["kQMax"], consts["kPMax"],
            consts["kNMax"], consts["kBK"], consts["kST"]) == (
        ssd_chunk._THREADS, ssd_chunk._MAX_Q, ssd_chunk._MAX_P,
        ssd_chunk._MAX_N, ssd_chunk._BK, ssd_chunk._ST)
    assert re.search(r"constexpr int kTS = kQMax \+ 4;", src)
    assert ssd_chunk._TS == consts["kQMax"] + 4
    assert consts["kStages"] == ssd_chunk._STAGES
    assert re.search(r"constexpr int kStage = kBK \* kTS \+ kBK \* kPMax;",
                     src)
    assert re.search(r"kSmemFloats = kNMax \* kPMax \+ kStages \* kStage "
                     r"\+ 4 \* kQMax;", src)
    plan = ssd_chunk.ssd_plan(*SERVING_SSD)
    assert plan["smem"] == 4 * (128 * 64 + 3 * (16 * 260 + 16 * 64)
                                + 4 * 256)
    assert plan["score_smem"] == 4 * 2 * 128 * (64 + 4)
    # every kernel the wrapper launches holds the name a profile matches
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", src)
    # the fp32 three, the bf16 widen and narrow, the bf16 tensor-core kernel
    assert len(kernels) == 6
    assert "ssd_chunk_scan_kernel_bf16_tc" in kernels
    assert all("ssd_chunk_scan_kernel" in k for k in kernels)


@pytest.mark.parametrize("L,H,P,N,q,what", [
    (512, 1, 64, 128, 512, "shared memory"), (16, 2, 72, 16, 16, "P="),
    (16, 2, 8, 160, 16, "N="), (0, 2, 8, 16, 16, "empty")])
def test_ssd_plan_refuses_what_the_kernel_does_not_take(L, H, P, N, q, what):
    with pytest.raises(ValueError, match=what):
        ssd_chunk.ssd_plan(1, L, H, P, N, q)


# -- ssd_chunk_scan at bf16: the tensor-core path or the widened copies ------

# (B, L, H, P, N, q, aligned, path): serving, Q = 160, small and odd (Q =
# 10, P = 8, N = 16), P and N multiples of 8 off the tiles' widths; P or N
# ragged, or a pointer off 16 bytes: the widened fp32 launch.
SSD_BF16_PATHS = [
    SERVING_SSD + (True, "tensor_cores"),
    (8, 320, 32, 64, 128, 256, True, "tensor_cores"),
    (3, 40, 2, 8, 16, 16, True, "tensor_cores"),
    (2, 150, 3, 40, 72, 64, True, "tensor_cores"),
    (1, 400, 2, 20, 100, 256, True, "widen"),
    (2, 64, 2, 64, 100, 64, True, "widen"),
    (2, 64, 2, 60, 128, 64, True, "widen"),
    SERVING_SSD + (False, "widen"),
    (64, 128, 256, 64, 128, 256, True, "tensor_cores"),   # jamba's prefill
]


@pytest.mark.parametrize("B,L,H,P,N,q,aligned,path", SSD_BF16_PATHS)
def test_ssd_plan_picks_the_bf16_path(B, L, H, P, N, q, aligned, path):
    """The path follows from the shapes and the pointers' alignment alone;
    the tensor-core path allocates no scratch but cs, fits one block an SM
    in the H100's shared memory and covers every (b, h) once; the widened
    path is the fp32 plan on fp32 copies of x, B, C and y."""
    plan = ssd_chunk.ssd_plan(B, L, H, P, N, q, 2, aligned)
    fp32 = ssd_chunk.ssd_plan(B, L, H, P, N, q)
    assert plan["path"] == path and fp32["path"] == "cuda_cores"
    assert plan["Q"] == fp32["Q"] and plan["blocks"] == B * H
    assert plan["cumsum_threads"] == fp32["cumsum_threads"]
    assert 0 < plan["smem"] <= SMEM_LIMIT
    if path == "tensor_cores":
        assert plan["threads"] == 256 and plan["blocks_per_sm"] == 1
        assert plan["tiles"] == -(-plan["Q"] // 64) <= 4
        assert plan["scores_bytes"] == plan["ct_bytes"] == 0
        assert plan["widened_bytes"] == 0 and plan["wgmma_flop"] > 0
    else:
        assert {k: v for k, v in plan.items()
                if k not in ("path", "widened_bytes")} == {
            k: v for k, v in fp32.items()
            if k not in ("path", "widened_bytes")}
        assert plan["widened_bytes"] == 4 * (2 * B * L * H * P
                                             + 2 * B * L * N)


def test_ssd_tensor_core_plan_at_the_serving_shape():
    """197 KB of shared memory (the whole chunk of C, B and x, the state's
    pieces), 2048 blocks of one a SM; 159 GFLOP of m64n64k16 products."""
    plan = ssd_chunk.ssd_plan(*SERVING_SSD, 2)
    assert plan["path"] == "tensor_cores" and plan["Q"] == 256
    assert plan["smem"] == 1024 + 24 * 8192 + 4096 + 32 == 201760
    assert plan["blocks"] == 2048 and plan["tiles"] == 4
    # per (b, h): 10 causal tile pairs x (8 + 4 x 3) and the state update's
    # 2 x 4 x 4 x 2 a chunk, the inter term's 4 x 8 x 2 in the second
    assert plan["wgmma_flop"] == 2048 * (2 * 264 + 64) * 2 * 64 * 64 * 16
    assert 158e9 < plan["wgmma_flop"] < 160e9


def test_ssd_tensor_core_plan_matches_the_cuda_source():
    consts, src = _cu_constants()
    assert (consts["kTcRows"], consts["kTcThreads"]) == (
        ssd_chunk._TC_ROWS, ssd_chunk._TC_THREADS)
    assert {k: consts[f"kPieces{k}"] for k in "GSB"} == ssd_chunk._PIECES
    assert re.search(r"constexpr int kTcBox = 64 \* 64 \* 2;", src)
    assert ssd_chunk._TC_BOX == 64 * 64 * 2
    for line in (r"kTcB = kTcC \+ 2 \* kTcTiles \* kTcBox;",
                 r"kTcX = kTcB \+ 2 \* kTcTiles \* kTcBox;",
                 r"kTcS = kTcX \+ kTcTiles \* kTcBox;",
                 r"kTcF = kTcS \+ kPiecesS \* 2 \* kTcBox;",
                 r"kTcBar = kTcF \+ 4 \* kQMax \* 4;",
                 r"kTcSmem = 1024 \+ kTcBar \+ 8 \* kTcTiles;"):
        assert re.search(r"constexpr int " + line, src), line
    tiles = consts["kQMax"] // consts["kTcRows"]
    smem = 1024 + (5 * tiles + 2 * consts["kPiecesS"]) * 8192 \
        + 16 * consts["kQMax"] + 8 * tiles
    assert ssd_chunk._TC_SMEM == smem


def test_ssd_unrounded_y_is_the_plain_version_on_fp32_inputs():
    """On CPU tensors the wrapper refuses ``y_dtype`` (the tensor-core
    path's); the plain version on the bf16 inputs widened to fp32 gives
    the unrounded y, which rounds to the bf16 call's y."""
    rng = np.random.default_rng(0)
    B, L, H, P, N = 1, 24, 2, 8, 16
    f32 = torch.float32
    x = torch.as_tensor(rng.standard_normal((B, L, H, P)), dtype=f32)
    dt = torch.nn.functional.softplus(
        torch.as_tensor(rng.standard_normal((B, L, H)), dtype=f32))
    a = -torch.linspace(1.0, 4.0, H)
    bmat, cmat = (torch.as_tensor(0.3 * rng.standard_normal((B, L, N)),
                                  dtype=f32) for _ in range(2))
    d = torch.ones(H)
    ins = [x.bfloat16(), dt, a, bmat.bfloat16(), cmat.bfloat16(), d]
    with pytest.raises(ValueError, match="y_dtype"):
        ssd_chunk.ssd_chunk_scan(*ins, q_chunk=8, y_dtype=f32)
    y, h = ssd_chunk.ssd_chunk_scan(*ins, q_chunk=8)
    yf, hf = ssd_chunk.ssd_chunk_scan_plain(*(t.float() for t in ins),
                                            q_chunk=8)
    assert y.dtype == torch.bfloat16 and yf.dtype == f32
    assert torch.equal(yf.bfloat16(), y) and torch.equal(hf, h)


# -- decode_attention: positions split over blocks ---------------------------

ATTN_SERVING = (64, 16, 8, 128, 160)           # qwen3-1.7b decode, 8 x 8 rows
ATTN_SHAPES = [ATTN_SERVING, (8, 16, 8, 128, 160), (8, 16, 8, 128, 4096),
               (64, 32, 8, 128, 160), (3, 4, 2, 16, 40), (1, 8, 1, 256, 70),
               (2, 40, 8, 12, 33), (70, 16, 8, 128, 100), (1, 1, 1, 4, 1),
               (1, 64, 8, 256, 65536), (64, 64, 8, 128, 160)]


def _attn_source():
    src = (build.CSRC / "decode_attn.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}, src


@pytest.mark.parametrize("B,H,KV,hd,S", ATTN_SHAPES)
def test_decode_plan_covers_every_tile_once(B, H, KV, hd, S):
    """Every (b, g, position tile) lies in exactly one block's run, no
    split is idle when every position is live, and the merge kernel's grid
    covers every output of a (b, g) once."""
    plan = decode_attn.decode_plan(B, H, KV, hd, S)
    tile, run, splits = plan["tile"], plan["run"], plan["splits"]
    tiles = -(-S // tile)
    assert plan["tiles"] == tiles and plan["grid"] == (B * KV, splits)
    hits = np.zeros(tiles, dtype=np.int64)       # the same for every (b, g)
    for y in range(splits):
        hits[y * run:min((y + 1) * run, tiles)] += 1
    assert np.all(hits == 1)
    assert (splits - 1) * run < tiles <= splits * run
    assert run <= decode_attn._MAX_RUN
    rep = H // KV
    assert 0 < plan["smem"] <= SMEM_LIMIT
    if splits > 1:
        assert plan["scratch_floats"] == B * KV * splits * rep * (hd + 2)
        gx, gy = plan["merge_grid"]
        assert gx == B * KV and (gy - 1) * 128 < rep * hd <= gy * 128
    else:
        assert plan["scratch_floats"] == 0 and plan["merge_grid"] is None


def test_decode_plan_never_depends_on_pos():
    """The launch shape comes from the shapes (and the element width)
    alone: one plan serves every decode step, so a graph of the call can be
    captured."""
    assert list(inspect.signature(decode_attn.decode_plan).parameters) == [
        "B", "H", "KV", "hd", "S", "elem_bytes"]
    plans = {str(decode_attn.decode_plan(*ATTN_SERVING)) for _ in range(3)}
    assert len(plans) == 1


def test_tensor_pos_is_not_read_on_the_host(monkeypatch):
    """A tensor pos goes to the kernel as a device pointer: no ``.item()``,
    no ``int()``, no host range check (pos >= S and pos < 0 pass)."""
    def no_read(*_):
        raise AssertionError("pos was read on the host")

    for name in ("item", "__int__", "__index__", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    for value in (0, 159, 160, 10 ** 6, -3):
        t = torch.full((1,), value, dtype=torch.int32)
        assert decode_attn._pos_arg(t, 160, t.device) == (t.data_ptr(), 0)


@pytest.mark.parametrize("bad", [torch.zeros(1, dtype=torch.int64),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.zeros((), dtype=torch.float32)])
def test_tensor_pos_must_be_one_int32_on_the_device(bad):
    with pytest.raises(ValueError, match="int32"):
        decode_attn._pos_arg(bad, 160, bad.device)


@pytest.mark.parametrize("pos", [-1, 160, 161])
def test_int_pos_is_checked_on_the_host(pos):
    with pytest.raises(ValueError, match="pos"):
        decode_attn._pos_arg(pos, 160, torch.device("cpu"))


def test_decode_plan_at_the_serving_shapes():
    """qwen3's 512 (row, KV head) pairs fill the card at one split, in one
    wave of four blocks an SM (their shared memory fits one SM); one
    prompt's 8 rows split the cache so the launch still has two blocks an
    SM; a 4096-position cache walks runs of at most 16 tiles."""
    serving = decode_attn.decode_plan(*ATTN_SERVING)
    assert serving["splits"] == 1 and 4 * serving["smem"] <= SMEM_LIMIT
    assert 2 * common.SMS <= 512 <= 4 * common.SMS
    one = decode_attn.decode_plan(8, 16, 8, 128, 160)
    assert one["splits"] > 1
    assert one["grid"][0] * one["grid"][1] >= 2 * common.SMS
    long = decode_attn.decode_plan(8, 16, 8, 128, 4096)
    assert long["run"] <= 16 and long["splits"] * long["run"] == 256
    assert 2 * common.SMS <= long["grid"][0] * long["grid"][1]


def test_decode_plan_matches_the_cuda_source():
    consts, src = _attn_source()
    assert (consts["kThreads"], consts["kTS"], consts["kStages"],
            consts["kMaxRep"], consts["kMaxHd"]) == (
        decode_attn._THREADS, decode_attn._TILE, decode_attn._STAGES,
        decode_attn._MAX_REP, decode_attn._MAX_HD)
    assert consts["kStages"] >= 3          # tile t + 2 in flight at tile t
    assert re.search(r"\(kStages \* 2 \* kTS \* hd \+ rep \* hd\) \* "
                     r"\(int\)sizeof\(float\)", src)
    for B, H, KV, hd, S in ATTN_SHAPES:
        rep = H // KV
        assert decode_attn.decode_plan(B, H, KV, hd, S)["smem"] == 4 * (
            consts["kStages"] * 2 * consts["kTS"] * hd + rep * hd)
    # the largest shape the kernel takes still fits a block
    assert 4 * (consts["kStages"] * 2 * consts["kTS"] * consts["kMaxHd"]
                + consts["kMaxRep"] * consts["kMaxHd"]) <= SMEM_LIMIT
    # every kernel of the launch holds the name a profile matches
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", src)
    assert len(kernels) == 4    # the split and merge kernels, fp32 and bf16
    assert all("decode_attention_kernel" in k for k in kernels)


@pytest.mark.parametrize("H,KV,hd,what", [
    (18, 2, 128, "at most 8"), (16, 3, 128, "group"), (16, 8, 130, "hd="),
    (16, 8, 260, "hd="), (0, 1, 4, "empty")])
def test_decode_plan_refuses_what_the_kernel_does_not_take(H, KV, hd, what):
    with pytest.raises(ValueError, match=what):
        decode_attn.decode_plan(2, H, KV, hd, 40)


# -- masked_activation: a 2-D launch, one unit a thread ---------------------

MASK_DECODE = [(64, 2048), (64, 1024)]       # qwen3-1.7b, mamba2-370m


def _mask_columns(plan):
    """The units of a row the threads take, as the kernel indexes them:
    block bx, thread t takes unit bx * THREADS + t (past n: none)."""
    c = np.arange(plan["grid"][0] * plan["threads"])
    return c[c < plan["n"]]


def _mask_rows(plan, B):
    """The rows each launch's blocks along the rows take: launch i covers
    rows i * MAX_ROW_BLOCKS + by for by < its grid (the last launch's
    grid the rows left)."""
    gy = plan["grid"][1]
    assert gy == min(B, bm.MAX_ROW_BLOCKS)
    return [np.arange(r0, min(B, r0 + gy))
            for r0 in range(0, plan["launches"] * gy, gy)]


@pytest.mark.parametrize("B", [1, 6, 64, 8192, 32768])
@pytest.mark.parametrize("F", [37, 1024, 2048])
@pytest.mark.parametrize("aligned", [True, False])
def test_mask_plan_covers_every_element_once(B, F, aligned):
    """Each unit of a row is taken by one thread once, each row by one
    block along the rows once, and a unit is 4 floats on the 16-byte path
    (1 off it): every element is covered once, with no idle block."""
    plan = bm.mask_plan(B, F, aligned)
    assert plan["vec4"] == (F % 4 == 0 and aligned)
    assert plan["elems_per_thread"] == (4 if plan["vec4"] else 1)
    assert plan["n"] * plan["elems_per_thread"] == F
    assert np.array_equal(_mask_columns(plan), np.arange(plan["n"]))
    assert (plan["grid"][0] - 1) * plan["threads"] < plan["n"]
    rows = _mask_rows(plan, B)
    assert np.array_equal(np.concatenate(rows), np.arange(B))
    assert min(len(r) for r in rows) >= 1
    assert plan["launches"] == 1


def test_mask_plan_covers_small_shapes_exhaustively():
    """Every (row, element) of small shapes, enumerated from the grid as the
    kernel walks it, is covered exactly once."""
    for B in (1, 2, 3, 7):
        for F in (1, 3, 4, 5, 8, 37, 64):
            for aligned in (True, False):
                plan = bm.mask_plan(B, F, aligned)
                unit = plan["elems_per_thread"]
                got = sorted((int(b), int(c) * unit + e)
                             for rows in _mask_rows(plan, B) for b in rows
                             for c in _mask_columns(plan)
                             for e in range(unit))
                assert got == [(b, f) for b in range(B) for f in range(F)]


def test_mask_plan_launches_again_past_the_grid_limit():
    """One launch, one row a block along the rows, at the serving shapes
    (decode and prefill, both models); past gridDim.y's limit one launch
    for each MAX_ROW_BLOCKS rows, each row taken once."""
    for B, F in MASK_DECODE + [(8192, 2048), (32768, 1024)]:
        plan = bm.mask_plan(B, F)
        assert plan["grid"][1] == B and plan["launches"] == 1
    for B in (bm.MAX_ROW_BLOCKS, bm.MAX_ROW_BLOCKS + 1, 131072, 2 ** 20):
        plan = bm.mask_plan(B, 8)
        assert plan["launches"] == -(-B // bm.MAX_ROW_BLOCKS)
        rows = _mask_rows(plan, B)
        assert np.array_equal(np.concatenate(rows), np.arange(B))


@pytest.mark.parametrize("B,F", MASK_DECODE)
def test_mask_plan_stays_within_one_wave_at_decode(B, F):
    """At the decode shapes the launch is one wave, at most one block an
    SM, on the 16-byte path: nothing waits for a second wave."""
    plan = bm.mask_plan(B, F)
    gx, gy = plan["grid"]
    assert plan["vec4"] and gx * gy <= common.SMS and gy == B


def test_mask_plan_is_cached_by_shape():
    assert bm.mask_plan(64, 2048) is bm.mask_plan(64, 2048)
    assert bm.mask_plan(64, 2048, False) is not bm.mask_plan(64, 2048)


def test_mask_plan_refuses_what_the_launch_cannot_index():
    with pytest.raises(ValueError):
        bm.mask_plan(0, 8)
    with pytest.raises(ValueError):
        bm.mask_plan(4, 0)


def test_mask_plan_matches_the_cuda_source():
    """The plan's block and row-block limit are the source's kThreads and
    kMaxRowBlocks, and its grid the entry's; the entry takes the wrapper's
    arguments in order; one kernel template, on both paths, holds the name
    a profile matches."""
    src = (build.CSRC / "masked_activation.cu").read_text()
    assert re.search(rf"constexpr int kThreads = {bm.THREADS};", src)
    assert re.search(rf"constexpr int kMaxRowBlocks = {bm.MAX_ROW_BLOCKS};",
                     src)
    assert "((int64_t)n + kThreads - 1) / kThreads" in src
    assert "for (int r0 = 0; r0 < B; r0 += kMaxRowBlocks)" in src
    assert re.search(r"int B, int F, int vec4, uint32_t key,\s+"
                     r"uint32_t thr, float scale, int masked,\s+"
                     r"void\* stream\)", src)
    assert len(bm._ARGTYPES) == 11
    assert re.findall(r"masked_activation_kernel<T><<<", src)
    assert "launch_rows(reinterpret_cast<const float4*>(x)" in src
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", src)
    assert kernels == ["masked_activation_kernel",
                       "masked_activation_kernel_bf16"]


# -- mcd_lstm_step and mcd_gru_step: the warp path for H that divides 32 --

STEP_SHAPES = CLF_AE_LAYERS + [(40, 32), (3, 4), (5, 24), (128, 128),
                               (40, 1), (70, 2)]
# The step kernels: (gates, CUDA source).
STEP_CELLS = [pytest.param(4, "mcd_lstm_step.cu", id="lstm"),
              pytest.param(3, "mcd_gru_step.cu", id="gru")]


@pytest.mark.parametrize("gates,source", STEP_CELLS)
@pytest.mark.parametrize("B", [1, 5, 33, 1920])
@pytest.mark.parametrize("I,H", STEP_SHAPES)
def test_step_plan_covers_every_row_once(B, I, H, gates, source):
    plan = common.step_plan(gates, B, I, H)
    rows, blocks = plan["rows"], plan["blocks"]
    assert np.all(_coverage(B, rows, blocks) == 1)
    assert (blocks - 1) * rows < B
    if plan["path"] == "warp":
        # whole warps, 32 // H rows a warp, at most STEP_WARPS a block
        assert plan["threads"] % 32 == 0
        assert plan["threads"] <= 32 * common.STEP_WARPS
        assert rows == plan["threads"] // 32 * (32 // H)
        assert plan["smem"] == 0
    else:
        assert plan["threads"] == rows * H <= 1024
        assert rows == common.tile_rows(gates, I, H)
        assert 0 < plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("gates,source", STEP_CELLS)
@pytest.mark.parametrize("H", list(range(1, 41)))
def test_step_warp_path_iff_hidden_divides_32(H, gates, source):
    for I in (1, 8, 16, 40):
        for B in (1, 33, 1920):
            path = common.step_plan(gates, B, I, H)["path"]
            assert (path == "warp") == (32 % H == 0), (B, I, H)


@pytest.mark.parametrize("gates,source", STEP_CELLS)
def test_step_plan_of_the_ecg_layers(gates, source):
    """Every ECG layer (H = 8, 16) at 1920 rows takes the warp path with
    STEP_WARPS warps a block; the plan is cached by shape."""
    for I, H in CLF_AE_LAYERS:
        plan = common.step_plan(gates, 1920, I, H)
        assert plan["path"] == "warp"
        assert plan["threads"] == 32 * common.STEP_WARPS
        assert plan is common.step_plan(gates, 1920, I, H)


@pytest.mark.parametrize("gates,source", STEP_CELLS)
def test_step_plan_matches_the_cuda_source(gates, source):
    """The source's gate count is the plan's, the warp path's block limit
    is the source's kWarpMaxThreads, the warp kernels are instantiated for
    every H that divides 32 (by the fp32 launcher and by the bf16 one), the
    block path's shared memory is the source's block_smem_bytes, the entry
    takes the plan's rows and warp flag, and every path's kernels, fp32 and
    bf16 (``_q``), and the split path's, hold the name a profile
    matches."""
    src = (build.CSRC / source).read_text()
    stem = source.removesuffix(".cu")
    assert re.search(rf"constexpr int kGates = {gates};", src)
    assert re.search(rf"constexpr int kWarpMaxThreads = "
                     rf"{32 * common.STEP_WARPS};", src)
    assert re.findall(rf"{stem.upper()}_WARP\((\d+)\)\n", src) == [
        "1", "2", "4", "8", "16", "32"] * 2
    assert re.search(r"\(size_t\)R \* \(kGates \* \(I \+ H\) \+ I \+ H\)",
                     src)
    assert re.search(r"int B, int I, int H, int R, int warp,", src)
    for I, H in ((40, 24), (128, 128), (5, 24)):
        plan = common.step_plan(gates, 7, I, H)
        R = plan["rows"]
        assert plan["smem"] == 4 * R * (gates * (I + H) + I + H)
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", src)
    assert len(kernels) == 5                # and the split path's
    assert f"{stem}_kernel_split" in kernels
    assert all(f"{stem}_kernel" in k for k in kernels)


def _step_call(gates, B, I, H):
    """A step wrapper (``mcd_lstm_step`` for 4 gates, ``mcd_gru_step`` for
    3) and its arguments on CPU tensors."""
    g = torch.Generator().manual_seed(B + I + H)
    x, h, c = (torch.randn(B, d, generator=g) for d in (I, H, H))
    wx = torch.randn(I, gates, H, generator=g)
    wh = torch.randn(H, gates, H, generator=g)
    b = torch.randn(gates, H, generator=g)
    rows = torch.arange(B, dtype=torch.int64)
    mod = mcd_lstm if gates == 4 else mcd_gru
    keys = mod.gate_keys(3, 1)
    carry = (h, c) if gates == 4 else (h,)
    fn = mcd_lstm.mcd_lstm_step if gates == 4 else mcd_gru.mcd_gru_step
    return fn, (x, *carry, wx, wh, b, rows, keys, 0.125)


@pytest.mark.parametrize("gates,source", STEP_CELLS)
@pytest.mark.parametrize("B,I,H", [(1920, I, H) for I, H in CLF_AE_LAYERS]
                         + [(33, 40, 24)])
def test_step_wrapper_launches_the_plan(monkeypatch, B, I, H, gates,
                                        source):
    """The wrapper passes step_plan's rows and warp flag after (B, I, H),
    then the activation code (0: fp32): the entry's ``int B, int I, int H,
    int R, int warp, int act`` (the launch itself recorded here, not
    run)."""
    calls = []
    monkeypatch.setattr(common, "check_device", lambda name, t: False)
    monkeypatch.setattr(common, "launch",
                        lambda wrapper, tensors, ints, *rest: calls.append(
                            (wrapper, ints)))
    fn, args = _step_call(gates, B, I, H)
    fn(*args)
    plan = common.step_plan(gates, B, I, H)
    assert calls == [(fn, (B, I, H, plan["rows"],
                           int(plan["path"] == "warp"), 0))]
    assert plan["path"] == ("warp" if 32 % H == 0 else "block")


def test_step_plan_refuses_empty_steps():
    with pytest.raises(ValueError):
        common.step_plan(4, 0, 1, 8)


def test_keys_launch_argument_is_built_once_a_key_tuple():
    """The keys' ctypes argument is built once a key tuple (the step
    backends launch T times a layer with the same keys), and a tensor of
    the same keys gives the same argument; the wrapper takes the tuple and
    the plain version reads it as the tensor keys."""
    keys = mcd_lstm.gate_keys(3, 1)
    host = tuple(keys.reshape(-1).tolist())
    arg = common.keys_arg(host, 8)
    assert common.keys_arg(host, 8) is arg
    assert common.keys_arg(keys, 8) is arg
    assert list(arg) == common.key_list(keys, 8)
    with pytest.raises(ValueError):
        common.keys_arg(host[:6], 8)
    g = torch.Generator().manual_seed(0)
    B, I, H = 5, 3, 8
    x, h, c = (torch.randn(B, d, generator=g) for d in (I, H, H))
    wx, wh = torch.randn(I, 4, H, generator=g), torch.randn(H, 4, H,
                                                           generator=g)
    b = torch.randn(4, H, generator=g)
    rows = torch.arange(B, dtype=torch.int64)
    for u, v in zip(mcd_lstm.mcd_lstm_step(x, h, c, wx, wh, b, rows, host,
                                           0.125),
                    mcd_lstm.mcd_lstm_step(x, h, c, wx, wh, b, rows, keys,
                                           0.125)):
        assert torch.equal(u, v)


# -- the bf16 LM kernels: the fp32 designs with 16-bit elements --------------

def _c_params(src, entry):
    """The parameter count of ``entry``'s C signature in ``src``."""
    sig = re.search(rf"int {entry}\(([^)]*)\)", src)
    assert sig, entry
    return len(sig.group(1).split(","))


@pytest.mark.parametrize("B", [1, 64, 32768])
@pytest.mark.parametrize("F", [37, 1020, 1024, 2048])
@pytest.mark.parametrize("aligned", [True, False])
def test_mask_plan_bf16_covers_every_element_once(B, F, aligned):
    """At bf16 a 16-byte unit holds 8 elements (F % 8 == 0 and aligned),
    else one; every element is covered once; the serving shapes take the
    16-byte path."""
    plan = bm.mask_plan(B, F, aligned, 2)
    assert plan["vec4"] == (F % 8 == 0 and aligned)
    assert plan["elems_per_thread"] == (8 if plan["vec4"] else 1)
    assert plan["n"] * plan["elems_per_thread"] == F
    assert np.array_equal(_mask_columns(plan), np.arange(plan["n"]))
    rows = _mask_rows(plan, B)
    assert np.array_equal(np.concatenate(rows), np.arange(B))
    src = (build.CSRC / "masked_activation.cu").read_text()
    assert "masked_activation_kernel_bf16<T><<<" in src
    assert "launch_rows_bf16(reinterpret_cast<const uint4*>(x)" in src
    assert _c_params(src, "masked_activation_bf16_launch") == len(
        bm._ARGTYPES)


def test_matmul_bf16_tiles_match_the_cuda_source():
    """The bf16 entry launches the same CUDA-core tiles for the same ids
    (the bf16 path off the tensor cores: here operands not 16-byte
    aligned), and the plan's shared memory at 2 bytes an element is the
    source's TileBf16::kSmem: the ring of raw bf16 tiles and a word a
    thread, the fp32 transposed x tiles."""
    src = (build.CSRC / "mcd_matmul.cu").read_text()
    launched = dict(re.findall(
        r"if \(tile == (\d)\)\s*return launch_tile_bf16<([\d, ]+)>", src))
    assert len(launched) == len(mm.TILES)
    for name, (tid, bm_, bn, threads, bk, stages) in mm.TILES.items():
        BM, BN, TM, TN, _VN, BK, STAGES, _ = (
            int(v) for v in launched[str(tid)].split(","))
        assert (BM, BN, BK, STAGES) == (bm_, bn, bk, stages)
        plan = mm.matmul_plan(bm_ * 2 * common.SMS if name == "wide" else 1,
                              bn, bk, 2, aligned=False)
        assert plan["tile"] == name and plan["path"] == "cuda_cores"
        stage = 2 * (BM * BK + BK * BN) + 4 * threads
        assert plan["smem"] == STAGES * stage + 4 * 2 * BK * (BM + 4)
        assert plan["smem"] <= SMEM_LIMIT
    assert _c_params(src, "mcd_matmul_bf16_launch") == len(
        mm._ARGTYPES_BF16)


@pytest.mark.parametrize("B,H,KV,hd,S", [(64, 16, 8, 128, 160),
                                         (8, 16, 8, 128, 4096),
                                         (3, 8, 1, 64, 40),
                                         (64, 64, 8, 128, 160),
                                         (64, 32, 8, 128, 160)])
def test_decode_plan_bf16_matches_the_cuda_source(B, H, KV, hd, S):
    """The bf16 plan covers the tiles as the fp32 one (the same grid,
    splits and runs: the plan never depends on the dtype but for the ring's
    bytes), its shared memory is the source's smem_bytes_bf16, and the
    bf16 entry takes the fp32 entry's arguments."""
    f32 = decode_attn.decode_plan(B, H, KV, hd, S)
    bf = decode_attn.decode_plan(B, H, KV, hd, S, 2)
    assert {k: v for k, v in bf.items() if k != "smem"} == \
        {k: v for k, v in f32.items() if k != "smem"}
    assert bf["smem"] == 2 * 3 * 2 * 16 * hd + 4 * (H // KV) * hd
    src = (build.CSRC / "decode_attn.cu").read_text()
    assert re.search(r"kStages \* 2 \* kTS \* hd \* 2 \+ rep \* hd \* "
                     r"\(int\)sizeof\(float\)", src)
    assert _c_params(src, "decode_attention_bf16_launch") == len(
        decode_attn._ARGTYPES)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode_attn.decode_plan(B, H, KV, 68, S, 2)


def test_ssd_bf16_entry_takes_the_wrappers_arguments():
    """The bf16 entry: the fp32 entry's pointers, the four fp32 scratches,
    then the same ints and the stream."""
    src = (build.CSRC / "ssd_chunk.cu").read_text()
    assert _c_params(src, "ssd_chunk_scan_launch") == len(
        ssd_chunk._ARGTYPES)
    assert _c_params(src, "ssd_chunk_scan_bf16_launch") == len(
        ssd_chunk._ARGTYPES_BF16) == len(ssd_chunk._ARGTYPES) + 4


# -- the bf16 product on the tensor cores -------------------------------------

# qwen3-1.7b's, llama3-8b's and jamba-1.5-large's (mamba.mlp) SwiGLU
# gate/up products, decode and prefill
TC_SERVING = [(64, 12288, 2048), (8192, 12288, 2048),
              (64, 28672, 4096), (8192, 28672, 4096),
              (64, 49152, 8192), (8192, 49152, 8192)]


@pytest.mark.parametrize("M,N,K", TC_SERVING)
def test_matmul_plan_bf16_serving_shapes_take_the_tensor_cores(M, N, K):
    """The serving shapes take the tensor cores: the 64 x 96 tile in one
    wave at decode, the 128 x 256 one at least twice over the SMs at
    prefill; the keep-bit rows padded to 4 words."""
    plan = mm.matmul_plan(M, N, K, 2)
    assert plan["path"] == "tensor_cores"
    assert plan["tile"] == ("tc_narrow" if M == 64 else "tc_wide")
    if M == 64 and N == 12288:
        assert plan["blocks"] == 128 <= common.SMS
    if M == 8192:
        assert plan["blocks"] >= 2 * common.SMS
    assert plan["scratch_words"] == M * -(-(-(-K // 32)) // 4) * 4
    assert 0 < plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("M,N,K,aligned", [
    (64, 12288, 2050, True), (64, 12290, 2048, True), (65, 12290, 2050, True),
    (8192, 12284, 2048, True), (8192, 12290, 2050, True), (5, 70, 37, True),
    (64, 12288, 2048, False), (8192, 12288, 2048, False)])
def test_matmul_plan_bf16_off_the_tensor_cores(M, N, K, aligned):
    """K or N not a multiple of 8, or an operand not 16-byte aligned: the
    CUDA-core bf16 tiles, as before (a prefill on the wide one)."""
    plan = mm.matmul_plan(M, N, K, 2, aligned)
    assert plan["path"] == "cuda_cores"
    assert plan["tile"] == ("wide" if M == 8192 else "narrow")
    assert "blocks" not in plan
    assert plan["scratch_words"] == M * -(-K // 32)


def _tc_tile_of(block, mb, nb):
    """The (row block, column block) block ``block`` of the tensor-core
    kernel's 1-D grid computes, as ``mcd_matmul_kernel_bf16_tc`` walks
    them: groups of TC_GROUP_M row blocks, rows fastest in a group."""
    group, within = divmod(block, mm.TC_GROUP_M * nb)
    rows_in = min(mb - group * mm.TC_GROUP_M, mm.TC_GROUP_M)
    return group * mm.TC_GROUP_M + within % rows_in, within // rows_in


@pytest.mark.parametrize("M,N,K", [(1, 8, 8), (63, 1000, 2056),
                                   (65, 256, 64), (130, 12288, 64),
                                   (2048, 4352, 64), (8200, 1000, 2048)]
                         + TC_SERVING)
def test_matmul_tc_grid_covers_every_output_once(M, N, K):
    """The 1-D grid, walked in groups of TC_GROUP_M row blocks as the
    kernel does, computes every output tile exactly once."""
    plan = mm.matmul_plan(M, N, K, 2)
    assert plan["path"] == "tensor_cores"
    bm, bn = plan["block"]
    nb, mb = plan["grid"]
    assert plan["blocks"] == mb * nb
    assert (mb - 1) * bm < M <= mb * bm and (nb - 1) * bn < N <= nb * bn
    hits = np.zeros((mb, nb), dtype=np.int64)
    for b in range(plan["blocks"]):
        hits[_tc_tile_of(b, mb, nb)] += 1
    assert np.all(hits == 1)
    assert 0 < plan["smem"] <= SMEM_LIMIT


def test_matmul_tc_tiles_match_the_cuda_source():
    """Each TC_TILES entry is the template the bf16 entry launches for its
    id (warpgroups, columns, stages, W swizzle), the plan's threads and
    shared memory are TileTc's kThreads and kSmem, the raster group is the
    source's kGroupM, and the entry takes the wrapper's arguments."""
    src = (build.CSRC / "mcd_matmul.cu").read_text()
    launched = dict(re.findall(
        r"if \(tile == (\d)\)\s*return launch_tile_tc<([\d, ]+)>", src))
    assert len(launched) == len(mm.TC_TILES)
    for name, (tid, bm, bn, threads, bk, stages, swb) in mm.TC_TILES.items():
        WG, BN, STAGES, SWB = (int(v) for v in launched[str(tid)].split(","))
        assert (64 * WG, BN, STAGES, SWB) == (bm, bn, stages, swb)
        assert threads == 128 * WG + 32 and bk == 64
        plan = mm.matmul_plan(*((8192, 12288) if name == "tc_wide"
                                else (64, BN)), bk, 2)
        assert plan["tile"] == name and plan["tile_id"] == tid
        stage = -(-(2 * bm * bk + 2 * bk * BN + 16 * bm) // 1024) * 1024
        assert plan["smem"] == 1024 + STAGES * stage + 16 * STAGES
    assert re.search(r"kThreads = 128 \* WG \+ 32;", src)
    assert re.search(r"kStage = \(kX \+ kW \+ kBits \+ 1023\) / 1024 \* "
                     r"1024;", src)
    assert re.search(r"kSmem = 1024 \+ \(size_t\)STAGES \* kStage \+ "
                     r"16 \* STAGES;", src)
    assert re.search(rf"constexpr int kGroupM = {mm.TC_GROUP_M};", src)
    assert _c_params(src, "mcd_matmul_bf16_launch") == len(
        mm._ARGTYPES_BF16)


def _matmul_plan_before(M, N, K, elem_bytes=4):
    """``matmul_plan`` as it was before the tensor-core path (the CUDA-core
    tiles alone), for the fp32 check below."""
    wide = mm.TILES["wide"]
    wide_blocks = -(-M // wide[1]) * -(-N // wide[2])
    name = "wide" if wide_blocks >= 2 * common.SMS else "narrow"
    tile, bm, bn, threads, bk, stages = mm.TILES[name]
    grid = (-(-N // bn), -(-M // bm))
    smem = (stages * (elem_bytes * (bm * bk + bk * bn) + 4 * threads)
            + 4 * 2 * bk * (bm + 4))
    return {"tile": name, "tile_id": tile, "block": (bm, bn),
            "threads": threads, "grid": grid, "smem": smem,
            "scratch_words": M * -(-K // 32)}


@pytest.mark.parametrize("M,N,K", [(1, 1, 1), (64, 12288, 2048),
                                   (8192, 12288, 2048), (65, 12290, 2050),
                                   (64, 28672, 4096), (4100, 1001, 37)])
@pytest.mark.parametrize("aligned", [True, False])
def test_matmul_plan_fp32_is_unchanged(M, N, K, aligned):
    """fp32 never takes the tensor cores: its plan is the one it was, with
    ``path`` "cuda_cores" beside it, whatever the alignment."""
    plan = mm.matmul_plan(M, N, K, 4, aligned)
    assert plan.pop("path") == "cuda_cores"
    assert plan == _matmul_plan_before(M, N, K)


# -- the zoo's shapes: llama3-8b and the jamba-1.5-large cut ------------------

JAMBA_SSD = (64, 128, 256, 64, 128, 256)   # 8 x 8 rows, a 128-token prompt


@pytest.mark.parametrize("H", [64, 32], ids=["jamba", "llama3"])
def test_decode_plan_at_the_zoo_shapes(H):
    """jamba's 64 q heads to 8 KV heads are the kernel's largest group
    (``_MAX_REP``, the source's kMaxRep) and llama3-8b's 32 to 8 half of
    it: 512 (row, KV head) blocks, one split of the 160-position cache,
    the bf16 ring plus the group's fp32 outputs in shared memory, several
    blocks an SM; a group past kMaxRep is refused."""
    consts, _ = _attn_source()
    rep = H // 8
    assert (rep == consts["kMaxRep"]) == (H == 64)
    plan = decode_attn.decode_plan(64, H, 8, 128, 160, 2)
    assert plan["grid"] == (512, 1) and plan["splits"] == 1
    assert plan["smem"] == 2 * consts["kStages"] * 2 * consts["kTS"] * 128 \
        + 4 * rep * 128
    assert 4 * plan["smem"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match="at most 8"):
        decode_attn.decode_plan(64, 8 * (consts["kMaxRep"] + 1), 8, 128,
                                160, 2)


def test_ssd_tensor_core_plan_at_the_jamba_prefill():
    """256 heads at a 128-token prompt: Q = 128 (the whole prompt, one
    chunk of the configured 256), 16384 blocks of one an SM in the
    source's kTcSmem; per (b, h) 3 causal tile pairs x (8 + 4 x 3) and the
    state update's 2 x 2 x 4 x 2 m64n64k16 products, no inter term."""
    plan = ssd_chunk.ssd_plan(*JAMBA_SSD, 2)
    assert plan["path"] == "tensor_cores" and plan["Q"] == 128
    assert plan["chunks"] == 1 and plan["tiles"] == 2
    assert plan["blocks"] == 64 * 256 and plan["blocks_per_sm"] == 1
    assert plan["smem"] == ssd_chunk._TC_SMEM <= SMEM_LIMIT
    assert plan["wgmma_flop"] == 64 * 256 * (3 * 20 + 2 * 2 * 4 * 2) \
        * 2 * 64 * 64 * 16
    fp32 = ssd_chunk.ssd_plan(*JAMBA_SSD)
    assert fp32["Q"] == 128 and fp32["blocks"] == plan["blocks"]


@pytest.mark.parametrize("M,N,K", [(64, 49152, 8192), (64, 28672, 4096)],
                         ids=["jamba", "llama3"])
def test_matmul_tc_plan_at_the_zoo_decode(M, N, K):
    """The decode products take the narrow tensor-core tile: a block of
    96 columns each (ceil(N / 96) blocks, one an SM: its shared memory is
    over half the SM's), the keep bits of K = 8192 / 4096 padded to 4
    words a row."""
    plan = mm.matmul_plan(M, N, K, 2)
    assert (plan["path"], plan["tile"], plan["block"]) == (
        "tensor_cores", "tc_narrow", (64, 96))
    assert plan["blocks"] == -(-N // 96) and plan["grid"] == (-(-N // 96), 1)
    assert SMEM_LIMIT // 2 < plan["smem"] <= SMEM_LIMIT
    assert plan["scratch_words"] == M * K // 32


# -- the wide path: the cluster split of H and the step kernels' slices -----

WIDE_SEQ_SOURCES = [pytest.param(4, "mcd_lstm_seq.cu", id="lstm"),
                    pytest.param(3, "mcd_gru_seq.cu", id="gru")]
# (I, H): the served classifier's layers, a ragged last slice, the top of
# H, the two inputs the block path refuses, the extremes of the range.
WIDE_SHAPES = [(1, 2048), (2048, 2048), (64, 1100), (512, 8192),
               (20000, 8), (60000, 24), (1, 1025), (3, 1100), (1, 16384),
               (65536, 16384), (65536, 1), (8192, 1024), (65536, 256)]


def _wide_cu_constants():
    src = (build.CSRC / "mcd_wide.cuh").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_wide_plan_matches_the_header():
    """The plan's constants are mcd_wide.cuh's: the chunk, the rows a
    thread, the threads a block and the blocks a cluster; H up to 16384
    takes one unit a thread."""
    k = _wide_cu_constants()
    assert k["kWideChunk"] == common.WIDE_CHUNK
    assert k["kWideRowsThread"] == common.WIDE_ROWS_THREAD
    assert k["kWideThreads"] == common.WIDE_THREADS
    assert k["kClusterMax"] == common.CLUSTER_MAX
    assert common.WIDE_H_MAX == 16384


@pytest.mark.parametrize("gates,source", WIDE_SEQ_SOURCES)
def test_cluster_entry_matches_the_plan(gates, source):
    """The sequence source's cluster kernel (one template, named as the
    profile matches), its shared memory (pub [R][G][units] and the chunk
    [R][G][kWideChunk] floats, the plan's ``smem``), its entry's plan
    arguments after (B, T, I, H), and every precision the block path
    takes, fp32 included."""
    src = (build.CSRC / source).read_text()
    stem = source.removesuffix(".cu")
    assert re.findall(r"__global__ void __launch_bounds__\(mcd::kWideThreads\)"
                      r"\s+(\w+)\(", src) == [f"{stem}_kernel_cluster"]
    assert ("(size_t)R * kGates * (units + mcd::kWideChunk) * sizeof(float)"
            in src)
    args = r",\s+".join(f"int {a}" for a in (
        "B", "T", "I", "H", "R", "C", "units", "smem_bytes", "act", "wbits"))
    assert re.search(rf"int {stem}_cluster_launch\([^)]*{args},", src)
    for act, bits in ((0, 32), (1, 16), (1, 8), (1, 4)):
        assert f"act == {act} && wbits == {bits}) MCD_" \
               f"{'LSTM' if gates == 4 else 'GRU'}_CLUSTER" in src
    plan = common.seq_plan(gates, 64, 2048, 2048)
    R, U = plan["rows"], plan["units"]
    assert plan["smem"] == R * gates * (U + common.WIDE_CHUNK) * 4


@pytest.mark.parametrize("gates,source", STEP_CELLS)
def test_split_entry_matches_the_plan(gates, source):
    """The step source's split entry takes (B, I, H, R, slices, units,
    act) and sizes the chunk [R][G][kWideChunk] floats, the plan's
    ``smem``."""
    src = (build.CSRC / source).read_text()
    stem = source.removesuffix(".cu")
    args = r",\s+".join(f"int {a}" for a in (
        "B", "I", "H", "R", "slices", "units", "act"))
    assert re.search(rf"int {stem}_split_launch\([^)]*{args},", src)
    assert "(size_t)R * kGates * mcd::kWideChunk * sizeof(float)" in src
    plan = common.step_plan(gates, 64, 2048, 2048)
    assert plan["path"] == "split"
    assert plan["smem"] == plan["rows"] * gates * common.WIDE_CHUNK * 4


@pytest.mark.parametrize("path", ["cluster", "split"])
@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("B", [1, 3, 33, 64, 1920])
@pytest.mark.parametrize("I,H", WIDE_SHAPES)
def test_wide_plan_covers_every_row_and_unit_once(I, H, B, gates, path):
    """Every (row, unit) is one thread's: tiles of ``rows`` rows
    (WIDE_ROWS_THREAD a thread), slices of ``units`` units (one a thread,
    none empty, the last ragged), ``threads`` = units x row groups <=
    1024, at most CLUSTER_MAX blocks a cluster, ``blocks`` = tiles x
    slices, shared memory within the H100's 227 KB."""
    plan = common.wide_plan(gates, B, I, H, path)
    R, C, U = plan["rows"], plan["cluster"], plan["units"]
    groups = R // common.WIDE_ROWS_THREAD
    assert R % common.WIDE_ROWS_THREAD == 0
    assert plan["threads"] == U * groups <= common.WIDE_THREADS
    assert (plan["thread_units"], plan["thread_rows"]) == (
        1, common.WIDE_ROWS_THREAD)
    assert 1 <= C <= common.CLUSTER_MAX
    assert np.all(_coverage(H, U, C) == 1)
    tiles = plan["blocks"] // C
    assert plan["blocks"] == tiles * C
    assert np.all(_coverage(B, R, tiles) == 1) and (tiles - 1) * R < B
    assert R <= 2 * max(B, 1) or groups == 1   # no idle row group past B
    pub = U if path == "cluster" else 0
    assert plan["smem"] == 4 * R * gates * (pub + common.WIDE_CHUNK)
    assert 0 < plan["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("gates", [4, 3])
def test_wide_plans_refuse_no_layer_up_to_16384(gates):
    """seq_plan and step_plan (at every activation width) refuse no layer
    with H <= 16384 and I <= 65536; H above 16384 raises, naming
    ROADMAP.md."""
    Hs = sorted({*range(1, 1100, 37), *range(1000, 16385, 331), 1024, 1025,
                 2048, 8192, 16383, 16384})
    for H in Hs:
        for I in (1, 7, 4096, 20000, 65536):
            for B in (1, 64):
                for act_bytes in (4, 2):
                    plan = common.seq_plan(gates, B, I, H, act_bytes)
                    assert plan["path"] in ("warp", "block", "cluster")
                    assert plan["smem"] <= SMEM_LIMIT
                step = common.step_plan(gates, B, I, H)
                assert step["path"] in ("warp", "block", "split")
                for wide in (plan, step):
                    if wide["path"] in ("cluster", "split"):
                        assert np.all(_coverage(H, wide["units"],
                                                wide["cluster"]) == 1)
                if H > common.BLOCK_H_MAX:
                    assert (plan["path"], step["path"]) == ("cluster",
                                                            "split")
    for fn in (lambda: common.seq_plan(gates, 4, 8, 16385),
               lambda: common.step_plan(gates, 4, 8, 16385)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn()


@pytest.mark.parametrize("gates", [4, 3])
def test_wide_path_takes_only_what_the_block_path_refuses(gates):
    """Nothing the warp or block path took moves: a layer takes the wide
    path exactly where the warp path does not take it and the block path's
    own rule (``tile_rows``) refuses it; the block path's plans are the
    rows ``tile_rows`` gives."""
    for H in (*range(1, 130, 3), 255, 256, 512, 1000, 1023, 1024):
        for I in (1, 8, 16, 128, 1024, 2048, 4096, 8192, 16384):
            for B in (1, 33, 1920):
                seq = common.seq_plan(gates, B, I, H)
                step = common.step_plan(gates, B, I, H)
                try:
                    rows = common.tile_rows(gates, I, H)
                except NotImplementedError:
                    rows = None
                for plan, wide in ((seq, "cluster"), (step, "split")):
                    if plan["path"] == "block":
                        assert plan["rows"] == rows
                    elif plan["path"] == wide:
                        assert rows is None
                    else:
                        assert plan["path"] == "warp" and 32 % H == 0


@pytest.mark.parametrize("gates", [4, 3])
@pytest.mark.parametrize("precision,act,bits", [
    ("fp32", 0, 32), ("bf16", 1, 16), ("int8", 1, 8), ("int4", 1, 4)])
def test_seq_wrapper_launches_the_cluster_plan(monkeypatch, gates,
                                               precision, act, bits):
    """At a wide H the sequence wrapper launches the ``cluster`` entry with
    (B, T, I, H) and the plan's rows, cluster, units and shared memory,
    then the activation code and the weight bits."""
    calls = []
    monkeypatch.setattr(common, "check_device", lambda name, t: False)
    monkeypatch.setattr(
        common, "launch",
        lambda wrapper, tensors, ints, keys, n, p, what, act_dtype,
        variant="": calls.append((wrapper, ints, variant)))
    fn, args, kw, _ = _seq_call(gates, precision, B=5, T=2, I=3, H=1100)
    fn(*args, **kw)
    (wrapper, ints, variant), = calls
    plan = common.seq_plan(gates, 5, 3, 1100, 4 if act == 0 else 2)
    assert wrapper is fn and variant == "cluster"
    assert ints == (5, 2, 3, 1100, plan["rows"], plan["cluster"],
                    plan["units"], plan["smem"], act, bits)


@pytest.mark.parametrize("gates,source", STEP_CELLS)
@pytest.mark.parametrize("B,I,H", [(33, 64, 1100), (3, 20000, 24),
                                   (64, 1, 2048)])
def test_step_wrapper_launches_the_split_plan(monkeypatch, B, I, H, gates,
                                              source):
    """At a layer the block path refuses the step wrapper launches the
    ``split`` entry with (B, I, H) and the plan's rows, slices and units,
    then the activation code."""
    calls = []
    monkeypatch.setattr(common, "check_device", lambda name, t: False)
    monkeypatch.setattr(
        common, "launch",
        lambda wrapper, tensors, ints, *rest, variant="": calls.append(
            (wrapper, ints, variant)))
    fn, args = _step_call(gates, B, I, H)
    fn(*args)
    plan = common.step_plan(gates, B, I, H)
    assert calls == [(fn, (B, I, H, plan["rows"], plan["cluster"],
                           plan["units"], 0), "split")]
