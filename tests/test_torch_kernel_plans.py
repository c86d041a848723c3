"""The host-side plans of the two redesigned kernels, on the CPU.

``mcd_matmul.matmul_plan`` picks the product's tile, grid, shared memory
and keep-bit scratch; ``mcd_gru_seq.gru_seq_plan`` picks the GRU layer's
path (warp or block), rows a block, threads and shared memory.  The
kernels run only on the card; what they are launched with is checked here:
every output and every row covered exactly once, the warp path taken for
H that divides 32, shared memory within the H100's 227 KB, the plans in
step with the constants of the CUDA sources, and unsupported shapes
refused with a pointer to ROADMAP.md.  No JAX.
"""

import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels import mcd_gru_seq as gseq  # noqa: E402
from repro_torch.kernels import mcd_matmul as mm  # noqa: E402

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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gseq.gru_seq_plan(4, I, H)
