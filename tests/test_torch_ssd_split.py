"""The bf16 pieces of the tensor-core SSD scan, witnessed on the CPU.

``ssd_chunk_scan_kernel_bf16_tc`` (``csrc/ssd_chunk.cu``) takes x, B and C
in bf16, which the tensor cores multiply exactly, but three of its
products have an fp32 operand that is not a bf16 value: the intra term's
weights G'[q, k] = (C_q . B_k) exp(cs_q - cs_k) dt_k against x, the carried
state against C, and the state update's B'[k, n] = B[k, n] dt_k
exp(cs_end - cs_k) against x.  The kernel carries each as an unevaluated
sum of bf16 pieces (``ssd_chunk._PIECES``: hi = bf16(v), mid = bf16(v -
hi), lo = bf16(v - hi - mid)), one product a piece.

Here the scan is emulated in plain PyTorch with the kernel's fp32 roundings
(the in-order cumsum, the decays, G', B', the state) and each of the three
products' fp32 operand cut into 1, 2 or 3 pieces, the bf16 operand exact
and every product's sum in float64.  At the serving shape's Q, P and N and
``chip_smoke.ssd_inputs``' value scales (a = -linspace(1, 16, H), dt from
softplus with the init's dt_bias, x unit, B and C at 0.3), with B and H
reduced, it shows:

* the pieces sum back to their operand exactly at three pieces, and to
  within 2^-16 of it at two;
* one piece (each operand rounded to bf16 once) moves y more than SSD_TOL
  from the float64 sums of the same fp32 operands;
* the kernel's piece counts stay within SSD_TOL / 4 of them, and no
  farther from the float64 scan than the plain fp32 version, +25%.

No JAX, no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_chunk  # noqa: E402

SSD_TOL = 1e-4          # chip_smoke.SSD_TOL: the scan against its plain
                        # version on the card
B, L, H, P, N, Q = 2, 512, 4, 64, 128, 256     # two chunks: the state carried
F32, F64 = torch.float32, torch.float64


def _bf16(v):
    return torch.as_tensor(v, dtype=F32).bfloat16().float()


def make_inputs():
    rng = np.random.default_rng(25)
    dt_bias = np.log(np.expm1(np.linspace(1e-3, 0.1, H)))
    dt = torch.nn.functional.softplus(
        torch.as_tensor(rng.standard_normal((B, L, H)) + dt_bias, dtype=F32))
    a = -torch.linspace(1.0, 16.0, H)
    x = _bf16(rng.standard_normal((B, L, H, P)))
    bm = _bf16(rng.standard_normal((B, L, N)) * 0.3)
    cm = _bf16(rng.standard_normal((B, L, N)) * 0.3)
    return x, dt, a, bm, cm, torch.ones(H)


def pieces(v, n):
    """v (fp32) as n bf16 pieces, hi first, each rounding what the ones
    before it leave; the kernel's ``split``."""
    out, r = [], v.clone()
    for _ in range(n):
        p = r.bfloat16().float()
        out.append(p)
        r = r - p
    return out


def emulate(ins, counts=None, operands=None):
    """The tensor-core kernel's scan: fp32 operands, each of the three
    products over ``counts[name]`` bf16 pieces of its fp32 operand (None:
    the operand whole), its sum in float64 and rounded to fp32 where the
    kernel's accumulators are.  ``operands`` collects G', B' and the state
    as the products see them."""
    x, dt, a, bm, cm, d = ins
    split = {k: (lambda v, k=k: [v] if counts is None
                 else pieces(v, counts[k])) for k in ("G", "S", "B")}
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    state = torch.zeros((B, H, P, N), dtype=F32)
    ys = []
    for c0 in range(0, L, Q):
        xc, dtc = x[:, c0:c0 + Q].double(), dt[:, c0:c0 + Q]
        bc, cc = bm[:, c0:c0 + Q], cm[:, c0:c0 + Q]
        # the cumsum kernel: in order, in fp32
        cs = torch.from_numpy(np.cumsum((dtc * a).numpy(), axis=1,
                                        dtype=np.float32))
        s = torch.einsum("bqn,bkn->bqk", cc.double(), bc.double()).float()
        decay = torch.exp(torch.where(
            tri[None, :, :, None], cs[:, :, None, :] - cs[:, None, :, :],
            torch.zeros(())))
        g = torch.where(tri[None, :, :, None],
                        (s[..., None] * decay) * dtc[:, None, :, :],
                        torch.zeros(()))
        intra = sum(torch.einsum("bqkh,bkhp->bqhp", gp.double(), xc)
                    for gp in split["G"](g))
        inter = sum(torch.einsum("bqn,bhpn->bqhp", cc.double(), sp.double())
                    for sp in split["S"](state)).float()
        y = (inter * torch.exp(cs)[..., None]).double() + intra
        ys.append((y.float() + d[None, None, :, None] * xc.float()))
        w = dtc * torch.exp(cs[:, -1:, :] - cs)
        bw = bc[:, :, None, :] * w[..., None]                # B' [B, Q, H, N]
        ds = sum(torch.einsum("bkhn,bkhp->bhpn", bp.double(), xc)
                 for bp in split["B"](bw)).float()
        if operands is not None:
            operands["G"].append(g)
            operands["S"].append(state)
            operands["B"].append(bw)
        state = state * torch.exp(cs[:, -1])[..., None, None] + ds
    return torch.cat(ys, dim=1), state


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def make_scans(inputs):
    """The emulations (operands whole, one piece, the kernel's counts), the
    plain fp32 version and the float64 scan."""
    ops = {"G": [], "S": [], "B": []}
    whole = emulate(inputs, operands=ops)
    one = emulate(inputs, {"G": 1, "S": 1, "B": 1})
    kernel = emulate(inputs, ssd_chunk._PIECES)
    plain = ssd_chunk.ssd_chunk_scan_plain(*inputs)
    f64 = ssd_chunk.ssd_chunk_scan_plain(*(t.double() for t in inputs))
    return dict(whole=whole, one=one, kernel=kernel, plain=plain, f64=f64,
                operands=ops)


@pytest.fixture(scope="module")
def scans(inputs):
    return make_scans(inputs)


def _dist(u, v):
    return max((a.double() - b.double()).abs().max().item()
               for a, b in zip(u, v))


@pytest.mark.parametrize("name", ["G", "S", "B"])
def test_pieces_sum_back_to_the_fp32_operand(scans, name):
    """Three pieces hold an fp32 operand exactly (each difference is exact
    in fp32 and the last piece holds the 8 bits left); two leave at most
    2^-16 of it (the first two pieces' 16 bits, less one for the rounding
    to nearest)."""
    v = torch.cat([t.flatten() for t in scans["operands"][name]])
    v = v[v.abs() > 2.0 ** -100]          # bf16 pieces stay normal
    assert v.numel() > 1000
    three = sum(p.double() for p in pieces(v, 3))
    assert torch.equal(three, v.double())
    two = sum(p.double() for p in pieces(v, 2))
    assert ((two - v.double()).abs() <= 2.0 ** -16 * v.double().abs()).all()
    assert not torch.equal(two, v.double())


def test_one_piece_is_farther_than_ssd_tol(scans):
    """Rounding each fp32 operand to bf16 once moves y by far more than
    SSD_TOL: the design cannot take plain bf16 operands."""
    assert _dist(scans["one"][:1], scans["whole"][:1]) > 10 * SSD_TOL


def test_the_kernels_piece_counts_hold_a_quarter_of_ssd_tol(scans):
    assert ssd_chunk._PIECES == {"G": 3, "S": 2, "B": 2}
    assert _dist(scans["kernel"], scans["whole"]) <= SSD_TOL / 4


def test_no_farther_from_float64_than_the_plain_version(scans):
    """The emulated kernel against the float64 scan, y and the state, each
    no farther than the plain fp32 version is, +25% (chip_smoke's gate on
    the card)."""
    for i in (0, 1):
        k = _dist(scans["kernel"][i:i + 1], scans["f64"][i:i + 1])
        p = _dist(scans["plain"][i:i + 1], scans["f64"][i:i + 1])
        assert k <= 1.25 * p, (i, k, p)


if __name__ == "__main__":
    # The distances the tests hold: python tests/test_torch_ssd_split.py
    got = make_scans(make_inputs())
    two = emulate(make_inputs(), {"G": 2, "S": 2, "B": 2})
    for name, scan in (("one piece", got["one"]), ("two pieces", two),
                       ("the kernel's pieces", got["kernel"])):
        print(f"{name}: y {_dist(scan[:1], got['whole'][:1]):.3g}, state "
              f"{_dist(scan[1:], got['whole'][1:]):.3g} from the float64 "
              f"sums of the fp32 operands")
    for name in ("kernel", "plain"):
        print(f"{name} vs the float64 scan: y "
              f"{_dist(got[name][:1], got['f64'][:1]):.3g}, state "
              f"{_dist(got[name][1:], got['f64'][1:]):.3g}")
