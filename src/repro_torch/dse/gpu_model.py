"""GPU-side analytic performance model of the recurrent stack — the
roofline that replaces DSPs / II on an NVIDIA H100.

The port's counterpart of the recurrent half of ``repro.dse.tpu_model``
(``rnn_step_model`` and ``rnn_latency_s``): the same per-gate flop and byte
counts, term for term, priced at one H100 SXM's peaks instead.  The
reference's LM half (``TpuHwConfig``, ``step_model``, ``memory_model``,
``search_hw``), which models pod meshes and needs
``launch.analysis.active_params``, is not ported (ROADMAP A9).

The peaks are module attributes, so a caller (or a test) may set others.
"""

from __future__ import annotations

from repro_torch.dse.fpga_model import RNNArch

#: Peak fp32 rate of one H100 SXM on its CUDA cores (NVIDIA H100 data
#: sheet, dense, 700 W): the recurrent kernels compute in fp32 at every
#: serving precision (bf16 / int8 / int4 operands are widened in the
#: kernel), so the fp32 CUDA-core rate is their compute roof.
PEAK_FLOPS = 67e12
#: HBM3 bandwidth of one H100 SXM 80 GB (NVIDIA H100 data sheet), bytes/s.
HBM_BW = 3.35e12


def rnn_step_model(arch: RNNArch, *, batch: float = 1, n_samples: float = 1,
                   data: int = 1, dtype_bytes: int = 2) -> dict:
    """Roofline terms for the paper's recurrent stack (both cells).

    Per-gate flop and byte counts (``arch.gates`` — 4 for LSTM, 3 for GRU,
    so the GRU row prices at 3/4 of the LSTM datapath exactly as in
    ``fpga_model.dsp_usage``), with ``batch × n_samples`` MC-chain rows
    split ``data`` ways.  ``batch`` and ``n_samples`` may be fractional:
    under early-exit serving the controller prices *expected* active
    chains (ceiling × survival ratio), and a roofline is smooth in the row
    dimension.

    Weight bytes are charged **once per launch**, not per timestep — the
    sequence kernel keeps its weights resident for the whole launch;
    activations stream per step.

    ``arch.weight_bits`` prices the quantized serving path: ``wx``/``wh``
    store at ``weight_bits/8`` bytes per element plus the fp32 per-channel
    scale rows (2 × G × H × 4, charged only below 16 bits — bf16 carries no
    scales), while the bias and activations stay at ``dtype_bytes``.

    The autoencoder's T is not doubled: ``layer_dims()`` already spans
    encoder and decoder, and the paper's ×2 is a latency-serialization
    fact (the decoder waits for the encoder), not extra work.
    """
    g = float(arch.gates)
    rows = max(batch * n_samples / max(data, 1), 1.0)
    _ = arch.dsp_per_mac                  # validates weight_bits
    w_byte = arch.weight_bits / 8.0
    flops_step = 0.0          # per row per timestep
    weight_bytes = 0.0        # resident per launch, per device
    act_bytes_step = 0.0      # streamed per row per timestep
    for (i_dim, h_dim) in arch.layer_dims():
        flops_step += 2.0 * g * (i_dim * h_dim + h_dim * h_dim)
        flops_step += 12.0 * h_dim                     # elementwise tail
        weight_bytes += g * (i_dim + h_dim) * h_dim * w_byte
        weight_bytes += g * h_dim * dtype_bytes        # bias row
        if arch.weight_bits < 16:
            weight_bytes += 2 * g * h_dim * 4          # fp32 scales (wx, wh)
        act_bytes_step += (i_dim + h_dim) * dtype_bytes
    h_last = arch.layer_dims()[-1][1]
    head_mult = arch.timesteps if arch.kind == "autoencoder" else 1
    flops_head = 2.0 * h_last * arch.output_dim * head_mult
    t_steps = arch.timesteps
    flops = rows * (t_steps * flops_step + flops_head)
    bytes_hbm = weight_bytes + rows * t_steps * act_bytes_step
    return {"flops": flops, "bytes": bytes_hbm, "coll": 0.0,
            "t_compute": flops / PEAK_FLOPS, "t_memory": bytes_hbm / HBM_BW,
            "t_collective": 0.0,
            "t_step": max(flops / PEAK_FLOPS, bytes_hbm / HBM_BW)}


def rnn_latency_s(arch: RNNArch, hw=None, batch: int = 1,
                  n_samples: int = 1, *, data: int = 1) -> float:
    """GPU latency estimate with the FPGA model's call signature.

    Drop-in ``latency_model=`` for :func:`repro_torch.dse.search.optimize`
    — pass ``hw_model=None`` alongside it, or GPU-sized archs (H far past
    the ZC706's 900 DSPs) are rejected by the default FPGA reuse-factor
    gate before this model ever prices them.  ``hw`` (the FPGA reuse
    factors, or None when the gate is off) is ignored; GRU rows price at
    their 3-gate cost.
    """
    del hw
    return rnn_step_model(arch, batch=batch, n_samples=n_samples,
                          data=data)["t_step"]
