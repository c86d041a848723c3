"""GPU-side analytic performance model — the roofline that replaces DSPs /
II on an NVIDIA H100.

The port's counterpart of ``repro.dse.tpu_model``, both halves, with the
same flop, byte and collective counts, term for term, priced at one H100
SXM's peaks instead of a TPU's:

* the recurrent half (``rnn_step_model``, ``rnn_latency_s``) at the fp32
  CUDA-core rate :data:`PEAK_FLOPS` (the recurrent kernels compute in
  fp32) and :data:`HBM_BW`;
* the LM half (:class:`GpuHwConfig`, :func:`step_model`,
  :func:`memory_model`, :func:`search_hw`) at the bf16 tensor-core peak,
  HBM and NVLink rates of ``repro_torch.launch.analysis``
  (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``), read at call time, under an
  80 GB budget a card.  The mesh knobs are the paper's reuse factors:
  they trade parallelism (lower latency) against per-card residency.

The peaks are module attributes, so a caller (or a test) may set others.
"""

from __future__ import annotations

import dataclasses

from repro_torch.dse.fpga_model import RNNArch
from repro_torch.launch import analysis
from repro_torch.launch.analysis import active_params

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


# ---------------------------------------------------------------------------
# The LM half: mesh factorizations of a zoo LM under a card's HBM budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuHwConfig:
    """Hardware half of the DSE space (the GPU analogue of R_x/R_h/R_d)."""
    data: int = 16
    model: int = 16
    pod: int = 1
    microbatches: int = 1
    fsdp: bool = False
    remat: bool = True

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pod

    @property
    def dp(self) -> int:
        return self.data * self.pod


def step_model(cfg, cell, hw: GpuHwConfig) -> dict:
    """Analytic per-device (flops, bytes, collective bytes) for one step,
    priced at ``launch.analysis``'s peaks."""
    n_active = active_params(cfg)
    n_total = _total_params(cfg)
    D = cfg.d_model
    if cell.kind == "train":
        tokens_local = cell.global_batch * cell.seq_len / hw.dp
        flops = 6.0 * n_active * tokens_local
        flops += _attention_flops(cfg, cell.seq_len, cell.global_batch,
                                  causal_factor=2.0, bwd=True) / hw.chips
        if hw.remat:
            flops *= 4.0 / 3.0          # one extra forward
        # bytes: weights (re-read per microbatch) + activation stream + moments
        act = tokens_local * D * 2 * 8 * cfg.num_layers
        weights = n_total * 2 / hw.model / (hw.dp if hw.fsdp else 1)
        bytes_hbm = (weights * 3 * hw.microbatches     # w read fwd+bwd(+remat)
                     + act                             # activations
                     + n_total / hw.model * 16)        # moments r/w fp32
        # collectives: grad reduce (2× params) + TP activation all-reduces
        coll = 2 * n_total * 4 / hw.model / (hw.dp if hw.fsdp else 1)
        coll += 2 * 2 * tokens_local * D * 2 * cfg.num_layers  # 2 AR/layer ×2 ring
        if hw.fsdp:
            coll += n_total * 2 / hw.model * 2          # weight all-gathers
    elif cell.kind == "prefill":
        tokens_local = cell.global_batch * cell.seq_len / hw.dp
        flops = 2.0 * n_active * tokens_local
        flops += _attention_flops(cfg, cell.seq_len, cell.global_batch,
                                  causal_factor=2.0, bwd=False) / hw.chips
        weights = n_total * 2 / hw.model / (hw.dp if hw.fsdp else 1)
        act = tokens_local * D * 2 * 8 * cfg.num_layers
        bytes_hbm = weights + act
        coll = 2 * 2 * tokens_local * D * 2 * cfg.num_layers
    else:  # decode
        bsz = max(cell.global_batch / hw.dp, 1)
        flops = 2.0 * n_active * cell.global_batch / hw.chips
        flops += _decode_attention_flops(cfg, cell.seq_len,
                                         cell.global_batch) / hw.chips
        weights = n_total * 2 / hw.model / (hw.dp if hw.fsdp else 1)
        cache = _cache_bytes(cfg, cell.seq_len) * cell.global_batch / hw.chips
        bytes_hbm = weights + cache
        coll = 2 * bsz * D * 2 * 2 * cfg.num_layers
    peak, hbm, ici = analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW
    return {"flops": flops, "bytes": bytes_hbm, "coll": coll,
            "t_compute": flops / peak, "t_memory": bytes_hbm / hbm,
            "t_collective": coll / ici,
            "t_step": max(flops / peak, bytes_hbm / hbm, coll / ici)}


def memory_model(cfg, cell, hw: GpuHwConfig) -> float:
    """Per-device HBM residency (bytes) — the GPU resource model (vs 80 GB)."""
    n_total = _total_params(cfg)
    shard = hw.model * (hw.dp if hw.fsdp else 1)
    mem = n_total * 2 / shard                        # bf16 params
    if cell.kind == "train":
        mem += n_total * 2 / shard                   # grads
        mem += n_total * 8 / (hw.model * hw.dp)      # ZeRO moments fp32
        tokens_local = cell.global_batch * cell.seq_len / hw.dp / hw.microbatches
        per_layer = tokens_local * cfg.d_model * 2
        mem += per_layer * (cfg.num_layers if hw.remat else 8 * cfg.num_layers)
    else:
        mem += _cache_bytes(cfg, cell.seq_len) * cell.global_batch / hw.chips
    return mem


def _total_params(cfg) -> float:
    """All parameters (MoE: every expert), for memory/weight traffic."""
    n = active_params(cfg)
    if cfg.moe is not None:
        moe_layers = sum(st.repeat for st in cfg.stages
                         for k in st.pattern if k.endswith("moe"))
        act_e = cfg.moe.top_k + cfg.moe.num_shared
        n += moe_layers * 3 * cfg.d_model * cfg.moe.d_ff_expert \
            * (cfg.moe.num_experts - act_e + cfg.moe.num_shared * 0)
    return n


def _attention_layers(cfg) -> int:
    return sum(st.repeat for st in cfg.stages
               for k in st.pattern
               if k.split(".")[0] in ("attn", "dec_attn", "mla"))


def _attention_flops(cfg, seq: int, batch: int, *, causal_factor: float,
                     bwd: bool) -> float:
    """Global score+value flops (full S² blocks; ÷2 if block-skipping)."""
    n_attn = _attention_layers(cfg)
    hd = cfg.head_dim if cfg.mla is None else (cfg.mla.nope_head_dim
                                               + cfg.mla.rope_head_dim)
    per_layer = 2.0 * 2.0 * batch * seq * seq * cfg.num_heads * hd
    if bwd:
        per_layer *= 2.5
    # SSD chunk-quadratic term for mamba mixers
    ssm_layers = sum(st.repeat for st in cfg.stages
                     for k in st.pattern if k.split(".")[0] == "mamba")
    ssd = 0.0
    if ssm_layers and cfg.ssm is not None:
        q = cfg.ssm.chunk
        d_inner = cfg.ssm.expand * cfg.d_model
        ssd = 2.0 * 2.0 * batch * seq * q * (d_inner + cfg.ssm.d_state)
        if bwd:
            ssd *= 2.5
    return per_layer * n_attn + ssd * ssm_layers


def _decode_attention_flops(cfg, seq: int, batch: int) -> float:
    n_attn = _attention_layers(cfg)
    if cfg.mla is not None:
        per = 2.0 * batch * seq * cfg.num_heads * (cfg.mla.kv_lora_rank * 2)
    else:
        per = 2.0 * 2.0 * batch * seq * cfg.num_heads * cfg.head_dim
    return per * n_attn


def _cache_bytes(cfg, seq: int) -> float:
    """KV/state bytes per sequence."""
    total = 0.0
    for st in cfg.stages:
        for k in st.pattern:
            mixer = k.split(".")[0]
            if mixer in ("attn", "dec_attn"):
                total += st.repeat * 2 * seq * cfg.num_kv_heads * cfg.head_dim * 2
            elif mixer == "mla":
                total += st.repeat * seq * (cfg.mla.kv_lora_rank
                                            + cfg.mla.rope_head_dim) * 2
            elif mixer == "mamba":
                d_inner = cfg.ssm.expand * cfg.d_model
                n_heads = d_inner // cfg.ssm.head_dim
                total += st.repeat * (n_heads * cfg.ssm.head_dim
                                      * cfg.ssm.d_state * 4)
    return total


def search_hw(cfg, cell, *, chips: int = 256, hbm_limit: float = 80e9,
              pod: int = 1) -> list[dict]:
    """Enumerate mesh splits × microbatches; keep feasible, sort by t_step.

    The GPU DSE inner loop: the analogue of scanning reuse factors under
    the DSP budget (§IV-B) — scan mesh factorizations under the HBM budget
    of one card (80 GB).
    """
    out = []
    d = 1
    while d <= chips:
        if chips % d == 0:
            m = chips // d
            for mb in (1, 2, 4, 8):
                for fsdp in (False, True):
                    hw = GpuHwConfig(data=d, model=m, pod=pod,
                                     microbatches=mb, fsdp=fsdp)
                    if cell.global_batch % max(hw.dp, 1) and cell.global_batch > 1:
                        continue
                    mem = memory_model(cfg, cell, hw)
                    perf = step_model(cfg, cell, hw)
                    out.append({"hw": hw, "mem": mem,
                                "feasible": mem <= hbm_limit, **perf})
        d *= 2
    out.sort(key=lambda r: (not r["feasible"], r["t_step"]))
    return out
