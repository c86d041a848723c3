"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  mcd_lstm_seq  sequence-fused MC-dropout LSTM layer (csrc/mcd_lstm_seq.cu)
  mcd_gru_seq   sequence-fused MC-dropout GRU layer (csrc/mcd_gru_seq.cu)
  mcd_lstm      fused LSTM step (csrc/mcd_lstm_step.cu), the 8 stream keys
  mcd_gru       fused GRU step (csrc/mcd_gru_step.cu), the 6 stream keys
  bernoulli_mask  masked_activation: the LM's attention-site mask
                (csrc/masked_activation.cu)
  mcd_matmul    the masked SwiGLU gate/up product (csrc/mcd_matmul.cu)
  decode_attn   one-token GQA attention over a KV cache
                (csrc/decode_attn.cu)
  ssd_chunk     the Mamba2 / SSD chunked scan (csrc/ssd_chunk.cu)
  common        mask factors, operand forms, checks and the launch rule
                the kernels share
  quantize      the serving precisions' weight quantization (int8, packed
                int4) and activation dtypes
  ops           the stack-layer wrappers ``run_stack`` dispatches to, and
                the LM's (``mcd_dense``, ``mcd_mask_apply``,
                ``flash_decode_attention``, ``ssd_scan``)
  build         nvcc build (sm_90a) and ctypes loading, at first use
"""
