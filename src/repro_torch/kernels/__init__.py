"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  mcd_lstm_seq  sequence-fused MC-dropout LSTM layer (csrc/mcd_lstm_seq.cu)
  mcd_gru_seq   sequence-fused MC-dropout GRU layer (csrc/mcd_gru_seq.cu)
  mcd_lstm      fused LSTM step (csrc/mcd_lstm_step.cu), the 8 stream keys
  mcd_gru       fused GRU step (csrc/mcd_gru_step.cu), the 6 stream keys
  common        mask factors, operand forms and checks the kernels share
  ops           the stack-layer wrappers ``run_stack`` dispatches to
  build         nvcc build (sm_90a) and ctypes loading, at first use
"""
