"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  mcd_lstm_seq  sequence-fused MC-dropout LSTM layer (csrc/mcd_lstm_seq.cu)
  mcd_lstm      the per-gate mask-stream keys and rule it shares
  ops           the stack-layer wrappers ``run_stack`` dispatches to
  build         nvcc build (sm_90a) and ctypes loading, at first use
"""
