"""The reference's examples (``examples/*.py``) on the port, one module
each, run as ``python -m repro_torch.examples.<name>``:

  quickstart           Bayesian LSTM inference with uncertainty
  anomaly_detection    train the recurrent autoencoder, score, ROC-AUC
  ecg_monitoring       stream ECG through the engine (train, kill/resume,
                       controller, early exit, distilled students)
  fleet_monitoring     heterogeneous tenants through one FleetEngine
  uncertainty_serving  per-token uncertainty from a zoo LM
  codesign_search      the FPGA co-design search

Each takes ``--device`` (CUDA unless ``cpu``) and exposes
``main(argv=None)``.
"""
