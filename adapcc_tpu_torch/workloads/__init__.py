"""Training workloads on synthetic data, the port of
:mod:`adapcc_tpu.workloads` (``train_moe`` so far)."""
