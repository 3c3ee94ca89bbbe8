"""Training workloads on synthetic data, the port of
:mod:`adapcc_tpu.workloads` (``train_moe`` and ``serve_gpt2`` so far)."""
