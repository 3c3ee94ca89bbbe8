"""Training workloads on synthetic data, the port of
:mod:`adapcc_tpu.workloads`: ``train_gpt2``, ``train_ddp``,
``accuracy_benchmark``, ``main_elastic``, ``train_moe`` and ``serve_gpt2``."""
