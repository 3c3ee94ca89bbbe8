"""adapcc-tpu ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference :mod:`adapcc_tpu`: it imports
``torch`` and never ``jax``, and keeps its own copies of the host-side pieces
it needs.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain torch
version.
"""
