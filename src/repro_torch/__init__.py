"""PyTorch / CUDA port of the DSDE serving system.

Laid out like the JAX package ``repro`` (each module's counterpart sits
at the same path) and imports nothing of it.  Plain tensor code is
PyTorch; the TPU kernels of the serving path are CUDA kernels for
Hopper under ``csrc/``, built at first use into ``build/kernels/``.
"""
