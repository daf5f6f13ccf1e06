"""Kernels of the port: CUDA sources in ``csrc/``, built by ``build``,
bound by the wrapper modules, with plain versions in ``ref``."""
