"""PyTorch/CUDA port of the takum-codec serving system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``formats``, ``kernels``, ``configs``, ``models``,
``serve``, ``obs``, ``ft``) and runs its kernels as hand-written CUDA for
Hopper. Public
entry points place tensors on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.
"""
