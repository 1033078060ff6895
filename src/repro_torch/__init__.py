"""PyTorch/CUDA port of the IDKD decentralized-learning system.

The JAX package ``repro`` is the reference; this package runs the same
system on an NVIDIA H100 and never imports ``jax`` or ``repro``. Its
layout mirrors the reference (``configs``, ``data``, ``models``,
``core``, ``sched``, ``optim``, ``kernels``); the hand-written Hopper
kernels live in ``csrc`` and build into ``build/kernels/`` at first use.
"""
