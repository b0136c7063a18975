"""PyTorch/CUDA port of the runtime model stack of ``repro``.

The JAX package ``repro`` is the reference; this package is a second,
independent implementation that imports only torch, numpy and the standard
library. Layout mirrors the reference: ``configs``, ``models``, ``serve``,
``launch`` and ``kernels`` (hand-written CUDA kernels for Hopper, each with
a plain PyTorch version that CPU tensors take). Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""
