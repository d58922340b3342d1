"""Blaze batched JSON-Schema validation, ported to PyTorch and CUDA.

The second package beside the JAX package ``repro``, with the same layout
and module names.  It imports ``torch`` and numpy, never ``jax`` and no
module of ``repro``: the pure-Python front end (compiler, tape builder,
sequential executor, token-table encoder, linker, observability seams) is
carried here as its own copy, and the batched executor and its two kernels
are PyTorch and hand-written CUDA C++ for Hopper (``csrc/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
missing GPU raises instead of falling back.
"""
