"""Hand-written CUDA kernels, their plain PyTorch versions and the dispatch.

``ops.py`` is the entry point: CPU tensors go to ``ref.py``, CUDA tensors to
the kernels (``hash_match.py``, ``assertion_eval.py``), built from
``csrc/`` by ``build.py`` at first use.
"""
