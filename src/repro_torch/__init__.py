"""PyTorch/CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

Mirrors ``repro``'s layout (``configs``, ``parallel``, ``kernels``,
``models``, ``launch``) so each module has an obvious counterpart.  It
imports ``torch`` and numpy only: nothing of JAX and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
