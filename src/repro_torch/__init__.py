"""PyTorch/CUDA port of the ``repro`` serving stack.

Mirrors ``src/repro/``'s package map (``configs``, ``core``, ``kernels``,
``models``, ``runtime``) so each module's counterpart is easy to find.  It
imports ``torch`` and numpy and never ``jax`` or ``repro``.  Entry points
(``models.model.init_params``, ``runtime.PagedServer``,
``runtime.make_engine``) run on the CUDA device unless the caller passes
``device="cpu"``.
"""
