"""PyTorch/CUDA port of the SMDP dynamic-batching system.

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``serving/``) so each module's counterpart sits at the same path.  The
hot spots are hand-written CUDA kernels for Hopper (``kernels/csrc``),
built with nvcc at first use; everything around them is plain PyTorch or
numpy.

Device contract: every entry point takes ``device=``.  ``device=None``
means ``"cuda"`` and raises where CUDA is absent; only an explicit
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""
