"""PyTorch / CUDA port of the TMFU overlay's serving path.

Same sub-package layout and public names as the JAX package ``repro``
beside it; imports ``torch`` and ``numpy`` only.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
