"""PyTorch / CUDA port of the CFA reproduction (``repro``).

``repro_torch.cfa.compile`` is the front door, as ``repro.cfa.compile`` is
for the JAX package; it runs on the CUDA device unless ``device="cpu"`` is
asked for.  The package imports PyTorch, never JAX, and nothing of
``repro``: what it needs of the reference's numpy-only modules it keeps as
its own copy.
"""
