"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
of the reference package.

Each subpackage follows the ``<name>.py`` (wrapper + launch counter) /
``ref.py`` (plain PyTorch version) / ``csrc/*.cu`` (kernel source)
convention; ``_build.py`` compiles the sources with ``nvcc`` at first use
and loads them through ``ctypes``.  Nothing is built when a module is
imported.
"""
