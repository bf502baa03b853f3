"""Sharding rules, port placement and halo compression.

The PyTorch counterpart of ``repro.distributed``: :mod:`.sharding` (the
logical specs, the active mesh and their DTensor placements; ``PortMesh``,
``port_mesh``, ``shard_facets``, where on one card a port is a CUDA stream)
and :mod:`.compression` (``quantize_int8``/``dequantize_int8``, the
``halo_quantize`` hook, and error-feedback gradient compression), and
:mod:`.pipeline` (GPipe ``pipeline_apply`` over a ``pipe`` mesh dimension).
"""
