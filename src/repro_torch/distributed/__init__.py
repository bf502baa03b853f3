"""Port placement and halo compression for the multi-port path.

The PyTorch counterpart of the parts of ``repro.distributed`` that the
``sharded`` backend runs: :mod:`.sharding` (``PortMesh``, ``port_mesh``,
``shard_facets``; on one card a port is a CUDA stream) and
:mod:`.compression` (``quantize_int8``/``dequantize_int8``, the
``halo_quantize`` hook).  Data-parallel and tensor-parallel sharding arrive
with the distribution slice.
"""
