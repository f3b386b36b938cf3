"""Distributed pieces of the port: the error-feedback int8 gradient
compression (``compression.py``), tensor-parallel serving (``tp.py``:
column-parallel projections and head-sharded paged attention over a
``torch.distributed`` group), and the partition rules with their runtime
(``sharding.py``: the parameter, cache and optimizer-state specs, the mesh
and its scope, the gathers and reductions the sharded cells run on)."""
from repro_torch.distributed.compression import ef_int8_compress, ef_int8_init

__all__ = ["ef_int8_compress", "ef_int8_init"]
