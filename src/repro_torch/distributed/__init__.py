"""Distributed pieces of the port: the error-feedback int8 gradient
compression (``compression.py``) and tensor-parallel serving (``tp.py``:
column-parallel projections and head-sharded paged attention over a
``torch.distributed`` group).  The parameter, cache and optimizer-state
sharding specs and ZeRO-1 come with ROADMAP A4b."""
from repro_torch.distributed.compression import ef_int8_compress, ef_int8_init

__all__ = ["ef_int8_compress", "ef_int8_init"]
