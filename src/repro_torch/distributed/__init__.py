"""Distributed training pieces of the port: the error-feedback int8
gradient compression (``compression.py``).  Sharding and tensor
parallelism come with ROADMAP A4."""
from repro_torch.distributed.compression import ef_int8_compress, ef_int8_init

__all__ = ["ef_int8_compress", "ef_int8_init"]
