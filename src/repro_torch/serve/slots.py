"""Slot-axis surgery on the paged serving cache (port of
``repro/serve/slots.py`` for the paged layout).

The serving cache is ``{"pos": (num_slots,) int32, "block_table":
(num_slots, max_blocks) int32, "layers": [{"k", "v"}, ...]}``.  Every K/V
leaf of the dense family is a pool shared by all slots and has no slot axis,
so slicing passes the pools through whole and writing needs nothing for
them: the model's block-table scatter already wrote the slot's own blocks
in place.  Only ``pos`` and the slot's table row are per-slot.

In a step program the slot is an operand, a 0-d integer device tensor, as
the JAX package passes it to ``dynamic_slice``: :func:`slice_slot` reads
through ``index_select`` and :func:`write_slot` writes back with
``index_copy_``, so a captured CUDA graph serves whichever slot its input
buffer names at replay.  :func:`where_active` updates ``pos`` in place (a
graph's state lives at fixed addresses).  The JAX package returns new
pytrees; these helpers update the cache in place and return it.
:func:`reset_slot`, decided on the host between steps, takes a Python slot.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["slice_slot", "write_slot", "reset_slot", "where_active"]


def slice_slot(cache: Dict[str, Any], slot: torch.Tensor) -> Dict[str, Any]:
    """Slot ``slot`` (a 0-d integer device tensor) as a batch-1 cache with a
    0-d ``pos`` (the table row stays 2-D so prefill and batched decode share
    the model code)."""
    idx = slot.reshape(1)
    return {"pos": cache["pos"].index_select(0, idx).reshape(()),
            "block_table": cache["block_table"].index_select(0, idx),
            "layers": cache["layers"]}


def write_slot(cache: Dict[str, Any], slot: torch.Tensor, sub: Dict[str, Any]) -> Dict[str, Any]:
    """Fold a batch-1 cache from :func:`slice_slot` back into the slot.
    Block tables are engine-owned and never model-written."""
    cache["pos"].index_copy_(0, slot.reshape(1).long(), sub["pos"].reshape(1))
    return cache


def reset_slot(cache: Dict[str, Any], slot: int, pos: int = 0) -> Dict[str, Any]:
    """Hand a slot to a new request: set its starting position (0, or the
    number of prefix-cached rows) and clear its table row.  Pools are left
    untouched — stale rows are fenced by the table and by kv_len, and
    shared prefix blocks may be read by other slots."""
    cache["pos"][slot] = pos
    cache["block_table"][slot] = -1
    return cache


def where_active(active: torch.Tensor, new: Dict[str, Any],
                 old: Dict[str, Any]) -> Dict[str, Any]:
    """After a batched decode step: advance ``old["pos"]`` in place, only
    where ``active``.  The pools take the new writes verbatim — empty slots
    carry ``-1`` table rows, so their decode writes were dropped, and a slot
    still prefilling had its garbage row written at its ``pos``, which its
    next chunk (or its first real decode step) overwrites before anything
    reads it."""
    old["pos"].copy_(torch.where(active, new["pos"], old["pos"]))
    return old
