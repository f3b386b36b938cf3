"""Slot-axis surgery on the serving cache (port of ``repro/serve/slots.py``).

Two layouts, told apart by ``"block_table"``:

* paged: ``{"pos": (num_slots,) int32, "block_table": (num_slots,
  max_blocks) int32, "layers": [{"k", "v"}, ...]}``.  Every K/V leaf is a
  pool shared by all slots and has no slot axis, so slicing passes the
  pools through whole and writing needs nothing for them: the model's
  block-table scatter already wrote the slot's own blocks in place.  Only
  ``pos`` and the slot's table row are per-slot.
* the dense per-slot slab (:func:`init_slot_cache`): ``{"pos",
  "layers": [{"k", "v"}, ...]}`` with ``(num_slots, s_c, Hkv, hd)`` leaves
  (a recurrent layer's state leaves instead, ``(num_slots, ...)``; an
  encoder-decoder's ``k``/``v`` and ``cross_k``/``cross_v`` of ``max_seq``
  and ``encoder_seq`` rows), the
  slot axis first (the JAX package's ``slot_axis`` is 1 under its
  scan-stacked layers; the port keeps its layers in a list).  A slice is
  not a copy: it carries the slot's index as ``"slot"``, and the model
  reads and writes that slot's rows of the slab in place (a ring chunk
  scatters only its own rows), so no slot's cache is copied out and back
  per chunk.

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

__all__ = ["init_slot_cache", "slice_slot", "write_slot", "reset_slot", "where_active"]


def init_slot_cache(model, num_slots: int, max_seq: int) -> Dict[str, Any]:
    """The dense per-slot slab: the model's dense cache with the batch axis
    as slots and a per-slot ``pos`` vector."""
    cache = model.init_cache(num_slots, max_seq, paged=False)
    cache["pos"] = torch.zeros((num_slots,), dtype=torch.int32, device=model.device)
    return cache


def slice_slot(cache: Dict[str, Any], slot: torch.Tensor) -> Dict[str, Any]:
    """Slot ``slot`` (a 0-d integer device tensor) as a batch-1 cache with a
    0-d ``pos``: paged, the table row (kept 2-D so prefill and batched
    decode share the model code); dense, the slot's index."""
    idx = slot.reshape(1)
    sub = {"pos": cache["pos"].index_select(0, idx).reshape(()), "layers": cache["layers"]}
    if "block_table" in cache:
        sub["block_table"] = cache["block_table"].index_select(0, idx)
    else:
        sub["slot"] = idx
    return sub


def write_slot(cache: Dict[str, Any], slot: torch.Tensor, sub: Dict[str, Any]) -> Dict[str, Any]:
    """Fold a batch-1 cache from :func:`slice_slot` back into the slot: its
    ``pos``.  The model wrote the K/V rows in place; block tables are
    engine-owned and never model-written."""
    cache["pos"].index_copy_(0, slot.reshape(1).long(), sub["pos"].reshape(1))
    return cache


def reset_slot(cache: Dict[str, Any], slot: int, pos: int = 0) -> Dict[str, Any]:
    """Hand a slot to a new request: set its starting position (0, or the
    number of prefix-cached rows).  Paged, clear its table row and leave the
    pools untouched — stale rows are fenced by the table and by kv_len, and
    shared prefix blocks may be read by other slots.  Dense, zero the
    slot's rows of the slab, as the JAX package does."""
    cache["pos"][slot] = pos
    if "block_table" in cache:
        cache["block_table"][slot] = -1
    else:
        for layer in cache["layers"]:
            for leaf in layer.values():
                leaf[slot].zero_()
    return cache


def where_active(active: torch.Tensor, new: Dict[str, Any],
                 old: Dict[str, Any]) -> Dict[str, Any]:
    """After a batched decode step: advance ``old["pos"]`` in place, only
    where ``active``.  The JAX package selects every slab leaf per active
    slot here.  Recurrent state must not move for a slot that is empty or
    still prefilling, and the decode step does that selection itself: it is
    given ``active`` and writes ``torch.where(active, new, old)`` into each
    recurrent leaf.  The K/V keep the new writes verbatim: paged, empty
    slots carry ``-1`` table rows, so their decode writes were dropped; on
    either layout a slot
    still prefilling had a row written at its ``pos``, which its next chunk
    writes before anything reads it (a ring chunk reads that row first,
    but as position ``pos - s_c``, which no query of the chunk sees: below
    its window, or never written); an empty slot is zeroed when it is
    handed out."""
    old["pos"].copy_(torch.where(active, new["pos"], old["pos"]))
    return old
