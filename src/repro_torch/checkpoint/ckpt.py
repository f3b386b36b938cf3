"""Checkpoints of the training state (port of ``repro/checkpoint/ckpt.py``).

* **Atomic**: written to ``<name>.tmp``, then ``os.replace``: a crash in the
  middle of a write never damages the newest checkpoint.
* **Format**: one ``.npz`` whose keys are the state's nested dict keys
  joined with ``//`` (``params//blocks.0.ln1.w``, ``opt//mu//embed.w``,
  ``opt//step``), as the reference joins its tree paths.  numpy has no
  bfloat16, so a bf16 tensor is stored as its 16-bit pattern (``uint16``,
  lossless) under the key with ``@bf16`` appended, and restored bit for
  bit.
* **Restore** into the structure of ``like``: every tensor comes back in
  ``like``'s dtype and on its device.
* :class:`CheckpointManager`: step-indexed files, ``latest()`` for
  auto-resume, and keep-K garbage collection with the newest always kept.
* **Elastic** (``shardings``: a tree like the state's with a
  ``distributed.sharding.NamedSharding`` or None at each leaf): a sharded
  run saves whole tensors, gathered to its rank 0, which writes them (the
  others wait at a barrier); a restore gives each rank its slice
  of every tensor under the shardings it is handed, so a state saved at
  one ``data`` or ``model`` degree restores at another.
"""
from __future__ import annotations

import os
import re
import struct
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_SEP = "//"
_BF16 = "@bf16"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).cpu().numpy().view(np.uint16)
    return "", t.cpu().numpy()


def _leaves_of(shardings: Any, key: str) -> Optional[Any]:
    for k in key.split(_SEP):
        if not isinstance(shardings, dict):
            return None
        shardings = shardings.get(k)
    return shardings


def save_checkpoint(path: str, tree: Dict, shardings: Optional[Dict] = None) -> None:
    """Write ``tree`` (nested dicts of tensors) to ``path`` atomically.
    With ``shardings`` every rank calls this: each sharded leaf is gathered
    whole on rank 0 of the default group (``sharding.gather_to_root``),
    which writes, and every rank returns after the file is in place."""
    if shardings is not None:
        root = not dist.is_initialized() or dist.get_rank() == 0
        whole = []
        for key, leaf in _flatten(tree):
            ns = _leaves_of(shardings, key)
            t = leaf if ns is None else sharding.gather_to_root(leaf, ns.spec, ns.mesh)
            if root:
                whole.append((key, t))
        if root:
            _write(path, whole)
        if dist.is_initialized():
            dist.barrier()
        return
    _write(path, _flatten(tree))


def _write(path: str, leaves: List[Tuple[str, Any]]) -> None:
    arrays = {}
    for key, leaf in leaves:
        tag, arr = _to_numpy(torch.as_tensor(leaf))
        arrays[key + tag] = arr
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX


class _Arrays:
    """The arrays of an ``np.savez`` file.  A large member is stored, not
    deflated, so it is read as a memory map of its bytes in the file (no
    copy, no CRC pass: ``np.load`` reads a zip member a megabyte at a time
    through zipfile's CRC, ~0.6 GB/s on the card's host); small ones and
    any deflated one through ``np.load``."""

    def __init__(self, path: str):
        self.path = path
        self.npz = np.load(path)
        self.files = self.npz.files
        with zipfile.ZipFile(path) as z:
            self.info = {i.filename[:-4]: i for i in z.infolist()}

    def __getitem__(self, key: str) -> np.ndarray:
        info = self.info[key]
        if info.compress_type != zipfile.ZIP_STORED or info.file_size < 2**20:
            return self.npz[key]
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            offset = f.tell()
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset, shape=shape,
                         order="F" if fortran else "C")

    def close(self) -> None:
        self.npz.close()


def _unflatten(like: Any, data, shardings: Any, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, data, shardings.get(k) if isinstance(shardings, dict)
                              else None, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in like.items()}
    with warnings.catch_warnings():
        # a memory map is read-only; the tensor is copied below, never written
        warnings.simplefilter("ignore", UserWarning)
        if prefix + _BF16 in data.files:
            t = torch.from_numpy(data[prefix + _BF16].view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(data[prefix])
    if shardings is not None:
        t = sharding.local(t, shardings.spec, shardings.mesh)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {prefix}: {tuple(t.shape)} does not fit "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype, copy=True)


def load_checkpoint(path: str, like: Dict, shardings: Optional[Dict] = None) -> Dict:
    """The checkpoint at ``path`` in the structure of ``like``, each tensor
    in its ``like`` counterpart's dtype and on its device; under
    ``shardings`` (module docstring) each leaf that names one is this
    rank's slice of the saved tensor."""
    data = _Arrays(path)
    try:
        return _unflatten(like, data, shardings)
    finally:
        data.close()


class CheckpointManager:
    """Step-indexed checkpoints with keep-K GC and auto-resume."""

    _PAT = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := self._PAT.match(f)))

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Dict, shardings: Optional[Dict] = None) -> str:
        p = self.path(step)
        save_checkpoint(p, tree, shardings)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._gc()
        return p

    def restore(self, step: int, like: Dict, shardings: Optional[Dict] = None) -> Dict:
        return load_checkpoint(self.path(step), like, shardings)

    def restore_latest(self, like: Dict, shardings: Optional[Dict] = None
                       ) -> Tuple[Optional[int], Dict]:
        s = self.latest()
        if s is None:
            return None, like
        return s, self.restore(s, like, shardings)

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            try:
                os.remove(self.path(s))
            except OSError:
                pass
