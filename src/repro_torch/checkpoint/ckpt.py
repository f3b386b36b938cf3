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
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def save_checkpoint(path: str, tree: Dict) -> None:
    """Write ``tree`` (nested dicts of tensors) to ``path`` atomically."""
    arrays = {}
    for key, leaf in _flatten(tree):
        tag, arr = _to_numpy(torch.as_tensor(leaf))
        arrays[key + tag] = arr
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX


def _unflatten(like: Any, data, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, data, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in like.items()}
    if prefix + _BF16 in data.files:
        t = torch.from_numpy(data[prefix + _BF16].view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(data[prefix])
    return t.to(device=like.device, dtype=like.dtype)


def load_checkpoint(path: str, like: Dict) -> Dict:
    """The checkpoint at ``path`` in the structure of ``like``, each tensor
    in its ``like`` counterpart's dtype and on its device."""
    with np.load(path) as data:
        return _unflatten(like, data)


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

    def save(self, step: int, tree: Dict) -> str:
        p = self.path(step)
        save_checkpoint(p, tree)
        self._gc()
        return p

    def restore(self, step: int, like: Dict) -> Dict:
        return load_checkpoint(self.path(step), like)

    def restore_latest(self, like: Dict) -> Tuple[Optional[int], Dict]:
        s = self.latest()
        if s is None:
            return None, like
        return s, self.restore(s, like)

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            try:
                os.remove(self.path(s))
            except OSError:
                pass
