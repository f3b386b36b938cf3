"""Checkpoints of the port's training state (``ckpt.py``)."""
from repro_torch.checkpoint.ckpt import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
