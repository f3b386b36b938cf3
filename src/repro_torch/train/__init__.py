"""Training of the port (port of ``repro/train``): AdamW with the cosine
schedule (``optimizer.py``), the train step (``train_step.py``) and the
auto-resuming trainer (``trainer.py``).  Every family trains (the
encoder-decoder through ``make_train_step``: ``lm_batch`` carries no frame
embeddings); a W8A8 projection raises (``models.transformer.
check_trainable``)."""
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.train.train_step import (loss_fn, make_train_step, make_trainable,
                                          trainable_params)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "OptConfig",
    "Trainer",
    "TrainerConfig",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "loss_fn",
    "make_train_step",
    "make_trainable",
    "trainable_params",
]
