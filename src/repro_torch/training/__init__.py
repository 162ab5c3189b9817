"""Training of the port (port of ``repro.training``): AdamW with warmup,
cosine decay and global-norm clipping; int8 gradient compression with
error feedback; the train step over microbatches."""
from repro_torch.training.optimizer import OptHyper, adamw_init, adamw_update
from repro_torch.training.step import abstract_train_state, make_train_step

__all__ = ["adamw_init", "adamw_update", "OptHyper", "make_train_step",
           "abstract_train_state"]
