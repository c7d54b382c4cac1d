"""LM training, as the reference's ``train/``: optimizers (``optimizer``),
int8 gradient compression with error feedback (``grad_compress``) and the
training step (``train_step``)."""
from repro_torch.train.optimizer import adafactor, adamw, make_optimizer
from repro_torch.train.train_step import loss_fn, make_train_step

__all__ = ["adamw", "adafactor", "make_optimizer", "make_train_step",
           "loss_fn"]
