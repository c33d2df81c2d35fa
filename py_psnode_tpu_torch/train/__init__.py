"""Checkpoints, evaluation, losses, the optimizer, the variant registry and
the trainer."""

from py_psnode_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
