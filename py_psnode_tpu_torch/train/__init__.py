"""Checkpoints, evaluation, the variant registry and the trainer (test mode)."""

from py_psnode_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
