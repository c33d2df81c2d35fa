"""Trajectory datasets over the PSOPS ``.npz`` schema (numpy)."""

from py_psnode_tpu_torch.data.schema import DaeSamples  # noqa: F401
