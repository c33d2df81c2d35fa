"""Trajectory datasets over the PSOPS ``.npz`` schema and the synthetic AVR
generator (numpy)."""

from py_psnode_tpu_torch.data.schema import DaeSamples, OdeSamples  # noqa: F401
