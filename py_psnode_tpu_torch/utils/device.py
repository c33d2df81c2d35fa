"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A request
for ``cuda`` on a machine without a card raises: nothing falls back to the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is visible, and
    ``ValueError`` for any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "--device cpu to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f'device must be "cuda[:N]" or "cpu", got {device!r}')
    return dev


def use_full_float32():
    """Keep float32 matrix products in full float32 on the card.

    The port is checked against float32 anchors of the JAX package. TF32
    keeps about three decimal digits, so cuBLAS and cuDNN must not use it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
