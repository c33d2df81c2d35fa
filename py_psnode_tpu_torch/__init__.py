"""py_psnode_tpu_torch: the PyTorch and CUDA port of ``py_psnode_tpu``.

The JAX package ``py_psnode_tpu`` is the reference; this package computes
the same functions with ``torch`` on an NVIDIA H100 (or, for the tests, on
the CPU). Its layout mirrors the JAX package's (``data/``, ``solvers/``,
``models/``, ``ops/``, ``train/``, ``cli/``, ``utils/``) so that every
counterpart is easy to find. It imports nothing of JAX and nothing of the
JAX package.

Ported so far: the serving path of the DAE no-encode variant,
``--testing [--fused]``. The fused forward rollout runs through a CUDA
kernel written by hand (``csrc/fused_dae_rollout.cu``), built with ``nvcc``
on first use and bound with ``ctypes``. Entry points run on ``cuda`` unless
the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
