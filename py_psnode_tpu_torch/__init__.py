"""py_psnode_tpu_torch: the PyTorch and CUDA port of ``py_psnode_tpu``.

The JAX package ``py_psnode_tpu`` is the reference; this package computes
the same functions with ``torch`` on an NVIDIA H100 (or, for the tests, on
the CPU). Its layout mirrors the JAX package's (``data/``, ``solvers/``,
``models/``, ``ops/``, ``train/``, ``cli/``, ``utils/``) so that every
counterpart is easy to find. It imports nothing of JAX and nothing of the
JAX package.

Ported so far: the DAE and ODE no-encode variants and the channel-wise
family (``ode_channelwise``, ``dae_channelwise``), each served
(``--testing [--fused]``) and trained (``--training [--fused]``). Each
fused rollout runs through two CUDA kernels written by hand, a forward and
a reverse-time backward behind a ``torch.autograd.Function``
(``csrc/fused_{dae,ode,cw}_rollout{,_bwd}.cu``), each built with ``nvcc``
on first use and bound with ``ctypes``. Entry points run on ``cuda`` unless
the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
