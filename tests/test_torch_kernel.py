"""The CUDA rollout kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so that it also runs on
the machine with the card, which has no JAX; run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

The kernel tests are marked ``gpu`` and skip where no CUDA card is visible
(a CUDA kernel has no CPU mode). Tolerance: ``|kernel - plain| <= 1e-4 *
max(1, |plain|)`` per element (float32, another summation order).
"""

import numpy as np
import pytest
import torch

from py_psnode_tpu_torch.ops import fused_dae as F


def rollout_inputs(B, Tm1, h, xd=3, idim=2, seed=0, dev="cpu"):
    """Seeded rollout inputs in the flax layout, with per-row step sizes
    and events in some rows."""
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.tensor((rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    streams = {k: t(Tm1, B, h, sc=0.5) for k in ("s_de", "s_ae", "s_ae_ev")}
    tail = lambda out: [(t(h, o, sc=h ** -0.5), t(o, sc=0.1)) for o in (h, h, out)]
    weights = dict(wx_de=t(xd, h, sc=0.5), wi_de=t(idim, h, sc=0.5), gx_ae=t(xd, h, sc=0.5),
                   de_tail=tail(xd), ae_tail=tail(idim))
    dt = torch.full((Tm1, B, 1), 0.05, device=dev)
    dt[:, 1] = 0.02
    ev = torch.zeros(Tm1, B, dtype=torch.bool, device=dev)
    ev[2, 1] = ev[2, 3] = ev[9, :] = ev[Tm1 - 1, 0] = True
    return streams, weights, t(B, xd), t(B, idim), F.pack_aux(dt, ev)


@pytest.mark.parametrize("batch", [1, 32, 132, 133, 1024, 5000])
def test_default_launch_is_an_instantiated_shape(batch):
    rows, ks = F.default_launch(batch, 132)
    assert rows in F.ROWS_PER_BLOCK and ks in F.K_SPLITS
    assert (rows, ks) == ((1, 4) if batch <= 132 else (4, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_kernel_matches_plain_on_card(solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(B=37, Tm1=64, h=128, dev="cuda")
    ref = F.fused_dae_rollout_packed_plain(*args, solver)
    before = F.fused_dae_rollout.launches
    for rows in F.ROWS_PER_BLOCK:
        for ks in F.K_SPLITS:
            got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows, k_split=ks)
            torch.cuda.synchronize()
            assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)), (rows, ks)
    assert F.fused_dae_rollout.launches == before + len(F.ROWS_PER_BLOCK) * len(F.K_SPLITS)


@pytest.mark.gpu
def test_kernel_refuses_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    streams, weights, x0, i0, aux = rollout_inputs(B=4, Tm1=12, h=32, dev="cuda")
    with pytest.raises(ValueError, match="float32"):
        F.fused_dae_rollout_packed_cuda(streams, weights, x0.double(), i0, aux)
    with pytest.raises(ValueError, match="contiguous"):
        bad = dict(streams, s_de=streams["s_de"].transpose(0, 1).contiguous().transpose(0, 1))
        F.fused_dae_rollout_packed_cuda(bad, weights, x0, i0, aux)
    with pytest.raises(ValueError, match="shape"):
        F.fused_dae_rollout_packed_cuda(streams, weights, x0[:, :2].contiguous(), i0, aux)
    with pytest.raises(ValueError, match="rows_per_block"):
        F.fused_dae_rollout_packed_cuda(streams, weights, x0, i0, aux, rows_per_block=3)
