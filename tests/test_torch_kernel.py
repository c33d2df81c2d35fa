"""The CUDA rollout kernels (the DAE, ODE and channel-wise forward and
backward) against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so that it also runs on
the machine with the card, which has no JAX; run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

The kernel tests are marked ``gpu`` and skip where no CUDA card is visible
(a CUDA kernel has no CPU mode). Tolerance of the forward: ``|kernel -
plain| <= 1e-4 * max(1, |plain|)`` per element (float32, another summation
order); of the backward, per output tensor, ``max|kernel - plain| <= 1e-4 *
max|plain|`` against the plain walk in float64, each tensor on its own
scale (each weight gradient sums all row-steps in another order), and
bit-identical results when launched again.
"""

import numpy as np
import pytest
import torch

from py_psnode_tpu_torch.ops import fused_channelwise as FC
from py_psnode_tpu_torch.ops import fused_channelwise_vjp as VC
from py_psnode_tpu_torch.ops import fused_dae as F
from py_psnode_tpu_torch.ops import fused_dae_vjp as V
from py_psnode_tpu_torch.ops import fused_ode as FO
from py_psnode_tpu_torch.ops import fused_ode_vjp as VO
from py_psnode_tpu_torch.utils.cw_inputs import seeded_inputs
from py_psnode_tpu_torch.utils.noencode_inputs import dae_inputs, true_states, with_first_step_events
from py_psnode_tpu_torch.utils.noencode_inputs import ode_inputs as noencode_ode_inputs


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(a, dev) for a in tree)
    return tree.to(dev)


def rollout_inputs(B, Tm1, h, xd=3, idim=2, seed=0, dev="cpu", n_tail=3):
    """Seeded rollout inputs in the flax layout, with per-row step sizes
    and events in some rows (``utils.noencode_inputs.dae_inputs``) on
    ``dev``."""
    return _to(dae_inputs(B, Tm1, h, xd, idim, seed, n_tail), dev)


@pytest.mark.parametrize("batch", [1, 32, 132, 133, 1024, 5000])
def test_default_launch_is_an_instantiated_shape(batch):
    rows = F.default_launch(batch, 132)
    assert rows in F.ROWS_PER_BLOCK
    # one row a block while the rows fit in one wave, then the fewest rows a
    # block that do, at most 8
    assert rows == {1: 1, 32: 1, 132: 1, 133: 2, 1024: 8, 5000: 8}[batch]
    assert -(-batch // rows) <= 132 or rows == F.ROWS_PER_BLOCK[-1]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_kernel_matches_plain_on_card(solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(B=37, Tm1=64, h=128, dev="cuda")
    ref = F.fused_dae_rollout_packed_plain(*args, solver)
    before = F.fused_dae_rollout.launches
    for rows in F.ROWS_PER_BLOCK:
        got = F.fused_dae_rollout_packed_cuda(*args, solver, rows_per_block=rows)
        torch.cuda.synchronize()
        assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)), rows
    assert F.fused_dae_rollout.launches == before + len(F.ROWS_PER_BLOCK)


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


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tuple(_double(a) for a in pair) for pair in tree]
    return tree.double()


def _bwd_flat(g):
    g_s, g_w, g_x0, g_i0 = g
    return [g_s["s_de"], g_s["s_ae"], g_s["s_ae_ev"], g_x0, g_i0] + V.flatten_weights(g_w)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
def test_bwd_kernel_matches_plain_on_card(solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(B=37, Tm1=64, h=128, dev="cuda")
    packed = F.fused_dae_rollout_packed_plain(*args, solver)
    rng = np.random.default_rng(1)
    cot = torch.tensor(rng.standard_normal((65, 37, 5)).astype(np.float32), device="cuda")
    streams, weights, x0, i0, aux = args
    ref = _bwd_flat(V.fused_dae_rollout_bwd_plain(
        _double(streams), _double(weights), x0.double(), i0.double(), aux, packed.double(),
        cot.double(), solver))
    before = V.fused_dae_rollout_bwd.launches
    got = _bwd_flat(V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver))
    again = _bwd_flat(V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver))
    torch.cuda.synchronize()
    for k, (g, g2, r) in enumerate(zip(got, again, ref)):
        scale = r.abs().max().item()
        assert scale > 0, k
        assert torch.equal(g, g2), k
        assert (g.double() - r).abs().max() <= 1e-4 * scale, k
    assert V.fused_dae_rollout_bwd.launches == before + 2


@pytest.mark.gpu
def test_bwd_kernel_refuses_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(B=4, Tm1=12, h=32, dev="cuda")
    packed = F.fused_dae_rollout_packed_cuda(*args, "euler")
    cot = torch.zeros(13, 4, 5, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        V.fused_dae_rollout_bwd_cuda(*args, packed, cot[:12].contiguous())
    with pytest.raises(ValueError, match="float32"):
        V.fused_dae_rollout_bwd_cuda(*args, packed.double(), cot)


def ode_inputs(B, Tm1, h, xd, n_tail, seed=0, dev="cpu"):
    """Seeded ODE rollout inputs in the flax layout, per-row step sizes
    (``utils.noencode_inputs.ode_inputs`` with the readout at lecun
    scale), on ``dev``."""
    return _to(noencode_ode_inputs(B, Tm1, h, xd, n_tail, seed, readout=1.0), dev)


# (xd, n_tail): the no-encode dynamics and the direct-encode latent shape
ODE_SHAPES = [(2, 3), (128, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("xd,n_tail", ODE_SHAPES)
@pytest.mark.parametrize("batch", [37, 133])  # fewer and more blocks than a 132-SM card has SMs
def test_ode_kernel_matches_plain_on_card(solver, xd, n_tail, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = ode_inputs(batch, 64, 128, xd, n_tail, dev="cuda")
    ref = FO.fused_ode_rollout_plain(*args, solver)
    before = FO.fused_ode_rollout.launches
    for rows in F.ROWS_PER_BLOCK:  # every launch shape
        got = FO.fused_ode_rollout_cuda(*args, solver, rows_per_block=rows)
        torch.cuda.synchronize()
        assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0)), rows
    assert FO.fused_ode_rollout.launches == before + len(F.ROWS_PER_BLOCK)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("xd,n_tail", ODE_SHAPES)
def test_ode_bwd_kernel_matches_plain_on_card(solver, xd, n_tail):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    s_de, weights, x0, dt = ode_inputs(37, 64, 128, xd, n_tail, dev="cuda")
    sol = torch.cat([x0[None], FO.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)])
    rng = np.random.default_rng(1)
    cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32), device="cuda")
    r_s, r_w, r_x0 = VO.fused_ode_rollout_bwd_plain(
        s_de.double(), _double(weights), dt, sol.double(), cot.double(), solver)
    flat = lambda g_s, g_w, g_x0: [g_s, g_x0] + VO.flatten_weights(g_w)
    before = VO.fused_ode_rollout_bwd.launches
    got = flat(*VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
    again = flat(*VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
    torch.cuda.synchronize()
    for k, (g, g2, r) in enumerate(zip(got, again, flat(r_s, r_w, r_x0))):
        scale = r.abs().max().item()
        assert scale > 0, k
        assert torch.equal(g, g2), k
        assert (g.double() - r).abs().max() <= 1e-4 * scale, k
    assert VO.fused_ode_rollout_bwd.launches == before + 2


@pytest.mark.gpu
def test_ode_kernels_refuse_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    s_de, weights, x0, dt = ode_inputs(4, 12, 32, 2, 3, dev="cuda")
    with pytest.raises(ValueError, match="float32"):
        FO.fused_ode_rollout_cuda(s_de, weights, x0.double(), dt)
    with pytest.raises(ValueError, match="shape"):
        FO.fused_ode_rollout_cuda(s_de, weights, x0, dt[:, :3].contiguous())
    with pytest.raises(ValueError, match="layers"):
        FO.fused_ode_rollout_cuda(s_de, dict(weights, de_tail=weights["de_tail"] * 3), x0, dt)
    sol = torch.cat([x0[None], FO.fused_ode_rollout(s_de, weights, x0, dt)])
    with pytest.raises(ValueError, match="shape"):
        VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, sol[:12].contiguous())


def _hold_fwd(got, again, ref):
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("h", [40, 128, 200])  # 200: two 128-wide chunks, weights from L2
@pytest.mark.parametrize("batch", [1, 5, 64, 67, 133, 1024])  # one row to a fleet (8 rows a block)
def test_noencode_fwd_kernels_match_plain_across_batches_on_card(batch, h, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    # events in rows 1 and 3 at step 2, in every row at step 9, in row 0 at
    # the last step (rollout_inputs); the launch shape the wrappers choose
    args = rollout_inputs(batch, 16, h, seed=batch, dev="cuda")
    ref = F.fused_dae_rollout_packed_plain(*args, solver)
    _hold_fwd(F.fused_dae_rollout_packed_cuda(*args, solver), F.fused_dae_rollout_packed_cuda(*args, solver), ref)
    args = ode_inputs(batch, 16, h, 2, 3, seed=batch, dev="cuda")
    ref = FO.fused_ode_rollout_plain(*args, solver)
    _hold_fwd(FO.fused_ode_rollout_cuda(*args, solver), FO.fused_ode_rollout_cuda(*args, solver), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_noencode_fwd_kernels_match_plain_at_each_launch_shape_on_card(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    # every rows-a-block the wrappers can choose, at h=200 and at the ODE
    # encode shape (the wide readout), rows past the batch in the last tile
    args = rollout_inputs(13, 16, 200, seed=rows, dev="cuda")
    ref = F.fused_dae_rollout_packed_plain(*args, "rk4")
    got = F.fused_dae_rollout_packed_cuda(*args, "rk4", rows_per_block=rows)
    _hold_fwd(got, F.fused_dae_rollout_packed_cuda(*args, "rk4", rows_per_block=rows), ref)
    for h, xd, n_tail in ((200, 2, 3), (128, 128, 1)):
        args = ode_inputs(13, 16, h, xd, n_tail, seed=rows, dev="cuda")
        ref = FO.fused_ode_rollout_plain(*args, "midpoint")
        got = FO.fused_ode_rollout_cuda(*args, "midpoint", rows_per_block=rows)
        _hold_fwd(got, FO.fused_ode_rollout_cuda(*args, "midpoint", rows_per_block=rows), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("h,batch", [(300, 1024), (1500, 1), (3000, 1)])
def test_noencode_fwd_kernels_run_widths_beyond_shared_memory_on_card(h, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    # h=300 at B=1024: 8 rows a block do not fit shared memory, the kernels
    # take fewer; h=1500 (DAE) and 3000 (both): one row's buffers do not
    # fit either and live in global memory
    args = rollout_inputs(batch, 16, h, seed=h, dev="cuda")
    ref = F.fused_dae_rollout_packed_plain(*args, "rk4")
    _hold_fwd(F.fused_dae_rollout_packed_cuda(*args, "rk4"), F.fused_dae_rollout_packed_cuda(*args, "rk4"), ref)
    args = ode_inputs(batch, 16, h, 2, 3, seed=h, dev="cuda")
    ref = FO.fused_ode_rollout_plain(*args, "rk4")
    _hold_fwd(FO.fused_ode_rollout_cuda(*args, "rk4"), FO.fused_ode_rollout_cuda(*args, "rk4"), ref)


@pytest.mark.gpu
def test_noencode_fwd_kernels_are_bit_identical_on_relaunch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(64, 100, 128, seed=3, dev="cuda")
    got = F.fused_dae_rollout_packed_cuda(*args, "rk4")
    assert torch.isfinite(got).all() and torch.equal(got, F.fused_dae_rollout_packed_cuda(*args, "rk4"))
    args = ode_inputs(64, 100, 128, 2, 3, seed=3, dev="cuda")
    got = FO.fused_ode_rollout_cuda(*args, "rk4")
    assert torch.isfinite(got).all() and torch.equal(got, FO.fused_ode_rollout_cuda(*args, "rk4"))


def dae_bwd_against_float64(args, solver, seed=1):
    """Kernel 2 twice and the float64 plain walk on the same inputs (the
    solution from the plain forward, unit-scale cotangents): the kernel's
    outputs, the relaunch's and the walk's, as flat lists."""
    packed = F.fused_dae_rollout_packed_plain(*args, solver)
    Tm1, B, n_out = packed.shape  # n_out = xd + id
    rng = np.random.default_rng(seed)
    cot = torch.tensor(rng.standard_normal((Tm1 + 1, B, n_out)).astype(np.float32), device="cuda")
    streams, weights, x0, i0, aux = args
    ref = _bwd_flat(V.fused_dae_rollout_bwd_plain(
        _double(streams), _double(weights), x0.double(), i0.double(), aux, packed.double(),
        cot.double(), solver))
    got = _bwd_flat(V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver))
    again = _bwd_flat(V.fused_dae_rollout_bwd_cuda(*args, packed, cot, solver))
    torch.cuda.synchronize()
    return got, again, ref


def ode_bwd_against_float64(args, solver, seed=1):
    """Kernel 4 twice and the float64 plain walk, as
    :func:`dae_bwd_against_float64`."""
    s_de, weights, x0, dt = args
    sol = torch.cat([x0[None], FO.fused_ode_rollout_plain(s_de, weights, x0, dt, solver)])
    rng = np.random.default_rng(seed)
    cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32), device="cuda")
    flat = lambda g_s, g_w, g_x0: [g_s, g_x0] + VO.flatten_weights(g_w)
    ref = flat(*VO.fused_ode_rollout_bwd_plain(s_de.double(), _double(weights), dt, sol.double(),
                                               cot.double(), solver))
    got = flat(*VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
    again = flat(*VO.fused_ode_rollout_bwd_cuda(s_de, weights, dt, sol, cot, solver))
    torch.cuda.synchronize()
    return got, again, ref


def _hold(got, again, ref):
    for k, (g, g2, r) in enumerate(zip(got, again, ref)):
        scale = r.abs().max().item()
        assert scale > 0, k
        assert torch.equal(g, g2), k
        assert (g.double() - r).abs().max() <= 1e-4 * scale, k


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("h", [40, 128])
@pytest.mark.parametrize("batch", [1, 5, 64, 67, 133])  # one row to more rows than a 132-SM card has SMs
def test_noencode_bwd_kernels_match_plain_across_batches_on_card(batch, h, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    # events in rows 1 and 3 at step 2, in every row at step 9, in row 0 at
    # the walk's first step (rollout_inputs)
    _hold(*dae_bwd_against_float64(rollout_inputs(batch, 16, h, seed=batch, dev="cuda"), solver))
    _hold(*ode_bwd_against_float64(ode_inputs(batch, 16, h, 2, 3, seed=batch, dev="cuda"), solver))


@pytest.mark.gpu
def test_noencode_bwd_kernels_take_a_fleet_batch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    # B=1024 in one launch of each kernel (the walk's 1024 blocks run one an SM at a
    # time, about eight waves)
    _hold(*dae_bwd_against_float64(rollout_inputs(1024, 12, 128, seed=11, dev="cuda"), "rk4"))
    _hold(*ode_bwd_against_float64(ode_inputs(1024, 12, 128, 2, 3, seed=11, dev="cuda"), "rk4"))


# the folded batch of multiple shooting, K=20 windows of B=64: 1 280 rows
# (the forwards' 8-row tiles in two waves of a 132-SM card, the walks in
# about ten), events at a window's first step (step 0 in the even rows)
# beside rollout_inputs' own; the motor and AVR shapes and the
# direct-encode shapes (xd = h, one tail layer)
@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("shape", ["raw", "encode"])
def test_noencode_kernels_match_plain_at_the_folded_multishoot_batch_on_card(shape, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dae_shape, ode_shape = ((3, 2, 3), (2, 3)) if shape == "raw" else ((128, 128, 1), (128, 1))
    xd, idim, n_tail = dae_shape
    streams, weights, x0, i0, aux = rollout_inputs(1280, 6, 128, xd, idim, seed=20, dev="cuda", n_tail=n_tail)
    args = (streams, weights, x0, i0, with_first_step_events(aux))
    ref = F.fused_dae_rollout_packed_plain(*args, solver)
    _hold_fwd(F.fused_dae_rollout_packed_cuda(*args, solver), F.fused_dae_rollout_packed_cuda(*args, solver), ref)
    _hold(*dae_bwd_against_float64(args, solver))
    args = ode_inputs(1280, 6, 128, *ode_shape, seed=20, dev="cuda")
    ref = FO.fused_ode_rollout_plain(*args, solver)
    _hold_fwd(FO.fused_ode_rollout_cuda(*args, solver), FO.fused_ode_rollout_cuda(*args, solver), ref)
    _hold(*ode_bwd_against_float64(args, solver))


@pytest.mark.gpu
def test_noencode_bwd_kernels_are_bit_identical_on_relaunch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    for got, again in (dae_bwd_against_float64(rollout_inputs(64, 100, 128, seed=3, dev="cuda"), "rk4")[:2],
                       ode_bwd_against_float64(ode_inputs(64, 100, 128, 2, 3, seed=3, dev="cuda"), "rk4")[:2]):
        for k, (g, g2) in enumerate(zip(got, again)):
            assert torch.equal(g, g2), k


def _seeded_like(bufs, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen, device="cuda") if k != "parts" else v
            for k, v in bufs.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_noencode_contractions_match_plain_on_card(solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(67, 40, 128, seed=4, dev="cuda")
    packed = F.fused_dae_rollout_packed_plain(*args, solver)
    cot = torch.zeros(41, 67, 5, device="cuda")
    bufs = _seeded_like(V._launch_bwd(*args, packed, cot, solver, stages=0)[1], 5)
    g_w = V._launch_bwd(*args, packed, cot, solver, stages=4, bufs=bufs)[0][1]
    again = V._launch_bwd(*args, packed, cot, solver, stages=4, bufs=bufs)[0][1]
    R, E = 40 * 67, {"euler": 1, "rk4": 4}[solver] + 2
    ev = args[4][..., 1].reshape(R) > 0
    ref = V.contract_plain(bufs["res"].view(E, 3, R, 128).double(), bufs["gres"].view(E, 3, R, 128).double(),
                           bufs["gy"].view(E, R, 3).double(), bufs["xin"].view(E, R, 5).double(), ev,
                           (3, 3), 3, 2)
    torch.cuda.synchronize()
    for g, g2, r in zip(V.flatten_weights(g_w)[0], V.flatten_weights(again)[0], V.flatten_weights(ref)[0]):
        assert torch.equal(g, g2)
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()
    s_de, weights, x0, dt = ode_inputs(67, 40, 128, 2, 3, seed=6, dev="cuda")
    sol = torch.zeros(41, 67, 2, device="cuda")
    bufs = _seeded_like(VO._launch_bwd(s_de, weights, dt, sol, sol, solver, stages=0)[1], 7)
    g_w = VO._launch_bwd(s_de, weights, dt, sol, sol, solver, stages=4, bufs=bufs)[0][1]
    S = E - 2
    ref = VO.contract_plain(bufs["res"].view(S, 3, R, 128).double(), bufs["gres"].view(S, 3, R, 128).double(),
                            bufs["gy"].view(S, R, 2).double(), bufs["xin"].view(S, R, 2).double(), 3, 2)
    torch.cuda.synchronize()
    for g, r in zip(VO.flatten_weights(g_w), VO.flatten_weights(ref)):
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.gpu
def test_noencode_recompute_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(67, 16, 128, seed=8, dev="cuda")
    packed = F.fused_dae_rollout_packed_plain(*args, "rk4")
    cot = torch.zeros(17, 67, 5, device="cuda")
    bufs = V._launch_bwd(*args, packed, cot, "rk4", stages=1)[1]
    res, xin = V.recompute_plain(*args, packed, "rk4")
    torch.cuda.synchronize()
    got = bufs["res"].view(res.shape)
    assert torch.all((got[:-1] - res[:-1]).abs() <= 1e-4 * res[:-1].abs().clamp(min=1.0))
    ev = args[4][..., 1].reshape(-1) > 0
    assert torch.all((got[-1][:, ev] - res[-1][:, ev]).abs() <= 1e-4 * res[-1][:, ev].abs().clamp(min=1.0))
    s_de, weights, x0, dt = ode_inputs(67, 16, 128, 2, 3, seed=9, dev="cuda")
    sol = torch.cat([x0[None], FO.fused_ode_rollout_plain(s_de, weights, x0, dt, "rk4")])
    bufs = VO._launch_bwd(s_de, weights, dt, sol, sol, "rk4", stages=1)[1]
    res, xin = VO.recompute_plain(s_de, weights, dt, sol, "rk4")
    torch.cuda.synchronize()
    assert torch.all((bufs["res"].view(res.shape) - res).abs() <= 1e-4 * res.abs().clamp(min=1.0))
    assert torch.all((bufs["xin"].view(xin.shape) - xin).abs() <= 1e-4 * xin.abs().clamp(min=1.0))


# the wide kernels: h=136 and 200 (padded width 256), 512 (four 128-wide
# chunks of every layer), the ODE's encode shape xd = h with one tail layer
@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("h", [136, 200, 512])
@pytest.mark.parametrize("batch", [1, 67, 133])
def test_noencode_bwd_kernels_match_plain_at_wide_widths_on_card(batch, h, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    _hold(*dae_bwd_against_float64(rollout_inputs(batch, 12, h, seed=batch, dev="cuda"), solver))
    _hold(*ode_bwd_against_float64(ode_inputs(batch, 12, h, 2, 3, seed=batch, dev="cuda"), solver))
    _hold(*ode_bwd_against_float64(ode_inputs(batch, 12, h, h, 1, seed=batch, dev="cuda"), solver))


# the direct-encode DAE's latent shape: xd = id = h, one tail layer a net
# (the DE's first layer 2h wide: the wide kernels, padded width 256 at
# h=128, 512 at h=200; both readouts h wide, nothing folds)
@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("h", [128, 200])
@pytest.mark.parametrize("batch", [1, 67, 133])
def test_dae_kernels_match_plain_at_the_encode_shape_on_card(batch, h, solver):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(batch, 16, h, h, h, seed=batch, dev="cuda", n_tail=1)
    ref = F.fused_dae_rollout_packed_plain(*args, solver)
    _hold_fwd(F.fused_dae_rollout_packed_cuda(*args, solver), F.fused_dae_rollout_packed_cuda(*args, solver), ref)
    _hold(*dae_bwd_against_float64(args, solver))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [136, 256])
def test_noencode_wide_recompute_and_contraction_match_plain_on_card(h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(67, 16, h, seed=8, dev="cuda")
    packed = F.fused_dae_rollout_packed_plain(*args, "rk4")
    cot = torch.zeros(17, 67, 5, device="cuda")
    bufs = V._launch_bwd(*args, packed, cot, "rk4", stages=1)[1]
    res, _ = V.recompute_plain(*args, packed, "rk4")
    torch.cuda.synchronize()
    got = bufs["res"].view(res.shape)
    assert torch.all((got[:-1] - res[:-1]).abs() <= 1e-4 * res[:-1].abs().clamp(min=1.0))
    bufs = _seeded_like(bufs, 3)
    g_w = V._launch_bwd(*args, packed, cot, "rk4", stages=4, bufs=bufs)[0][1]
    R, E = 16 * 67, 6
    ev = args[4][..., 1].reshape(R) > 0
    ref = V.contract_plain(bufs["res"].view(E, 3, R, h).double(), bufs["gres"].view(E, 3, R, h).double(),
                           bufs["gy"].view(E, R, 3).double(), bufs["xin"].view(E, R, 5).double(), ev,
                           (3, 3), 3, 2)
    torch.cuda.synchronize()
    for g, r in zip(V.flatten_weights(g_w)[0], V.flatten_weights(ref)[0]):
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()


def cw_inputs(B, Tm1, h, xd, zd, seed=0, dev="cpu"):
    """Seeded channel-wise rollout inputs in the port's layout
    (``utils.cw_inputs.seeded_inputs``: lecun-scaled weights, per-row step
    sizes) on ``dev``."""
    streams, weights, x0, dt = seeded_inputs(B, Tm1, h, xd, zd, seed)
    weights = FC.unflatten_weights([a.to(dev) for a in FC.flatten_weights(weights)])
    return {k: v.to(dev) for k, v in streams.items()}, weights, x0.to(dev), dt.to(dev)


# (xd, zd): the AVR ODE's channels and the motor DAE's
CW_SHAPES = [(2, 2), (3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("xd,zd", CW_SHAPES)
@pytest.mark.parametrize("h", [40, 128])
def test_cw_kernel_matches_plain_on_card(solver, xd, zd, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = cw_inputs(37, 32, h, xd, zd, dev="cuda")
    ref = FC.fused_cw_rollout_plain(*args, solver)
    before = FC.fused_cw_rollout.launches
    got = FC.fused_cw_rollout_cuda(*args, solver)
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))
    assert FC.fused_cw_rollout.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("xd,zd", CW_SHAPES)
def test_cw_bwd_kernel_matches_plain_on_card(solver, xd, zd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    streams, weights, x0, dt = cw_inputs(5, 16, 128, xd, zd, dev="cuda")
    sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)])
    rng = np.random.default_rng(1)
    cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32), device="cuda")
    r_s, r_w, r_x0 = VC.fused_cw_rollout_bwd_plain(
        {k: v.double() for k, v in streams.items()},
        FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)]),
        dt, sol.double(), cot.double(), solver)
    flat = lambda g_s, g_w, g_x0: [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)
    before = VC.fused_cw_rollout_bwd.launches
    got = flat(*VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
    again = flat(*VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
    torch.cuda.synchronize()
    for k, (g, g2, r) in enumerate(zip(got, again, flat(r_s, r_w, r_x0))):
        scale = r.abs().max().item()
        assert scale > 0, k
        assert torch.equal(g, g2), k
        assert (g.double() - r).abs().max() <= 1e-4 * scale, k
    assert VC.fused_cw_rollout_bwd.launches == before + 2


def cw_bwd_against_float64(streams, weights, x0, dt, solver, seed=1):
    """Kernel 6 twice and the float64 plain walk on the same inputs (the
    solution from the plain forward, unit-scale cotangents): returns the
    kernel's outputs, the relaunch's and the walk's, as flat lists."""
    sol = torch.cat([x0[None], FC.fused_cw_rollout_plain(streams, weights, x0, dt, solver)])
    rng = np.random.default_rng(seed)
    cot = torch.tensor(rng.standard_normal(tuple(sol.shape)).astype(np.float32), device=sol.device)
    r_s, r_w, r_x0 = VC.fused_cw_rollout_bwd_plain(
        {k: v.double() for k, v in streams.items()},
        FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)]),
        dt, sol.double(), cot.double(), solver)
    flat = lambda g_s, g_w, g_x0: [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)
    got = flat(*VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
    again = flat(*VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, cot, solver))
    torch.cuda.synchronize()
    return got, again, flat(r_s, r_w, r_x0)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [40, 128])
@pytest.mark.parametrize("batch", [1, 5, 33, 64, 67])  # one to more than 132 / 2 blocks
def test_cw_kernels_match_plain_across_batches_on_card(batch, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = cw_inputs(batch, 8, h, 3, 1, seed=batch, dev="cuda")
    ref = FC.fused_cw_rollout_plain(*args, "rk4")
    got = FC.fused_cw_rollout_cuda(*args, "rk4")
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))
    got, again, ref = cw_bwd_against_float64(*args, "rk4")
    for k, (g, g2, r) in enumerate(zip(got, again, ref)):
        scale = r.abs().max().item()
        assert scale > 0, k
        assert torch.equal(g, g2), k
        assert (g.double() - r).abs().max() <= 1e-4 * scale, k


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_cw_kernels_match_plain_at_each_cluster_size_on_card(cluster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = cw_inputs(5, 8, 128, 2, 2, seed=cluster, dev="cuda")
    ref = FC.fused_cw_rollout_plain(*args, "midpoint")
    got = FC._launch(*args, "midpoint", cluster)
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs().clamp(min=1.0))
    streams, weights, x0, dt = args
    sol = torch.cat([x0[None], ref])
    cot = torch.tensor(np.random.default_rng(cluster).standard_normal(tuple(sol.shape)).astype(np.float32),
                       device="cuda")
    flat = lambda g_s, g_w, g_x0: [g_s["fz"], g_s["s_constV"], g_x0] + FC.flatten_weights(g_w)
    got = flat(*VC._launch_bwd(streams, weights, dt, sol, cot, "midpoint", cluster))
    one = flat(*VC._launch_bwd(streams, weights, dt, sol, cot, "midpoint", 1))
    ref = flat(*VC.fused_cw_rollout_bwd_plain(
        {k: v.double() for k, v in streams.items()},
        FC.unflatten_weights([a.double() for a in FC.flatten_weights(weights)]),
        dt, sol.double(), cot.double(), "midpoint"))
    torch.cuda.synchronize()
    for k, (g, g1, r) in enumerate(zip(got, one, ref)):
        assert (g.double() - r).abs().max() <= 1e-4 * r.abs().max(), k
        # a cluster splits each output's work, not its sum: the same bits
        assert torch.equal(g, g1), k


@pytest.mark.gpu
def test_cw_bwd_kernel_is_bit_identical_on_relaunch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    got, again, _ = cw_bwd_against_float64(*cw_inputs(64, 32, 128, 2, 2, seed=3, dev="cuda"), "rk4")
    for k, (g, g2) in enumerate(zip(got, again)):
        assert torch.equal(g, g2), k


@pytest.mark.gpu
@pytest.mark.parametrize("rows,xd,h", [(1, 2, 128), (1000, 3, 40), (5000, 2, 128)])
def test_cw_pair_contraction_matches_plain_on_card(rows, xd, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(rows)
    pairs = torch.tensor(rng.standard_normal((rows, 4, 2, xd, h)).astype(np.float32), device="cuda")
    before = VC.contract_channel_pairs_cuda.launches
    got = VC.contract_channel_pairs_cuda(pairs)
    again = VC.contract_channel_pairs_cuda(pairs)
    torch.cuda.synchronize()
    assert VC.contract_channel_pairs_cuda.launches == before + 2
    for g, g2, r in zip(got, again, VC.contract_channel_pairs_plain(pairs.double())):
        assert g.shape == r.shape
        assert torch.equal(g, g2)
        assert (g.double() - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.gpu
def test_cw_kernels_refuse_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    streams, weights, x0, dt = cw_inputs(4, 6, 32, 2, 2, dev="cuda")
    with pytest.raises(ValueError, match="float32"):
        FC.fused_cw_rollout_cuda(streams, weights, x0.double(), dt)
    with pytest.raises(ValueError, match="shape"):
        FC.fused_cw_rollout_cuda(streams, weights, x0, dt[:, :3].contiguous())
    with pytest.raises(ValueError, match="h <= 128"):
        FC.fused_cw_rollout_cuda(*cw_inputs(2, 3, 136, 2, 2, dev="cuda"))
    sol = torch.cat([x0[None], FC.fused_cw_rollout(streams, weights, x0, dt)])
    with pytest.raises(ValueError, match="shape"):
        VC.fused_cw_rollout_bwd_cuda(streams, weights, dt, sol, sol[:6].contiguous())


# ---------------------------------------------------------------- TF-x mode


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("h", [128, 200])  # 200: the forward's 128-wide chunks, the backward's wide kernels
@pytest.mark.parametrize("batch", [1, 67, 133])  # 133: the forward takes two rows a block
def test_tfx_kernels_match_plain_on_card(batch, h, solver):
    """Kernels 1 and 2 in their TF-x mode (teacher forcing of x) against
    the plain versions: the forward within 1e-4 * max(1, |plain|), the
    backward against the float64 plain walk on every output tensor, with
    the true states' cotangents and without them (events at step 0 in the
    even rows: under TF-x only they carry the rolled x0's cotangent). At
    B=1 the one row has that event, which takes its i carry, so g_i0 is 0
    there: a tensor whose plain value is 0 must be 0 in the kernel too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    args = rollout_inputs(batch, 16, h, seed=batch + h, dev="cuda")
    args = (*args[:4], with_first_step_events(args[4]))
    x_true = true_states(16, batch, 3, seed=batch).cuda()
    ref = F.fused_dae_rollout_packed_plain(*args, solver, x_true)
    got = F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true)
    _hold_fwd(got, F.fused_dae_rollout_packed_cuda(*args, solver, x_true=x_true), ref)
    rng = np.random.default_rng(batch)
    cot = torch.tensor(rng.standard_normal((17, batch, 5)).astype(np.float32), device="cuda")
    streams, weights, x0, i0, aux = args
    for g_true in (True, False):
        flat = lambda g: _bwd_flat(g[:4]) + (list(g[4]) if g_true else [])
        want = flat(V.fused_dae_rollout_bwd_plain(_double(streams), _double(weights), x0.double(), i0.double(), aux,
                                                  ref.double(), cot.double(), solver, x_true.double(), g_true))
        run = lambda: flat(V.fused_dae_rollout_bwd_cuda(*args, ref, cot, solver, x_true, g_true))
        got, again = run(), run()
        zero = [k for k, r in enumerate(want) if not r.abs().max() > 0]
        assert zero == ([4] if batch == 1 else [])  # g_i0 at B=1
        for k in zero:
            assert not got[k].any() and torch.equal(got[k], again[k])
        keep = lambda gs: [g for k, g in enumerate(gs) if k not in zero]
        _hold(keep(got), keep(again), keep(want))
