"""Fused forward rollout of the semi-explicit neural DAE (counterpart of
``py_psnode_tpu/ops/fused_dae.py``).

Scan-invariant layer-1 work is lifted out of the time loop: with the
skip-augmented input ``cat(init, u-init, u) @ W1 = init @ (Wa-Wb) +
u @ (Wb+Wc)``, the initial-state contribution and the known ``z``/``v``
input projections are computed for all steps as a few large matrix
products (:func:`precompute_streams`), leaving only the ``x``/``i``
projections and the tail layers in the sequential loop.

The loop itself runs in :func:`fused_dae_rollout`: on CUDA tensors it
launches the hand-written kernel ``csrc/fused_dae_rollout.cu`` (one launch
for the whole rollout, after a small one that pads the weights into a
scratch block), on CPU tensors it runs
:func:`fused_dae_rollout_packed_plain`, the same function as an eager
PyTorch loop. There is no fallback from the kernel to the plain version.
Under teacher forcing of ``x`` (``x_true``, the JAX package's ``tf_x``)
each step starts from the true state and the AE at t+1 reads the true
``x[t+1]``, while the event recompute still reads the rolled state.

The bf16 compute mode (``precision="bfloat16"``, JAX ``cast_compute``
:487): :func:`cast_compute` rounds the three streams and the 2-D weights to
bfloat16; the kernel and the plain version then round each product's
activation to bf16 and sum in float32 (:func:`~py_psnode_tpu_torch.ops.
noencode_bwd.dot`), biases, carries and ``dt`` staying float32. The mode
rides the streams' dtype. Under teacher forcing of ``x`` the true states
stay float32 and are rounded where a product reads them, as the rolled
states are. The kernel's bf16 mode is a build of its own
(``utils/cuda_build.py``: ``SPLIT_BF16``).

Not ported: lanes, and the TPU's time blocking with ``dt == 0`` padding
(scheduling that does not change the result).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from py_psnode_tpu_torch.models.funcs import elu
from py_psnode_tpu_torch.ops.noencode_bwd import dot, launch, pointer_array
from py_psnode_tpu_torch.utils import cuda_build

_ONE_THIRD = 1.0 / 3.0

_SOLVER_ALIASES = {"rk4_38": "rk4"}  # the plain registry's RK4 is the 3/8 rule
_FUSED_SOLVERS = ("euler", "midpoint", "rk4")
# solver codes of the CUDA launcher
_SOLVER_CODE = {"euler": 0, "midpoint": 1, "rk4": 2}
# kernel limits (csrc/noencode_bwd.cuh: kMaxTail; the forward kernels'
# rows-per-block instantiations)
MAX_TAIL = 8
ROWS_PER_BLOCK = (1, 2, 4, 8)
# TrainConfig.matmul_precision's values (the JAX package's); "bf16" is
# cast_compute's other name of "bfloat16"
PRECISIONS = ("default", "float32", "highest", "bfloat16", "bf16")


def normalize_solver(name) -> str:
    """Map registry solver names onto the fused dispatch set (``rk4_38`` →
    ``rk4``); reject unknown names with the valid choices."""
    s = _SOLVER_ALIASES.get(str(name).lower(), str(name).lower())
    if s not in _FUSED_SOLVERS:
        raise ValueError(
            f"fused kernels support solvers {sorted(_FUSED_SOLVERS + tuple(_SOLVER_ALIASES))}, "
            f"got {name!r}"
        )
    return s


def split_de_layer1(W1: torch.Tensor, b1: torch.Tensor, d_u: int):
    """``cat(init, u-init, u) @ W1 + b1 = init @ (Wa-Wb) + u @ (Wb+Wc) + b1``."""
    Wa, Wb, Wc = W1[:d_u], W1[d_u : 2 * d_u], W1[2 * d_u :]
    return Wa - Wb, Wb + Wc, b1


def mlp_tail_layers(subtree: Dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Ordered ``[(kernel, bias), ...]`` of ``dense_1..dense_{n-1}``: the
    layers after the (lifted) first layer of a flax-layout MLP subtree."""
    out = []
    k = 1
    while f"dense_{k}" in subtree:
        layer = subtree[f"dense_{k}"]
        out.append((layer["kernel"], layer["bias"]))
        k += 1
    return out


def precompute_streams(
    params: Dict,
    all_initial: torch.Tensor,
    z: torch.Tensor,
    v: torch.Tensor,
    z_step: torch.Tensor,
    v_step: torch.Tensor,
    dims: Tuple[int, int, int, int],
    de_path: Tuple[str, str] = ("de_func", "x_dot"),
    ae_path: Tuple[str, str] = ("ae_func", "i_calculator"),
):
    """Lift scan-invariant layer-1 work out of the loop.

    Args:
      params: flax-layout tree (``kernel [in, out]``) holding the DE/AE nets
        at the given paths (see :func:`py_psnode_tpu_torch.bridge.flax_params`).
      all_initial: ``[B, d_u]`` (d_u = xd+zd+vd+id).
      z, v: raw streams ``[T, B, *]`` (time-major).
      z_step, v_step: event-adjusted step streams ``[T-1, B, *]``.
      dims: ``(xd, zd, vd, id)``.

    Returns ``(streams, weights)`` for :func:`fused_dae_rollout`. The
    streams are ``s_de/s_ae/s_ae_ev [T-1, B, h]``; ``weights`` holds the
    dynamic layer-1 projections ``wx_de [xd, h]``, ``wi_de [id, h]``,
    ``gx_ae [xd, h]`` and the tail-layer lists ``de_tail``/``ae_tail``, all
    contiguous.
    """
    xd, zd, vd, idim = dims
    d_u = xd + zd + vd + idim
    de = params[de_path[0]][de_path[1]]
    ae = params[ae_path[0]][ae_path[1]]

    W1, b1 = de["dense_0"]["kernel"], de["dense_0"]["bias"]
    Winit, Wu, b1 = split_de_layer1(W1, b1, d_u)
    c_de = all_initial @ Winit + b1  # [B, h]
    s_de = c_de[None] + z_step @ Wu[xd : xd + zd] + v_step @ Wu[xd + zd : xd + zd + vd]

    G1, g1 = ae["dense_0"]["kernel"], ae["dense_0"]["bias"]
    # AE input is cat(init, x, z, v): init concatenated, not differenced
    Gx = G1[d_u : d_u + xd]
    Gz = G1[d_u + xd : d_u + xd + zd]
    Gv = G1[d_u + xd + zd :]
    c_ae = all_initial @ G1[:d_u] + g1
    s_ae = c_ae[None] + z[1:] @ Gz + v[1:] @ Gv  # AE at t+1 uses raw inputs
    s_ae_ev = c_ae[None] + z_step @ Gz + v_step @ Gv  # event-recompute inputs

    c = lambda a: a.contiguous()
    weights = dict(
        wx_de=c(Wu[:xd]),
        wi_de=c(Wu[xd + zd + vd :]),
        gx_ae=c(Gx),
        de_tail=[(c(W), c(b)) for W, b in mlp_tail_layers(de)],
        ae_tail=[(c(W), c(b)) for W, b in mlp_tail_layers(ae)],
    )
    streams = dict(s_de=c(s_de), s_ae=c(s_ae), s_ae_ev=c(s_ae_ev))
    return streams, weights


def is_bf16(precision: str) -> bool:
    """Whether ``precision`` selects the kernels' bf16 compute mode; raises
    ``ValueError`` for a name outside :data:`PRECISIONS`."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision in ("bfloat16", "bf16")


def cast_compute(streams: Dict, weights: Dict, precision: str):
    """The kernel's compute-precision mode (JAX ``fused_dae.py:487``):
    ``"bfloat16"`` rounds the three streams and the 2-D weights (``wx_de``,
    ``wi_de``, ``gx_ae``, both tails' ``W``) to bfloat16, the biases stay
    float32; any other precision of :data:`PRECISIONS` is the identity."""
    if not is_bf16(precision):
        return streams, weights
    bf = lambda a: a.to(torch.bfloat16)
    streams = {k: bf(v) for k, v in streams.items()}
    weights = dict(
        wx_de=bf(weights["wx_de"]), wi_de=bf(weights["wi_de"]), gx_ae=bf(weights["gx_ae"]),
        de_tail=[(bf(W), b) for W, b in weights["de_tail"]],
        ae_tail=[(bf(W), b) for W, b in weights["ae_tail"]],
    )
    return streams, weights


def pack_aux(dt: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """Pack ``dt [T-1, B, 1]`` and the event mask ``ev [T-1, B]`` into one
    ``[T-1, B, 2]`` float32 stream ``(dt, ev)``."""
    return torch.cat([dt.float(), ev.float()[..., None]], dim=-1).contiguous()


def unpack_solution(packed, x0, i0, Tm1):
    """Packed rollout ``[T-1, B, xd+id]`` → ``(x_solution [T, B, xd],
    i_solution [T, B, id])`` including the initial row."""
    xd = x0.shape[-1]
    x_solution = torch.cat([x0[None], packed[:Tm1, :, :xd]], dim=0)
    i_solution = torch.cat([i0[None], packed[:Tm1, :, xd:]], dim=0)
    return x_solution, i_solution


def mlp_tail_fwd(h1: torch.Tensor, tail: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Apply the tail layers to the (pre-activation) first hidden layer
    (each product by :func:`~py_psnode_tpu_torch.ops.noencode_bwd.dot`)."""
    h = elu(h1)
    for W, b in tail[:-1]:
        h = elu(dot(h, W) + b)
    W, b = tail[-1]
    return dot(h, W) + b


def fused_dae_rollout_packed_plain(
    streams: Dict, weights: Dict, x0, i0, aux, solver: str = "rk4", x_true=None
) -> torch.Tensor:
    """The rollout as an eager PyTorch loop on any device: the plain
    version of the CUDA kernel. Returns the packed ``[T-1, B, xd+id]``
    rows ``cat(x, i)`` of steps 1..T-1. With ``x_true [T, B, xd]`` (teacher
    forcing of ``x``) step t starts from ``x_true[t]`` and the AE at t+1
    reads ``x_true[t+1]``; the event recompute and the rows written stay
    the rolled ones (JAX ``fused_dae.py:424-484``). bfloat16 streams and
    weights (:func:`cast_compute`): the bf16 compute mode."""
    solver = normalize_solver(solver)
    s_de, s_ae, s_ae_ev = streams["s_de"], streams["s_ae"], streams["s_ae_ev"]
    wx_de, wi_de, gx_ae = weights["wx_de"], weights["wi_de"], weights["gx_ae"]
    de_tail, ae_tail = weights["de_tail"], weights["ae_tail"]
    Tm1, B, _ = s_de.shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    ev = aux[..., 1:2] > 0.0
    any_ev = ev.any(dim=1)[:, 0].tolist()  # one host read for all steps
    out = torch.empty(Tm1, B, xd + idim, dtype=torch.float32, device=s_de.device)
    ae_head = lambda x, s: mlp_tail_fwd(s + dot(x, gx_ae), ae_tail)
    x_c, i_c = x0, i0
    for t in range(Tm1):
        i_in = i_c
        if any_ev[t]:
            # event-step algebraic recompute at the rolled state, per row
            i_in = torch.where(ev[t], ae_head(x_c, s_ae_ev[t]), i_c)
        i_proj = dot(i_in, wi_de)
        f = lambda x: mlp_tail_fwd(s_de[t] + dot(x, wx_de) + i_proj, de_tail)
        dt = aux[t, :, 0:1]
        xs = x_c if x_true is None else x_true[t]  # the step's start
        if solver == "euler":
            x1 = xs + dt * f(xs)
        elif solver == "midpoint":
            f0 = f(xs)
            x1 = xs + dt * f(xs + f0 * (0.5 * dt))
        else:  # rk4, Kutta's 3/8 rule
            k1 = f(xs)
            k2 = f(xs + dt * k1 * _ONE_THIRD)
            k3 = f(xs + dt * (k2 - k1 * _ONE_THIRD))
            k4 = f(xs + dt * (k1 - k2 + k3))
            x1 = xs + (k1 + 3.0 * (k2 + k3) + k4) * dt * 0.125
        i1 = ae_head(x1 if x_true is None else x_true[t + 1], s_ae[t])
        out[t, :, :xd] = x1
        out[t, :, xd:] = i1
        x_c, i_c = x1, i1
    return out


def bind_rollout(lib: ctypes.CDLL, bf16: bool = False):
    """``(launcher, scratch floats, error string, TF-x launcher, TF-x
    scratch floats, bf16)``: the C functions of a build of
    ``csrc/fused_dae_rollout.cu`` (for the card or, in
    ``utils/host_build.py``, the host) with their signatures, the launchers
    those of the bf16 compute mode where ``bf16`` (the build with
    ``cuda_build.BF16_DEFINE``)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    args = [
        P, P, P, P,  # s_de, s_ae, s_ae_ev, aux
        P, P,  # x0, i0
        P, P, PP, PP, I,  # wx_de, wi_de, de tail W, b, count
        P, PP, PP, I,  # gx_ae, ae tail W, b, count
        P, P,  # scratch, sol
        I, I, I, I, I,  # Tm1, B, h, xd, id
        I, I,  # solver, rows per block
    ]
    fn = lib.psn_fused_dae_rollout_bf16 if bf16 else lib.psn_fused_dae_rollout_f32
    fn.argtypes = args + [P]  # stream
    fn.restype = ctypes.c_int
    scratch = lib.psn_fused_dae_rollout_scratch
    scratch.argtypes = [I] * 7  # B, h, xd, id, DE and AE tail layers, rows per block
    scratch.restype = ctypes.c_longlong
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    tf = lib.psn_fused_dae_rollout_tfx_bf16 if bf16 else lib.psn_fused_dae_rollout_tfx_f32
    tf.argtypes = args + [P, P, P]  # x_true[:-1], x_true[1:], stream
    tf.restype = ctypes.c_int
    tf_scratch = lib.psn_fused_dae_rollout_tfx_scratch
    tf_scratch.argtypes = [I] * 7
    tf_scratch.restype = ctypes.c_longlong
    return fn, scratch, err, tf, tf_scratch, bf16


@functools.lru_cache(maxsize=None)
def _launcher(bf16: bool = False):
    """The C launcher of ``csrc/fused_dae_rollout.cu`` in the compute mode of
    ``bf16`` (:func:`bind_rollout`)."""
    return bind_rollout(cuda_build.load("fused_dae_rollout", bf16), bf16)


def default_launch(batch: int, n_sms: int) -> int:
    """Rows per block for ``batch`` rows on a card with ``n_sms``
    multiprocessors (both forward kernels): the fewest of
    :data:`ROWS_PER_BLOCK` that keep the grid in one wave of one block an SM
    (the kernels' shared memory holds one block an SM), else the most. One
    row a block runs the folded chain, the fastest a row; a tile of rows
    shares each weight load, which pays once rows outnumber SMs (the B=1024
    sweep of ``chip_smoke.py --sweep``, PERF.md)."""
    for rows in ROWS_PER_BLOCK:
        if -(-batch // rows) <= n_sms:
            return rows
    return ROWS_PER_BLOCK[-1]


def launch_rows(dev: torch.device, B: int, rows_per_block=None) -> int:
    """This call's rows per block: ``rows_per_block``, or
    :func:`default_launch` for ``dev``'s card (a 132-SM card's for a host
    build); raises unless it is one of :data:`ROWS_PER_BLOCK`."""
    if rows_per_block is None:
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
        return default_launch(B, n_sms)
    if rows_per_block not in ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block must be one of {ROWS_PER_BLOCK}, got {rows_per_block}")
    return int(rows_per_block)


def _check_kernel_inputs(streams, weights, x0, i0, aux, device_type: str = "cuda", x_true=None):
    """Raise unless the rollout's inputs (``x_true`` too, where given) are
    contiguous, on one CUDA device (or, for a host build of the kernels,
    ``device_type`` "cpu") and shaped as the kernels take them, and float32,
    or in the bf16 compute mode (bfloat16 streams) the streams and the 2-D
    weights bfloat16 and the rest float32. Returns whether the mode is
    bf16."""
    s_de = streams["s_de"]
    if s_de.device.type != device_type:
        raise ValueError(f"the CUDA rollout kernel takes CUDA tensors, got {s_de.device}")
    bf16 = s_de.dtype == torch.bfloat16
    low = {"s_de", "s_ae", "s_ae_ev", "wx_de", "wi_de", "gx_ae"}  # bfloat16 in the bf16 mode
    Tm1, B, h = s_de.shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    expect = {
        "s_de": (streams["s_de"], (Tm1, B, h)),
        "s_ae": (streams["s_ae"], (Tm1, B, h)),
        "s_ae_ev": (streams["s_ae_ev"], (Tm1, B, h)),
        "aux": (aux, (Tm1, B, 2)),
        "x0": (x0, (B, xd)),
        "i0": (i0, (B, idim)),
        "wx_de": (weights["wx_de"], (xd, h)),
        "wi_de": (weights["wi_de"], (idim, h)),
        "gx_ae": (weights["gx_ae"], (xd, h)),
    }
    if x_true is not None:
        expect["x_true"] = (x_true, (Tm1 + 1, B, xd))
    for net, out_w in (("de_tail", xd), ("ae_tail", idim)):
        tail = weights[net]
        if not 1 <= len(tail) <= MAX_TAIL:
            raise ValueError(f"{net} must hold 1..{MAX_TAIL} layers, got {len(tail)}")
        for k, (W, b) in enumerate(tail):
            n_out = out_w if k == len(tail) - 1 else h
            expect[f"{net}[{k}].W"] = (W, (h, n_out))
            expect[f"{net}[{k}].b"] = (b, (n_out,))
            low.add(f"{net}[{k}].W")
    for name, (a, shape) in expect.items():
        if a.device != s_de.device:
            raise ValueError(f"{name} is on {a.device}, the streams on {s_de.device}")
        want = torch.bfloat16 if bf16 and name in low else torch.float32
        if a.dtype != want:
            raise ValueError(f"{name} must be {want}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bf16


def fused_dae_rollout_packed_cuda(
    streams: Dict, weights: Dict, x0, i0, aux, solver: str = "rk4", rows_per_block=None, x_true=None,
) -> torch.Tensor:
    """Launch the CUDA kernel once for the whole rollout; returns the packed
    ``[T-1, B, xd+id]`` solution. ``rows_per_block`` (1, 2, 4, 8) is the
    most rows a block of this call takes (the kernel halves it where the
    rows' buffers do not fit shared memory), by default
    :func:`default_launch`; it does not change the result beyond float
    summation order. ``x_true [T, B, xd]``: the kernel's TF-x mode (a
    tile of rows even at one row a block: nothing folds). bfloat16 streams
    and weights (:func:`cast_compute`): the kernel's bf16 compute mode."""
    sol = _launch(streams, weights, x0, i0, aux, solver, rows_per_block, x_true=x_true)
    fused_dae_rollout.launches += 1
    return sol


def _launch(streams: Dict, weights: Dict, x0, i0, aux, solver: str, rows_per_block=None, launcher=None,
            host: bool = False, x_true=None) -> torch.Tensor:
    """Launch the forward through ``launcher`` (of :func:`bind_rollout`;
    the default build when None), in its TF-x mode where ``x_true`` is
    given; ``host``: a host build on CPU tensors
    (``utils/host_build.py``). Counts nothing:
    :func:`fused_dae_rollout_packed_cuda` is the entry; the phase clock and
    the host build launch their own builds."""
    solver = normalize_solver(solver)
    bf16 = _check_kernel_inputs(streams, weights, x0, i0, aux, "cpu" if host else "cuda", x_true)
    s_de = streams["s_de"]
    Tm1, B, h = s_de.shape
    xd, idim = x0.shape[-1], i0.shape[-1]
    rows = launch_rows(s_de.device, B, rows_per_block)
    fn, scratch_floats, err, fn_tf, scratch_tf, mode = launcher or _launcher(bf16)
    if mode != bf16:
        raise ValueError(f"a launcher bound for bf16={mode} got the {'bf16' if bf16 else 'float32'} mode's inputs")
    tf_args = ()
    if x_true is not None:
        fn, scratch_floats = fn_tf, scratch_tf
        tf_args = (x_true.data_ptr(), x_true[1:].data_ptr())
    de, ae = weights["de_tail"], weights["ae_tail"]
    n = scratch_floats(B, h, xd, idim, len(de), len(ae), rows)
    # must outlive the launch; sizes it refuses (n < 0) raise below
    scratch = torch.empty(max(n, 0), dtype=torch.float32, device=s_de.device)
    sol = torch.empty(Tm1, B, xd + idim, dtype=torch.float32, device=s_de.device)
    rc = launch(
        fn, s_de.device, s_de.data_ptr(), streams["s_ae"].data_ptr(), streams["s_ae_ev"].data_ptr(),
        aux.data_ptr(), x0.data_ptr(), i0.data_ptr(), weights["wx_de"].data_ptr(), weights["wi_de"].data_ptr(),
        pointer_array([W for W, _ in de]), pointer_array([b for _, b in de]), len(de),
        weights["gx_ae"].data_ptr(), pointer_array([W for W, _ in ae]), pointer_array([b for _, b in ae]), len(ae),
        scratch.data_ptr(), sol.data_ptr(), Tm1, B, h, xd, idim, _SOLVER_CODE[solver], rows, *tf_args,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused_dae_rollout kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    return sol


def fused_dae_rollout_packed(streams, weights, x0, i0, aux, solver="rk4", x_true=None):
    """Packed rollout on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, an error otherwise."""
    dev = streams["s_de"].device
    if dev.type == "cuda":
        return fused_dae_rollout_packed_cuda(streams, weights, x0, i0, aux, solver, x_true=x_true)
    if dev.type == "cpu":
        return fused_dae_rollout_packed_plain(streams, weights, x0, i0, aux, solver, x_true)
    raise ValueError(f"fused_dae_rollout runs on cuda or cpu tensors, got {dev}")


def fused_dae_rollout(
    streams: Dict,
    weights: Dict,
    x0: torch.Tensor,
    i0: torch.Tensor,
    dt: torch.Tensor,
    ev: torch.Tensor,
    solver: str = "rk4",
    precision: str = "default",
    x_true=None,
):
    """Run the fused rollout (forward only).

    Args:
      streams/weights: from :func:`precompute_streams`.
      x0: ``[B, xd]`` initial differential state (Init output).
      i0: ``[B, id]`` initial algebraic output (AE at t=0; at ``x_true[0]``
        under teacher forcing).
      dt: ``[T-1, B, 1]`` step sizes; ev: ``[T-1, B]`` event mask.
      precision: one of :data:`PRECISIONS`; ``"bfloat16"`` is the bf16
        compute mode (:func:`cast_compute`).
      x_true: ``[T, B, xd]`` true states, teacher forcing of ``x``: the
        step consumes ``x_true[t]`` and the AE at t+1 ``x_true[t+1]``,
        events still recompute from the rolled state.

    Returns ``(x_solution [T, B, xd], i_solution [T, B, id])`` including
    the initial row. ``fused_dae_rollout.launches`` counts kernel launches.
    """
    streams, weights = cast_compute(streams, weights, precision)
    Tm1 = streams["s_de"].shape[0]
    aux = pack_aux(dt, ev)
    packed = fused_dae_rollout_packed(
        streams, weights, x0.contiguous(), i0.contiguous(), aux, solver,
        None if x_true is None else x_true.contiguous(),
    )
    return unpack_solution(packed, x0, i0, Tm1)


fused_dae_rollout.launches = 0
