"""Fused forward rollout of the channel-wise family (counterpart of
``py_psnode_tpu/ops/fused_channelwise.py``: ``precompute_cw_streams`` :84,
``_cw_eval_multi`` :244, ``_fwd_kernel`` :258, ``_forward`` :493).

One evaluation of the channel-wise dynamics at the latent state ``xs [B,
xd, h]`` (``f_init`` and the z-features lifted out of the loop):

  * ``ext``: per channel ``c``, ``fx[c] = elu(xs[c] @ E0[c] + e0[c]) @ E1[c]
    + e1[c]``;
  * the vertical net on the rows ``(b, l)``: ``V[b, l, :] = ft[b, :, l]``
    with ``ft = cat(fx, fz[t])`` (``xd + zd`` channels),
    ``H0 = elu(V @ A + s_constV[b])``, ``H1 = elu(H0 @ W1 + b1)``,
    ``H2 = elu(H1 @ W2 + b2)``, ``O = H2 @ W3 + b3`` (``[h, xd]`` per row);
  * ``head``: per channel, the column ``O[b, :, c]`` through the same
    two-layer form as ``ext``.

The vertical first layer is folded (:func:`precompute_cw_streams`):
``cat(ft, f_init, ft - f_init) @ W0 = ft @ A + f_init @ S`` with ``A =
W0[:C] + W0[2C:]`` and ``S = W0[C:2C] - W0[2C:]``; the constant part
``s_constV = f_init @ S + b0`` is one ``[h, h]`` tile per batch row,
computed once per trajectory in PyTorch and differentiated by autograd.

The port's layouts are batch-major per step, as suits one CUDA block per
batch row: ``fz [T-1, B, zd, h]``, ``s_constV [B, h, h]`` (row ``l``,
column ``j``), ``x0 [B, xd, h]``, the solution rows ``[T-1, B, xd, h]``.
The TPU's ``[T-1, zd, B, h]`` streams and its sublane relayouts
(``_build_V``/``_unbuild_V``) are Mosaic scheduling and are not carried
over: in CUDA, building ``V`` is indexing.

:func:`fused_cw_rollout` runs the hand-written kernel
``csrc/fused_cw_rollout.cu`` on CUDA tensors (one launch for the whole
rollout, a cluster of blocks per batch row, the h x h x h products on the
tensor cores in 3xTF32) and :func:`fused_cw_rollout_plain`, the same
function as an eager PyTorch loop, on CPU tensors. There is no fallback from the kernel to the
plain version. The kernel takes ``h <= MAX_HIDDEN_FWD`` (the backward
``h <= MAX_HIDDEN_BWD``) and the model's vertical net of three tail
layers.

The bf16 compute mode (``precision="bfloat16"``; JAX ``_cast_cw`` :161 and
``_dot``): :func:`cast_cw` rounds the 2-D weights (``a``, the vertical
``W``s, the per-channel ``w0``/``w1`` of ``ext`` and ``head``) to
bfloat16; the biases, ``s_constV``, the z-features and the state stay
float32. Every product then rounds its activation operand (a per-channel
net's input, the features ``V``, an ``[h, h]`` activation) to bf16 and
sums in float32: the kernel (its ``kBf16`` instantiations, a build of their
own, ``utils/cuda_build.py``) and the plain version (:func:`cw_eval`'s
``bf16``) alike. The mode rides the weights' dtype. No weight is kept in
bf16 between calls: the bf16 weights are cast from the float32 ones at each
call, as in the JAX package, so the checkpoint bridge needs nothing more.

Not ported: the TPU's block and time choice (``choose_cw_blocks``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from py_psnode_tpu_torch.models.funcs import elu
from py_psnode_tpu_torch.ops.fused_dae import _SOLVER_CODE, is_bf16, normalize_solver
from py_psnode_tpu_torch.ops.fused_ode import _step_fwd, pointer_array
from py_psnode_tpu_torch.utils import cuda_build

# The widest h of the CUDA forward and of the backward: those the JAX
# package's fused channel-wise runs (its block choice, choose_cw_blocks :179,
# fails past them). Above 128 the kernels take their wide layout
# (csrc/cw_wide.cuh), the [h, h] tiles in a scratch in global memory.
MAX_HIDDEN_FWD = 724
MAX_HIDDEN_BWD = 572
N_VERT_TAIL = 3  # the vertical net's layers after the folded first one


def precompute_cw_streams(params: Dict, f_init: torch.Tensor, fz: torch.Tensor):
    """Fold the vertical first layer and collect the kernel's weights.

    Args:
      params: flax-layout tree with ``de_func`` (``xh_ext``, ``xh_dot_v``,
        ``xh_dot_head``).
      f_init: ``[B, C, h]`` features at the initial state (``C = xd + zd``).
      fz: ``[T-1, B, zd, h]`` event-adjusted z-features of every step.

    Returns ``(streams, weights)``: ``streams = {fz, s_constV [B, h, h]}``,
    ``weights = {a [C, h], vert [(W1, b1), (W2, b2), (W3, b3)], ext (w0,
    b0, w1, b1), head (w0, b0, w1, b1)}`` with the per-channel stacks as
    they are (``w [xd, h, h]``, ``b [xd, h]``). Every entry is contiguous
    and differentiable.
    """
    de = params["de_func"]
    vert = de["xh_dot_v"]
    C = f_init.shape[1]
    W0, b0 = vert["dense_0"]["kernel"], vert["dense_0"]["bias"]
    A = W0[:C] + W0[2 * C:]
    S = W0[C:2 * C] - W0[2 * C:]
    s_constV = torch.einsum("bcl,cj->blj", f_init, S) + b0
    stack = lambda net: tuple(de[net][k].contiguous() for k in ("w_0", "b_0", "w_1", "b_1"))
    weights = dict(
        a=A.contiguous(),
        vert=[(vert[f"dense_{k}"]["kernel"].contiguous(), vert[f"dense_{k}"]["bias"].contiguous())
              for k in range(1, N_VERT_TAIL + 1)],
        ext=stack("xh_ext"),
        head=stack("xh_dot_head"),
    )
    return dict(fz=fz.contiguous(), s_constV=s_constV.contiguous()), weights


def flatten_weights(weights: Dict) -> List[torch.Tensor]:
    """``[a, W1, b1, W2, b2, W3, b3, ext w0, b0, w1, b1, head w0, b0, w1,
    b1]``: the kernels' order and that of their gradient row."""
    flat = [weights["a"]]
    for W, b in weights["vert"]:
        flat += [W, b]
    return flat + list(weights["ext"]) + list(weights["head"])


def unflatten_weights(flat) -> Dict:
    n = 1 + 2 * N_VERT_TAIL
    return dict(a=flat[0], vert=[(flat[k], flat[k + 1]) for k in range(1, n, 2)],
                ext=tuple(flat[n:n + 4]), head=tuple(flat[n + 4:n + 8]))


def _round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even, as XLA's ``astype``), in
    ``t``'s own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


class RoundedProduct(torch.autograd.Function):
    """A product of the bf16 compute mode: ``a @ w`` (``a [..., K]``, ``w
    [K, N]``) or, ``per_channel``, ``einsum("bci,cio->bco", a, w)``, with
    ``a`` rounded to bf16 and ``w`` holding bf16 values, in ``a``'s dtype (a
    bf16 x bf16 product is exact in float32: the kernels' arithmetic up to
    summation order). Its VJP is the JAX package's (``_dot_nt``, ``_dot_t``
    with ``cdtype`` bfloat16): the activation's cotangent ``round(g) @
    w^T``, the weight's ``round(a)^T @ round(g)``, where autograd through
    the casts would round the cotangents it returns instead."""

    @staticmethod
    def forward(ctx, a, w, per_channel: bool):
        ra = _round(a)
        ctx.save_for_backward(ra, w)
        ctx.per_channel = per_channel
        return torch.einsum("bci,cio->bco", ra, w) if per_channel else ra @ w

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ra, w = ctx.saved_tensors
        rg = _round(g)
        if ctx.per_channel:
            return torch.einsum("bco,cio->bci", rg, w), torch.einsum("bci,bco->cio", ra, rg), None
        K, N = w.shape
        return rg @ w.T, ra.reshape(-1, K).T @ rg.reshape(-1, N), None


def _mm(a, w, bf16: bool):
    return RoundedProduct.apply(a, w, False) if bf16 else a @ w


def _chan2(tile, w0, b0, w1, b1, record=None, bf16: bool = False):
    """Per-channel two-layer net on ``tile [B, n, h]`` (stacks ``[n, h, h]``),
    each product rounding its input where ``bf16``. With ``record`` a list,
    appends each layer's (input, pre-activation output), the second layer
    first."""
    pc = ((lambda a, w: RoundedProduct.apply(a, w, True)) if bf16
          else (lambda a, w: torch.einsum("bci,cio->bco", a, w)))
    p = pc(tile, w0) + b0
    e = elu(p)
    out = pc(e, w1) + b1
    if record is not None:
        record += [(e, out), (tile, p)]
    return out


def cw_eval(xs, fz_t, s_constV, weights: Dict, record=None, bf16: bool = False):
    """One evaluation of the dynamics, ``xs [B, xd, h] -> [B, xd, h]``, as
    the kernel computes it (ELU as ``exp(min(x, 0)) - 1`` below 0); with
    ``bf16`` in the bf16 compute mode (``weights`` holding bf16 values in
    the inputs' dtype, every product by :class:`RoundedProduct`).

    With ``record`` a list, appends the evaluation's four per-channel layers
    as (input, pre-activation output) in the backward kernel's pair order:
    head W1, head W0, ext W1, ext W0 (the rank-one gradient of layer ``W``
    is input^T times the output's cotangent)."""
    ext, head = ([], []) if record is not None else (None, None)
    ft = torch.cat([_chan2(xs, *weights["ext"], record=ext, bf16=bf16), fz_t], dim=1)  # [B, C, h]
    H = elu(_mm(ft.transpose(1, 2), weights["a"], bf16) + s_constV)  # [B, h, h]
    (W1, b1), (W2, b2), (W3, b3) = weights["vert"]
    H = elu(_mm(H, W1, bf16) + b1)
    H = elu(_mm(H, W2, bf16) + b2)
    O = _mm(H, W3, bf16) + b3  # [B, h, xd]
    y = _chan2(O.transpose(1, 2), *weights["head"], record=head, bf16=bf16)
    if record is not None:
        record.append(head + ext)
    return y


def cast_cw(streams: Dict, weights: Dict, precision: str):
    """The kernels' compute-precision mode (JAX ``_cast_cw`` :161):
    ``"bfloat16"`` rounds the 2-D weights (``a``, the vertical ``W``s, the
    per-channel ``w0``/``w1`` of ``ext`` and ``head``) to bfloat16; the
    biases and the streams (``fz``, ``s_constV``) stay float32. Any other
    precision of ``fused_dae.PRECISIONS`` is the identity; an unknown one
    raises ``ValueError``."""
    if not is_bf16(precision):
        return streams, weights
    bf = lambda a: a.to(torch.bfloat16)
    net = lambda w0, b0, w1, b1: (bf(w0), b0, bf(w1), b1)
    return streams, dict(a=bf(weights["a"]), vert=[(bf(W), b) for W, b in weights["vert"]],
                         ext=net(*weights["ext"]), head=net(*weights["head"]))


def is_bf16_weights(weights: Dict) -> bool:
    """Whether ``weights`` are the bf16 compute mode's (:func:`cast_cw`)."""
    return weights["a"].dtype == torch.bfloat16


def work_weights(weights: Dict, dtype: torch.dtype) -> Dict:
    """``weights`` in ``dtype`` (the bf16 mode's hold their bf16 values
    exactly): what a plain version computes with."""
    return unflatten_weights([w.to(dtype) for w in flatten_weights(weights)])


def fused_cw_rollout_plain(streams: Dict, weights: Dict, x0, dt, solver: str = "euler"):
    """The rollout as an eager PyTorch loop on any device and in the
    inputs' dtype: the plain version of the CUDA kernel, in the bf16
    compute mode where ``weights`` are bfloat16 (:func:`cast_cw`). Returns
    the rows ``[T-1, B, xd, h]`` of steps 1..T-1."""
    solver = normalize_solver(solver)
    fz, sV = streams["fz"], streams["s_constV"]
    bf16 = is_bf16_weights(weights)
    weights = work_weights(weights, sV.dtype)
    dt = dt.to(sV.dtype)[..., None]  # [T-1, B, 1, 1]
    xs, x = [], x0
    for t in range(fz.shape[0]):
        f = lambda xx, t=t: cw_eval(xx, fz[t], sV, weights, bf16=bf16)
        x = _step_fwd(f, x, dt[t], solver)
        xs.append(x)
    return torch.stack(xs)


def check_width(h: int, backward: bool = False):
    """Raise ``ValueError`` unless the forward (``backward``: the backward)
    takes width ``h``."""
    most, what = (MAX_HIDDEN_BWD, "backward") if backward else (MAX_HIDDEN_FWD, "forward")
    if h > most:
        raise ValueError(f"the channel-wise {what} kernel takes h <= {most} (the JAX package's widest), "
                         f"got h={h}")


def check_inputs(streams: Dict, weights: Dict, x0, dt, backward: bool = False, device_type: str = "cuda"):
    """Raise unless the rollout's inputs are contiguous, on one CUDA device
    (``device_type`` "cpu": a host build's), shaped as the kernels take
    them, with ``h <= MAX_HIDDEN_FWD`` (with ``backward``, ``h <=
    MAX_HIDDEN_BWD``), and float32, or in the bf16 compute mode (a bfloat16
    ``a``) the 2-D weights bfloat16 and the rest float32. Returns whether
    the mode is bf16."""
    fz, sV = streams["fz"], streams["s_constV"]
    if x0.dim() != 3 or fz.dim() != 4:
        raise ValueError(f"x0 must be [B, xd, h] and fz [T-1, B, zd, h], got {tuple(x0.shape)}, "
                         f"{tuple(fz.shape)}")
    B, xd, h = x0.shape
    Tm1, zd = fz.shape[0], fz.shape[2]
    check_width(h, backward)
    if sV.device.type != device_type:
        raise ValueError(f"the CUDA channel-wise kernels take CUDA tensors, got {sV.device}")
    bf16 = is_bf16_weights(weights)
    low = {"a", "ext.w0", "ext.w1", "head.w0", "head.w1"}  # bfloat16 in the bf16 mode
    if len(weights["vert"]) != N_VERT_TAIL:
        raise ValueError(f"vert must hold {N_VERT_TAIL} layers, got {len(weights['vert'])}")
    C = xd + zd
    expect = {"fz": (fz, (Tm1, B, zd, h)), "s_constV": (sV, (B, h, h)), "dt": (dt, (Tm1, B, 1)),
              "x0": (x0, (B, xd, h)), "a": (weights["a"], (C, h))}
    for k, (W, b) in enumerate(weights["vert"]):
        n_out = xd if k == N_VERT_TAIL - 1 else h
        expect[f"vert[{k}].W"] = (W, (h, n_out))
        expect[f"vert[{k}].b"] = (b, (n_out,))
        low.add(f"vert[{k}].W")
    for net in ("ext", "head"):
        for name, a, shape in zip(("w0", "b0", "w1", "b1"), weights[net],
                                  ((xd, h, h), (xd, h), (xd, h, h), (xd, h))):
            expect[f"{net}.{name}"] = (a, shape)
    for name, (a, shape) in expect.items():
        if a.device != sV.device:
            raise ValueError(f"{name} is on {a.device}, s_constV on {sV.device}")
        want = torch.bfloat16 if bf16 and name in low else torch.float32
        if a.dtype != want:
            raise ValueError(f"{name} must be {want}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bf16


def kernel_weights(weights: Dict) -> List[torch.Tensor]:
    """The 15 weights as the kernels read them, in :func:`flatten_weights`
    order: float32, the bf16 compute mode's widened from bfloat16
    (exactly)."""
    return [w.float() for w in flatten_weights(weights)]


def bind_rollout(lib: ctypes.CDLL, bf16: bool = False):
    """``(launcher, error string, scratch floats)``: the C functions of a build of
    ``csrc/fused_cw_rollout.cu`` (for the card or, in
    ``utils/host_build.py``, the host) with their signatures, the launcher
    that of the bf16 compute mode where ``bf16`` (the build with
    ``cuda_build.BF16_DEFINE``)."""
    fn = lib.psn_fused_cw_rollout_bf16 if bf16 else lib.psn_fused_cw_rollout_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [
        P, P, P, P,  # fz, dt, s_constV, x0
        ctypes.POINTER(ctypes.c_void_p),  # the 15 weights, flatten_weights order
        P, P,  # sol, scratch (the wide kernel's tiles)
        I, I, I, I, I,  # Tm1, B, h, xd, zd
        I, I,  # solver, cluster (blocks per row; 0: the launcher picks)
        P,  # stream
    ]
    fn.restype = ctypes.c_int
    err = lib.psn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    scratch = lib.psn_fused_cw_scratch_floats
    scratch.argtypes = [I, I]
    scratch.restype = ctypes.c_longlong
    return fn, err, scratch


@functools.lru_cache(maxsize=None)
def _launcher(bf16: bool = False):
    """The C launcher of ``csrc/fused_cw_rollout.cu`` in the compute mode of
    ``bf16``, with its signature."""
    return bind_rollout(cuda_build.load("fused_cw_rollout", bf16), bf16)


def chosen_cluster(B: int, h: int, xd: int, zd: int, backward: bool = False, bf16: bool = False) -> int:
    """Blocks per batch row that the CUDA forward (or, with ``backward``,
    the reverse walk) takes at these shapes on the current card (``bf16``:
    in the bf16 compute mode): up to 128, 4 when the card runs B clusters
    of 4 at once, else 2 when it runs B clusters of 2, else 1; above, the
    wide kernels' 8, 4, 2 or 1 (``pick_wide_cluster``,
    ``csrc/cw_wide.cuh``)."""
    name, fn = (("fused_cw_rollout_bwd", "psn_fused_cw_bwd_cluster") if backward
                else ("fused_cw_rollout", "psn_fused_cw_cluster"))
    f = getattr(cuda_build.load(name, bf16), fn)
    f.argtypes = [ctypes.c_int] * 4
    f.restype = ctypes.c_int
    return f(B, h, xd, zd)


def _launch(streams: Dict, weights: Dict, x0, dt, solver: str, cluster: int, launcher=None):
    """Launch the forward through ``launcher`` (``(fn, err, scratch)`` of
    :func:`bind_rollout`; the default build of the inputs' compute mode when
    None) with ``cluster`` blocks per row (0: the launcher's choice);
    returns the rows. Counts nothing: :func:`fused_cw_rollout_cuda` is the
    entry, and a fixed cluster is for timing one choice against another."""
    solver = normalize_solver(solver)
    bf16 = check_inputs(streams, weights, x0, dt)
    fz, sV = streams["fz"], streams["s_constV"]
    Tm1, B, zd, h = fz.shape
    xd = x0.shape[1]
    fn, err, scratch_floats = launcher or _launcher(bf16)
    wk = kernel_weights(weights)  # must outlive the launch
    sol = torch.empty(Tm1, B, xd, h, dtype=torch.float32, device=sV.device)
    scratch = torch.empty(max(1, scratch_floats(B, h)), dtype=torch.float32, device=sV.device)
    with torch.cuda.device(sV.device):
        stream = torch.cuda.current_stream(sV.device).cuda_stream
        rc = fn(fz.data_ptr(), dt.data_ptr(), sV.data_ptr(), x0.data_ptr(),
                pointer_array(wk), sol.data_ptr(), scratch.data_ptr(),
                Tm1, B, h, xd, zd, _SOLVER_CODE[solver], cluster, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_cw_rollout kernel launch failed: CUDA error {rc} ({err(rc).decode()})"
        )
    return sol


def fused_cw_rollout_cuda(streams: Dict, weights: Dict, x0, dt, solver: str = "euler"):
    """Launch the CUDA kernel once for the whole rollout, a cluster of
    blocks per batch row (chosen by the launcher from B, h and the card:
    :func:`chosen_cluster`); returns the rows ``[T-1, B, xd, h]``. Above
    h=128 the wide kernel's scratch, ``2 B hp^2`` floats (``hp`` = h
    rounded up to 128), lives until the launch ends. bfloat16 2-D weights
    (:func:`cast_cw`): the kernel's bf16 compute mode."""
    sol = _launch(streams, weights, x0, dt, solver, 0)
    fused_cw_rollout.launches += 1
    return sol


def fused_cw_rollout(streams: Dict, weights: Dict, x0, dt, solver: str = "euler"):
    """The rollout's rows ``[T-1, B, xd, h]`` (steps 1..T-1, without
    ``x0``) on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, an error otherwise.

    Args:
      streams/weights: from :func:`precompute_cw_streams`.
      x0: ``[B, xd, h]`` latent initial state; dt: ``[T-1, B, 1]`` float32.

    bfloat16 2-D weights (:func:`cast_cw`): the bf16 compute mode.
    ``fused_cw_rollout.launches`` counts kernel launches.
    """
    dev = streams["s_constV"].device
    if dev.type == "cuda":
        return fused_cw_rollout_cuda(streams, weights, x0, dt, solver)
    if dev.type == "cpu":
        return fused_cw_rollout_plain(streams, weights, x0, dt, solver)
    raise ValueError(f"fused_cw_rollout runs on cuda or cpu tensors, got {dev}")


fused_cw_rollout.launches = 0
