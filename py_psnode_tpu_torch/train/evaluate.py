"""ODE and DAE model evaluation, curve plotting and the training-process
summaries (counterpart of ``py_psnode_tpu/train/evaluate.py``:
``evaluate_ode`` :93, ``evaluate_dae``, ``output_training_process_ode``
:190, ``output_training_process_dae``).

Same outputs as the JAX package: per-dim masked losses and totals to the
testing log, per-sample loss vectors, optional true-vs-pred jpgs under
``pics/Sample_N/``, and the ``[x_loss, x_per_sample]`` (ODE) or
``[x_loss, i_loss, x_per_sample, i_per_sample]`` (DAE) object array.
matplotlib is imported only when drawing.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from py_psnode_tpu_torch.utils.logging import Logger

PIC_NUM = 3
LINE_WIDTH = 1
MARK_SIZE = 2


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _run_eval(eval_fn, N, batch_size):
    """Run the index-based eval function over the whole set with static
    batch shapes (the final partial batch repeats its last index; repeated
    rows are dropped here). ``eval_fn(idx [b]) -> dict of tensors``."""
    outs = {}
    for start in range(0, N, batch_size):
        idx = np.arange(start, min(start + batch_size, N))
        n_real = len(idx)
        if n_real < batch_size:
            idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_real)])
        res = eval_fn(idx)
        for k, arr in res.items():
            outs.setdefault(k, []).append(_to_numpy(arr)[:n_real])
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


def _per_sample_loss(pred, true, mask):
    """``sum_t(se * mask)`` per sample and dim → [N, D] (ref :123)."""
    return np.sum((pred - true) ** 2 * mask, axis=1)


def _fin_step(tt):
    if tt[-1] != -1:
        return tt.shape[0]
    return int(np.where(tt == -1)[0][0])


def _draw_sample_curves(pic_path, sample_no, tt, channels, desc, logger):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    size = 10
    matplotlib.rcParams["xtick.labelsize"] = size
    matplotlib.rcParams["ytick.labelsize"] = size
    fin = _fin_step(tt)
    cur = pathlib.Path(pic_path) / f"Sample_{sample_no}"
    cur.mkdir(parents=True, exist_ok=True)
    for d_name, true_value, pred_value in channels:
        tv, pv = true_value[:fin], pred_value[:fin]
        plt.grid()
        plt.title(f"{d_name[0]}_Epoch_{desc}", fontsize=size)
        plt.xlabel("Time (s)", fontsize=size)
        plt.ylabel(f"{d_name[0]} ({d_name[1]})", fontsize=size)
        plt.plot(tt[:fin], tv, "b-", label="True value",
                 linewidth=LINE_WIDTH, markersize=MARK_SIZE)
        plt.plot(tt[:fin], pv, "r--", label="Predicted value",
                 linewidth=LINE_WIDTH, markersize=MARK_SIZE)
        plt.legend(fontsize=size)
        plt.savefig(cur / f"{d_name[0]}_error_{desc}.jpg", dpi=300, format="jpg")
        plt.clf()
        err = np.abs(tv - pv)
        logger.testing_log(
            f"{d_name[0]} err: total({err.sum():12.8f} {d_name[1]}), "
            f"average({err.sum() / tt.shape[0]:12.8f} {d_name[1]}), "
            f"max_error({err.max():12.8f} {d_name[1]}), "
            f"min_error({err.min():12.8f} {d_name[1]})"
        )
    plt.close()


def evaluate_ode(
    apply_fn: Callable,  # eval_fn(idx) -> {"x_loss_ps", ["x_pred"]}
    dataset,
    batch_size: int,
    logger: Logger,
    desc: str = "",
    pic_path: Optional[pathlib.Path] = None,
    show_larger_than: Optional[float] = None,
    pic_num: int = PIC_NUM,
):
    N, T, xd = dataset.x.shape
    res = _run_eval(apply_fn, N, batch_size)
    x_ps = res["x_loss_ps"]
    x_pred = res.get("x_pred")
    total_mask = float(dataset.mask.sum())
    for d in range(xd):
        logger.testing_log(desc + f": x_loss_dim_{d}: {x_ps[:, d].sum() / total_mask:14.10f}.")
    x_loss = float(x_ps.sum() / total_mask)
    logger.testing_log(desc + f": x_loss_total: {x_loss:14.10f}.")
    x_ps = (x_ps / np.sum(dataset.mask, axis=1)).sum(axis=-1).reshape(-1, 1)

    if pic_path is not None:
        pathlib.Path(pic_path).mkdir(parents=True, exist_ok=True)
        logger.testing_log("Picture Drawing")
        logger.testing_log("=" * 86)
        drawn = 0
        for n in range(N):
            tt = dataset.t[n, :, 0]
            if tt[-1] == -1:
                continue  # ref ODE eval skips truncated samples (:151)
            if show_larger_than is not None and dataset.x[n].max() < show_larger_than:
                continue
            channels = list(zip(dataset.data_name, dataset.x[n].T, x_pred[n].T))
            _draw_sample_curves(pic_path, n, tt, channels, desc, logger)
            logger.testing_log("-" * 86)
            drawn += 1
            if drawn >= pic_num:
                break

    return np.array([x_loss, x_ps], dtype=object)


def evaluate_dae(
    apply_fn: Callable,  # eval_fn(idx) -> {"x_loss_ps", "i_loss_ps", ["x_pred", "i_pred"]}
    dataset,
    batch_size: int,
    logger: Logger,
    desc: str = "",
    pic_path: Optional[pathlib.Path] = None,
    show_larger_than: Optional[float] = None,
    pic_num: int = PIC_NUM,
):
    N, T, xd = dataset.x.shape
    idim = dataset.i.shape[-1]
    res = _run_eval(apply_fn, N, batch_size)
    x_ps, i_ps = res["x_loss_ps"], res["i_loss_ps"]
    x_pred, i_pred = res.get("x_pred"), res.get("i_pred")
    total_mask = float(dataset.mask.sum())
    for d in range(xd):
        logger.testing_log(desc + f": x_loss_dim_{d}: {x_ps[:, d].sum() / total_mask:14.10f}.")
    for d in range(idim):
        logger.testing_log(desc + f": i_loss_dim_{d}: {i_ps[:, d].sum() / total_mask:14.10f}.")
    x_loss = float(x_ps.sum() / total_mask)
    i_loss = float(i_ps.sum() / total_mask)
    logger.testing_log(
        desc + f": x_loss_total: {x_loss:14.10f}, i_loss_total: {i_loss:14.10f}."
    )
    x_ps = (x_ps / np.sum(dataset.mask, axis=1)).sum(axis=-1).reshape(-1, 1)
    i_ps = (i_ps / np.sum(dataset.mask, axis=1)).sum(axis=-1).reshape(-1, 1)

    if pic_path is not None:
        pathlib.Path(pic_path).mkdir(parents=True, exist_ok=True)
        logger.testing_log("Picture Drawing")
        logger.testing_log("=" * 86)
        drawn = 0
        for n in range(N):
            tt = dataset.t[n, :, 0]
            # ref DAE eval does NOT skip truncated samples (:194 commented out)
            if show_larger_than is not None and dataset.x[n].max() < show_larger_than:
                continue
            true_all = np.concatenate([dataset.x[n], dataset.i[n]], axis=1).T
            pred_all = np.concatenate([x_pred[n], i_pred[n]], axis=1).T
            channels = list(zip(dataset.data_name, true_all, pred_all))
            _draw_sample_curves(pic_path, n, tt, channels, desc, logger)
            logger.testing_log("-" * 86)
            drawn += 1
            if drawn >= pic_num:
                break

    return np.array([x_loss, i_loss, x_ps, i_ps], dtype=object)


def output_training_process_ode(logger: Logger, eval_list):
    """The end-of-training summary in the testing log (ref
    neural_00_ODE_01_no_encode.py:182-200): the final per-sample losses,
    then per epoch the eval mean and the per-sample spread."""
    a = np.array(eval_list, dtype=object)
    bar = "-" * 69
    logger.testing_log(bar)
    logger.testing_log("Output final testing loss per testing sample")
    logger.testing_log(bar)
    for row in a[-1, 1]:
        logger.testing_log(f"{row[0]}")
    logger.testing_log(bar)
    logger.testing_log("Output testing loss mean")
    logger.testing_log(bar)
    for aa in a:
        logger.testing_log(f"{aa[0]}")
    logger.testing_log(bar)
    logger.testing_log("Output testing loss variant")
    logger.testing_log(bar)
    for aa in a:
        logger.testing_log(f"{np.std(aa[1], ddof=0)}")
    logger.testing_log(bar)


def output_training_process_dae(logger: Logger, eval_list):
    """The end-of-training summary in the testing log (ref
    neural_01_DAE_01_no_encode.py:225-253): the final per-sample losses,
    then per epoch the x and i eval means and per-sample spreads."""
    a = np.array(eval_list, dtype=object)
    bar = "-" * 69
    logger.testing_log(bar)
    logger.testing_log("Output final testing loss per testing sample")
    logger.testing_log(bar)
    for aa, bb in zip(a[-1, 2], a[-1, 3]):
        logger.testing_log(f"{aa[0] + bb[0]}")
    for label, col in (("x", 0), ("i", 1)):
        logger.testing_log(bar)
        logger.testing_log(f"Output {label} testing loss mean")
        logger.testing_log(bar)
        for aa in a:
            logger.testing_log(f"{aa[col]}")
        logger.testing_log(bar)
        logger.testing_log(f"Output {label} testing loss variant")
        logger.testing_log(bar)
        for aa in a:
            logger.testing_log(f"{np.std(aa[col + 2], ddof=0)}")
    logger.testing_log(bar)
