"""MegaCRNx training harness: the model_futurework protocol as a library
function (counterpart of ``megacrn_tpu/train/megacrnx_loop.py``).

The ablation-generation harness differs from the canonical one
(``model_futurework/traintest_MegaCRNx.py``) in every place that matters:

* ratio-based windowing, no shuffle anywhere (``:123-125``), chronological
  val split of the trainval windows (``:120-122``);
* the inverse transform is applied to predictions inside the loss
  (``:98,147``): only x is scaled, targets stay on the raw scale
  (``:116,190``);
* no curriculum learning, no grad clip, no LR schedule: plain ``Adam(lr)``
  with torch's eps 1e-8 (``:126``);
* loss flavors ``MaskMAE`` (``masked_mae`` with ``null_val=1e-3``) or
  ``MAE`` (``nn.L1Loss``), plus the lamb/lamb1 memory losses
  (``:148-151``);
* epoch losses are sample-weighted means (``loss.item() * B / n``,
  ``:103-109,154-159``), not per-batch means;
* final numpy metrics, all steps and per step, over the stacked
  predictions (``:199-207``).

The losses of a step stay on the card until the epoch ends (one host sync
an epoch). On a mesh (``mesh=``) full-size batches train data-parallel
(``parallel.api.make_megacrnx_mesh_train_step``); the drop_last=False tail
batch, whose size need not divide the data axis, runs the single-device
step on every rank: the same math either way. The eval runs on every
rank alike, and only rank 0 writes the run dir.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.data.loader import BatchLoader
from megacrn_tpu_torch.interop import (flat_from_megacrnx_state_dict,
                                       megacrnx_params_from_flat)
from megacrn_tpu_torch.models.megacrnx import (MegaCRNx, MegaCRNxConfig,
                                               MegaCRNxOutput)
from megacrn_tpu_torch.ops import losses, metrics
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.train import checkpoint as ckpt
from megacrn_tpu_torch.train.logs import RunDir, echo_hparams, for_rank
from megacrn_tpu_torch.train.loop import (_param_dtype,
                                          _reinit_xavier_uniform, to_device)


@dataclasses.dataclass(frozen=True)
class MegaCRNxTrainConfig:
    """Reference defaults: traintest_MegaCRNx.py:210-233."""
    loss: str = "MaskMAE"  # "MAE" | "MaskMAE"
    epochs: int = 200
    batch_size: int = 64
    lr: float = 1e-3
    patience: int = 10
    lamb: float = 0.01
    lamb1: float = 0.01
    trainval_ratio: float = 0.8
    val_ratio: float = 0.125
    seed: int = 100


def _component_losses(out: MegaCRNxOutput, y_raw: torch.Tensor,
                      loss_name: str, mean, std):
    """(loss1, loss2, loss3) of traintest_MegaCRNx.py:146-151: the
    prediction loss on the inverse-transformed scale against the RAW
    target, and the triplet and compact memory losses with pos and neg
    detached."""
    y_raw = y_raw.to(out.output.dtype)
    y_pred = inverse_transform(out.output, std, mean)
    if loss_name == "MaskMAE":
        loss1 = losses.masked_mae(y_pred, y_raw, null_val=1e-3)
    elif loss_name == "MAE":
        loss1 = (y_pred - y_raw).abs().mean()
    else:
        raise ValueError(f"unknown loss {loss_name!r}")
    if out.query is None:  # memory_type=False: no memory losses
        zero = torch.zeros((), dtype=y_pred.dtype, device=y_pred.device)
        return loss1, zero, zero
    pos, neg = out.pos.detach(), out.neg.detach()
    loss2 = losses.triplet_margin_loss(out.query, pos, neg, margin=1.0)
    loss3 = losses.mse(out.query, pos)
    return loss1, loss2, loss3


def make_megacrnx_loss_fn(model: MegaCRNx, train_cfg: MegaCRNxTrainConfig,
                          scaler_mean: float, scaler_std: float) -> Callable:
    """``(x, y_raw, y_cov) -> (total, (loss1, loss2, loss3))``, ready for
    ``total.backward()``."""

    def loss_fn(x, y, y_cov):
        l1, l2, l3 = _component_losses(model(x, y_cov), y, train_cfg.loss,
                                       scaler_mean, scaler_std)
        return l1 + train_cfg.lamb * l2 + train_cfg.lamb1 * l3, (l1, l2, l3)

    return loss_fn


def make_megacrnx_train_step(model: MegaCRNx, train_cfg: MegaCRNxTrainConfig,
                             optimizer: torch.optim.Optimizer,
                             scaler_mean: float, scaler_std: float
                             ) -> Callable:
    """``(x, y_raw, y_cov) -> (loss, loss1, loss2, loss3)`` as one detached
    tensor on the device: forward, loss, backward and Adam. Deterministic:
    MegaCRNx has no scheduled sampling."""
    loss_fn = make_megacrnx_loss_fn(model, train_cfg, scaler_mean,
                                    scaler_std)

    def step(x, y, y_cov):
        optimizer.zero_grad(set_to_none=True)
        total, parts = loss_fn(x, y, y_cov)
        total.backward()
        optimizer.step()
        return torch.stack((total,) + parts).detach()

    return step


def make_megacrnx_eval_step(model: MegaCRNx, train_cfg: MegaCRNxTrainConfig,
                            scaler_mean: float, scaler_std: float
                            ) -> Callable:
    """``(x, y_raw, y_cov) -> ((loss, l1, l2, l3) tensor, y_pred on the raw
    scale)``: the evaluateModel body (traintest_MegaCRNx.py:95-108)."""

    @torch.no_grad()
    def step(x, y, y_cov):
        out = model(x, y_cov)
        l1, l2, l3 = _component_losses(out, y, train_cfg.loss, scaler_mean,
                                       scaler_std)
        total = l1 + train_cfg.lamb * l2 + train_cfg.lamb1 * l3
        return (torch.stack((total, l1, l2, l3)),
                inverse_transform(out.output, scaler_std, scaler_mean))

    return step


def _weighted_eval(eval_step, loader, device: torch.device) -> Dict:
    """Sample-weighted loss means and the stacked predictions
    (traintest_MegaCRNx.py:92-111), with one copy to the host."""
    sums, n, preds = 0.0, 0, []
    for arrays in loader:
        vals, y_pred = eval_step(*to_device(arrays, device))
        b = arrays[0].shape[0]
        sums = sums + vals.double() * b
        n += b
        preds.append(y_pred)
    loss, l1, l2, l3 = (sums / n).tolist()
    return {"loss": loss, "loss1": l1, "loss2": l2, "loss3": l3,
            "preds": torch.cat(preds).cpu().numpy()}


class _XYCovLoader:
    """Sequential 3-array batches with torch's drop_last=False tail."""

    def __init__(self, x, y, ycov, batch_size):
        self._inner = BatchLoader(x, y, batch_size,
                                  pad_with_last_sample=False, keep_tail=True)
        self.ycov = ycov

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        bs = self._inner.batch_size
        for i, (x, y) in enumerate(self._inner):
            yield x, y, self.ycov[i * bs:i * bs + len(x)]


def fit_megacrnx(model_cfg: MegaCRNxConfig, train_cfg: MegaCRNxTrainConfig,
                 data: Dict, run: RunDir, *,
                 max_epochs: Optional[int] = None, initial_params=None,
                 device=None, mesh=None, ckpt_backend: str = "npz") -> Dict:
    """Train MegaCRNx with the model_futurework protocol.

    ``data`` keys: ``x_trainval`` (SCALED), ``y_trainval`` (raw),
    ``ycov_trainval``, ``x_test``/``y_test``/``ycov_test`` likewise, and
    scalar ``scaler_mean``/``scaler_std`` (windowed by
    ``data.windowing.ratio_windows``). ``initial_params``: a start point in
    the JAX package's flat naming, in place of the seeded init. ``device``:
    the card unless the caller says otherwise (``resolve_device``).
    ``mesh``: a ``parallel.mesh.Mesh``; every rank of it calls
    ``fit_megacrnx`` with the same arguments. ``ckpt_backend``: 'npz' or
    'orbax' (a directory, as ``train.loop.fit`` writes it).
    Returns {params (best, flat JAX naming), model, best_val,
    test_metrics, epochs_run}.
    """
    if ckpt_backend not in ckpt.BACKENDS:
        raise ValueError(f"unknown ckpt_backend {ckpt_backend!r}")
    device = resolve_device(device)
    run = for_rank(run, mesh)
    logger = run.get_logger()
    echo_hparams(logger, model=model_cfg, train=train_cfg)

    init_gen = torch.Generator().manual_seed(train_cfg.seed)
    dtype = _param_dtype(model_cfg)
    model = MegaCRNx(model_cfg, generator=init_gen, device="cpu", dtype=dtype)
    # getModel applies xavier_uniform (dim>1) / U(0,1) (dim==1) over the
    # fresh module (traintest_MegaCRNx.py:75-79).
    _reinit_xavier_uniform(model, init_gen)
    if initial_params is not None:
        model.load_state_dict(megacrnx_params_from_flat(
            initial_params, model_cfg, dtype=dtype))
    model.to(device)
    logger.info("param_count", sum(p.numel() for p in model.parameters()))

    # Plain Adam with torch's defaults (:126).
    optimizer = torch.optim.Adam(model.parameters(), lr=train_cfg.lr)
    mean, std = float(data["scaler_mean"]), float(data["scaler_std"])

    x_tv, y_tv = data["x_trainval"], data["y_trainval"]
    yc_tv = data["ycov_trainval"]
    train_size = int(len(x_tv) * (1 - train_cfg.val_ratio))
    bs = train_cfg.batch_size
    train_iter = _XYCovLoader(x_tv[:train_size], y_tv[:train_size],
                              yc_tv[:train_size], bs)
    val_iter = _XYCovLoader(x_tv[train_size:], y_tv[train_size:],
                            yc_tv[train_size:], bs)
    trainval_iter = _XYCovLoader(x_tv, y_tv, yc_tv, bs)
    test_iter = _XYCovLoader(data["x_test"], data["y_test"],
                             data["ycov_test"], bs)

    train_step = make_megacrnx_train_step(model, train_cfg, optimizer, mean,
                                          std)
    mesh_step = None
    if mesh is not None:
        from megacrn_tpu_torch.parallel.api import \
            make_megacrnx_mesh_train_step
        from megacrn_tpu_torch.parallel.mesh import shard_batch

        mesh_step = make_megacrnx_mesh_train_step(model, train_cfg, optimizer,
                                                  mesh, mean, std)
    eval_step = make_megacrnx_eval_step(model, train_cfg, mean, std)

    def train_on(arrays):
        if mesh_step is not None and len(arrays[0]) % mesh.data == 0:
            return mesh_step(*to_device(shard_batch(arrays, mesh,
                                                    nodes=False), device))
        return train_step(*to_device(arrays, device))

    def save_best(epoch, best):
        ckpt.write(
            ckpt_backend, mesh, run.checkpoint_path,
            flat_from_megacrnx_state_dict(model.state_dict(),
                                          model_cfg.num_layers),
            metadata={"epoch": epoch, "best_val": best,
                      "scaler_mean": mean, "scaler_std": std})

    min_val_loss = float("inf")
    wait = 0
    epochs = max_epochs if max_epochs is not None else train_cfg.epochs
    epochs_run = 0
    for epoch in range(epochs):
        t0 = time.perf_counter()
        sums, n = 0.0, 0
        for arrays in train_iter:
            vals = train_on(arrays)
            sums = sums + vals.double() * arrays[0].shape[0]
            n += arrays[0].shape[0]
        train_loss = (sums / n).tolist()  # the epoch's one host sync
        train_s = time.perf_counter() - t0
        val = _weighted_eval(eval_step, val_iter, device)
        dt = time.perf_counter() - t0
        msg = (f"epoch {epoch} time used: {dt:.1f}s train loss: "
               f"{train_loss[0]:.6f} {train_loss[1]:.6f} "
               f"{train_loss[2]:.6f} {train_loss[3]:.6f} validation loss: "
               f"{val['loss']:.6f} {val['loss1']:.6f} "
               f"{val['loss2']:.6f} {val['loss3']:.6f}")
        logger.info(msg)
        run.append_epochlog(msg)
        run.log_metrics({"epoch": epoch, "train_loss": train_loss[0],
                         "val_loss": val["loss"], "seconds": dt,
                         "train_seconds": train_s, "steps": len(train_iter),
                         "sec_per_step": train_s / len(train_iter)})
        epochs_run = epoch + 1
        if val["loss"] < min_val_loss:
            wait = 0
            min_val_loss = val["loss"]
            save_best(epoch, min_val_loss)
        else:
            wait += 1
            if wait == train_cfg.patience:
                logger.info("Early stopping at epoch:", epoch)
                break

    # The trainval eval on the CURRENT (last-epoch) weights; the reference
    # logs it before reloading the best (traintest_MegaCRNx.py:178-184).
    tv = _weighted_eval(eval_step, trainval_iter, device)
    m = metrics.evaluate(np.squeeze(y_tv), np.squeeze(tv["preds"]))
    logger.info("trainval loss, MSE, RMSE, MAE, MAPE:",
                f"{tv['loss']:.6f}", *[f"{v:.6f}" for v in m])

    # testModel: the best weights, numpy metrics all steps and per step
    # (traintest_MegaCRNx.py:186-207).
    flat, _, _ = ckpt.load_checkpoint(run.checkpoint_path)
    model.load_state_dict(megacrnx_params_from_flat(flat, model_cfg,
                                                    dtype=dtype))
    te = _weighted_eval(eval_step, test_iter, device)
    y_true = np.squeeze(data["y_test"])
    y_pred = np.squeeze(te["preds"])
    mse_, rmse_, mae_, mape_ = metrics.evaluate(y_true, y_pred)
    line = (f"all pred steps, MSE, RMSE, MAE, MAPE, {mse_:.6f}, "
            f"{rmse_:.6f}, {mae_:.6f}, {mape_:.6f}")
    logger.info(line)
    run.append_scores(line)
    per_step = []
    for i in range(model_cfg.horizon):  # the reference's opt.seq_len
        step_m = metrics.evaluate(y_true[:, i], y_pred[:, i])
        per_step.append(step_m)
        run.append_scores(f"{i + 1} step, MSE, RMSE, MAE, MAPE, "
                          + ", ".join(f"{v:.6f}" for v in step_m))
    test_metrics = {"mse": mse_, "rmse": rmse_, "mae": mae_, "mape": mape_,
                    "per_step": per_step, "loss": te["loss"]}
    run.log_metrics({"final_test": {k: v for k, v in test_metrics.items()
                                    if k != "per_step"},
                     "best_val": min_val_loss})
    return {"params": flat, "model": model, "best_val": min_val_loss,
            "test_metrics": test_metrics, "epochs_run": epochs_run}
