"""Inference / serving path (counterpart of ``megacrn_tpu/serve.py``).

* ``Predictor``: stateless batch inference around a MegaCRN, raw speed
  windows in, raw-scale forecasts out. Requests are cut into chunks of at
  most ``max_batch`` windows, and each chunk runs at its own size.
* ``GTSPredictor``: the same around a trained GTS; its graph is sampled
  once, when it is built (argmax, no Gumbel noise, BatchNorm in eval mode).
* ``MegaCRNxPredictor``: the same around a trained MegaCRNx.
* ``StreamingForecaster``: keeps a rolling window and emits a forecast every
  time a new observation step arrives once the window is warm; it drives
  any of the three predictors.

All three share ``_run_batched``, which records the serving spans of
``train.telemetry`` (``serve.predict`` a request, ``serve.chunk`` with its
``windows`` and ``padded`` counts, and in each chunk ``serve.upload``,
``serve.forward`` and ``serve.copy_back``; ``padded`` reads 0, as
``_run_batched`` pads nothing, and only ``MegaCRNxPredictor``'s forward
pads, for its batch-coupled support), and each loads an ``.npz
checkpoint that either package wrote, or a checkpoint directory the port
wrote (``ckpt_backend="orbax"``), with ``from_checkpoint``.
``serve.forward`` counts ``graphed``: 1 where ``Predictor`` replayed a
CUDA graph, 0 for an eager forward; ``serve.capture`` (``windows``)
records the capture of a graph.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.interop import (gts_params_from_flat,
                                       megacrnx_params_from_flat,
                                       params_from_flat)
from megacrn_tpu_torch.kernels.spmm_coo import spmm_coo
from megacrn_tpu_torch.models.gts import GTS
from megacrn_tpu_torch.models.megacrn import DTYPES, MegaCRN
from megacrn_tpu_torch.models.megacrnx import MegaCRNx
from megacrn_tpu_torch.ops.graph import captured, road_supports_to
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.train.telemetry import span


class _Graph(NamedTuple):
    """One chunk size's captured forward: its static inputs (normalised x,
    sliced to ``input_dim``, and y_cov), its static forecasts (normalised),
    and the kernel launches it replays."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    y_cov: torch.Tensor
    output: torch.Tensor
    launches: int


def _predict_with_covariates(self, x: np.ndarray,
                             y_cov: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """x: (B, seq_len, N, >=1) RAW (unnormalised) windows, channel 0 =
    speed; y_cov: (B, horizon, N, ycov_dim) decoder covariates (zeros if
    omitted). Returns (B, horizon, N, output_dim) raw-scale forecasts.
    ``predict`` of ``Predictor`` and ``MegaCRNxPredictor``."""
    cfg = self.cfg
    x = np.asarray(x, np.float32)
    if y_cov is None:
        y_cov = np.zeros((x.shape[0], cfg.horizon, cfg.num_nodes,
                          cfg.ycov_dim), np.float32)
    return _run_batched(self._forward, self.max_batch,
                        (x, np.asarray(y_cov, np.float32)))


class Predictor:
    """Batch forecaster around a trained MegaCRN.

    Args:
      params_or_model: a ``MegaCRN`` module (moved to ``device`` in place,
        as ``nn.Module.to`` does), or its weights in the JAX
        package's flat ``{path: array}`` naming (a reference state_dict
        loads into a ``MegaCRN`` with ``load_state_dict``).
      cfg: model config.
      scaler_mean / scaler_std: the training normalisation stats.
      max_batch: the most windows one forward takes (a cap on its
        memory); larger requests are chunked, and a smaller request or last
        chunk runs at its own size, unpadded.
      road_supports: the graph constant of a ``road_sparse`` or
        ``sparse_meta`` config (any the model takes); its forward side is
        moved to ``device`` and cast to the compute dtype here.
      device: where the model runs; the card unless the caller says
        otherwise (``resolve_device``).

    Where ``ops.graph``'s table captures the graph constant's forward (on
    a CUDA device, a ``StackedRoadPack`` through the block-COO kernel), the
    model runs each chunk size's forward as a CUDA graph: the first chunk
    of a size runs eagerly, which builds the kernel and warms cuBLAS and
    the allocator, and its forecasts are returned; then that forward is
    captured from static input buffers, and every later chunk of the size
    is copied into them and replayed. The graphs share one
    memory pool, since one predictor replays them one after another on
    one stream, and each copy back blocks before the next replay. The
    weights and the graph constant are read where they lie when captured:
    change them in place, never by assigning new tensors. The rest stays
    eager, ``dense`` too: its forward records the ``graph.meta`` and
    ``graph.aggregate`` spans that a replay would not.
    """

    def __init__(self, params_or_model, cfg: MegaCRNConfig,
                 scaler_mean: float = 0.0, scaler_std: float = 1.0,
                 max_batch: int = 64, road_supports=None, device=None):
        self.device = resolve_device(device)
        if isinstance(params_or_model, nn.Module):
            model = params_or_model.to(self.device)
        else:
            model = MegaCRN(cfg, device=self.device)
            model.load_state_dict(params_from_flat(params_or_model, cfg))
        self.model = model.eval()
        self.cfg = cfg
        self.mean = float(scaler_mean)
        self.std = float(scaler_std)
        self.max_batch = max_batch
        # Cast once here, so the forward's cast to compute_dtype is a no-op.
        self.road_supports = road_supports_to(road_supports, self.device,
                                              DTYPES[cfg.compute_dtype])
        graphed = captured(self.road_supports, cfg.graph_backend,
                           self.device)
        # {windows: _Graph} of the sizes captured; None: forwards stay eager.
        self._graphs = {} if graphed else None
        self._pool = torch.cuda.graph_pool_handle() if graphed else None

    @classmethod
    def from_checkpoint(cls, path: str, cfg: MegaCRNConfig,
                        max_batch: int = 64, road_supports=None,
                        device=None) -> "Predictor":
        """Load an ``.npz`` checkpoint written by either package's
        ``train.checkpoint.save_checkpoint``; the scaler stats come from its
        metadata."""
        from megacrn_tpu_torch.train import checkpoint as ckpt

        flat, _, meta = ckpt.load_checkpoint(path)
        return cls(flat, cfg, meta.get("scaler_mean", 0.0),
                   meta.get("scaler_std", 1.0), max_batch,
                   road_supports=road_supports, device=device)

    @torch.inference_mode()
    def _forward(self, x: np.ndarray, y_cov: np.ndarray) -> np.ndarray:
        x, y_cov = _upload(self.device, self.mean, self.std, x, y_cov)
        x = x[..., :self.cfg.input_dim]
        g = None if self._graphs is None else self._graphs.get(len(x))
        if g is None:
            with span("serve.forward", graphed=0):
                out = self.model(x, y_cov, road_supports=self.road_supports)
            forecasts = _copy_back(out.output, self.std, self.mean)
            if self._graphs is not None:
                self._capture(x, y_cov)
            return forecasts
        g.x.copy_(x)
        g.y_cov.copy_(y_cov)
        with span("serve.forward", graphed=1):
            g.graph.replay()
        spmm_coo.launches += g.launches
        return _copy_back(g.output, self.std, self.mean)

    def _capture(self, x: torch.Tensor, y_cov: torch.Tensor) -> None:
        """Capture the forward at x's size from static copies of x and
        y_cov. The capture launches nothing on the card, so the kernel's
        launch counter is set back, and each replay adds what it counted."""
        with span("serve.capture", windows=len(x)):
            x, y_cov = x.clone(), y_cov.clone()
            graph = torch.cuda.CUDAGraph()
            before = spmm_coo.launches
            with torch.cuda.graph(graph, pool=self._pool):
                out = self.model(x, y_cov, road_supports=self.road_supports)
            launches, spmm_coo.launches = spmm_coo.launches - before, before
            self._graphs[len(x)] = _Graph(graph, x, y_cov, out.output,
                                          launches)

    predict = _predict_with_covariates


def _run_batched(fwd, max_batch: int, arrays) -> np.ndarray:
    """Cut a request into chunks of at most ``max_batch`` windows and call
    ``fwd`` on each at its own size: ``fwd`` gets the request's windows
    and no copies of them (``serve.chunk``'s ``padded`` reads 0).
    ``arrays``: tuple of (B, ...) numpy arrays."""
    b = arrays[0].shape[0]
    outs = []
    with span("serve.predict", windows=b):
        for s in range(0, b, max_batch):
            chunk = [a[s:s + max_batch] for a in arrays]
            with span("serve.chunk", windows=len(chunk[0]), padded=0):
                outs.append(np.asarray(fwd(*chunk)))
        return np.concatenate(outs, axis=0)


def _upload(device: torch.device, mean: float, std: float, x: np.ndarray,
            *others: np.ndarray):
    """Raw windows -> a tensor on ``device`` with channel 0 normalised,
    and ``others`` -> tensors on ``device``, each a copy."""
    with span("serve.upload",
              bytes=x.nbytes + sum(o.nbytes for o in others)):
        t = torch.tensor(x, device=device)  # a copy: edited in place
        t[..., 0] = (t[..., 0] - mean) / std
        return (t, *(torch.tensor(o, device=device) for o in others))


def _copy_back(output: torch.Tensor, std, mean) -> np.ndarray:
    """The raw-scale forecasts in host memory; the host waits here for
    the card."""
    with span("serve.copy_back",
              bytes=output.numel() * output.element_size()):
        return inverse_transform(output, std, mean).cpu().numpy()


class GTSPredictor:
    """Batch forecaster around a trained GTS (the second family).

    The graph learner reads the NORMALISED training series (``node_feas``,
    model/GTS.py:423-434), deployed state beside the weights and the
    BatchNorm stats. The graph depends only on those, never on a request,
    so it is sampled once here: argmax, no Gumbel noise, BatchNorm in eval
    mode (the reference eval path, model/traintest_GTS.py:104-120).

    Args:
      params_or_model: a ``GTS`` module (moved to ``device`` in place), or
        its weights in the JAX package's flat naming.
      bn_state: the BatchNorm state in the flat naming (``bn1/mean``, ...)
        with flat weights; None with a module, which holds its own.
      node_feas: (T_train, N) normalised training series.
    """

    def __init__(self, params_or_model, bn_state, cfg, node_feas,
                 scaler_mean: float = 0.0, scaler_std: float = 1.0,
                 max_batch: int = 64, device=None):
        self.device = resolve_device(device)
        if isinstance(params_or_model, nn.Module):
            model = params_or_model.to(self.device)
        else:
            model = GTS(cfg, device=self.device)
            model.load_state_dict(gts_params_from_flat(params_or_model,
                                                       bn_state, cfg))
        self.model = model.eval()
        self.cfg = cfg
        self.mean, self.std = float(scaler_mean), float(scaler_std)
        self.max_batch = max_batch
        with torch.inference_mode():
            self.graph = model.sample_graph(
                torch.as_tensor(np.asarray(node_feas, np.float32),
                                device=self.device), None, training=False)
        self.adj = self.graph[0]

    @classmethod
    def from_checkpoint(cls, path: str, cfg, node_feas, max_batch: int = 64,
                        device=None) -> "GTSPredictor":
        """Load the (params, params.bn) checkpoint pair written by either
        package's ``train.gts_loop.fit_gts``."""
        from megacrn_tpu_torch.train import checkpoint as ckpt

        params, _, meta = ckpt.load_checkpoint(path)
        bn_state, _, _ = ckpt.load_checkpoint(path + ".bn")
        return cls(params, bn_state, cfg, node_feas,
                   meta.get("scaler_mean", 0.0), meta.get("scaler_std", 1.0),
                   max_batch, device=device)

    @torch.inference_mode()
    def _forward(self, x: np.ndarray) -> np.ndarray:
        x, = _upload(self.device, self.mean, self.std, x)
        with span("serve.forward"):
            out = self.model(x[..., :self.cfg.input_dim], None,
                             training=False, gumbel_noise=False,
                             graph=self.graph)
        return _copy_back(out.output, self.std, self.mean)

    def predict(self, x: np.ndarray, y_cov=None) -> np.ndarray:
        """x: (B, seq_len, N, >=input_dim) RAW windows, channel 0 = speed.
        ``y_cov`` is accepted for ``StreamingForecaster`` and ignored: GTS
        has no decoder covariates (model/GTS.py:387-410)."""
        del y_cov
        return _run_batched(self._forward, self.max_batch,
                            (np.asarray(x, np.float32),))


class MegaCRNxPredictor:
    """Batch forecaster around a trained MegaCRNx (the third family): the
    deterministic forward (no scheduled sampling), raw-scale output per its
    protocol (model_futurework/traintest_MegaCRNx.py: normalised x,
    raw-scale targets). ``params_or_model``: a ``MegaCRNx`` module or its
    weights in the JAX package's flat naming.

    Unlike the other two families, MegaCRNx couples the windows of a
    forward: its decoder's support sums E E^T over every window in the
    batch (``models.megacrnx.support_from_embeddings``). So a chunk of
    fewer than ``max_batch`` windows is padded to ``max_batch`` here, by
    repeating its last window, and the padding's forecasts are dropped:
    each forecast is the JAX predictor's at the same ``max_batch``."""

    def __init__(self, params_or_model, cfg, scaler_mean: float = 0.0,
                 scaler_std: float = 1.0, max_batch: int = 64, device=None):
        self.device = resolve_device(device)
        if isinstance(params_or_model, nn.Module):
            model = params_or_model.to(self.device)
        else:
            model = MegaCRNx(cfg, device=self.device)
            model.load_state_dict(megacrnx_params_from_flat(params_or_model,
                                                            cfg))
        self.model = model.eval()
        self.cfg = cfg
        self.mean, self.std = float(scaler_mean), float(scaler_std)
        self.max_batch = max_batch

    @classmethod
    def from_checkpoint(cls, path: str, cfg, max_batch: int = 64,
                        device=None) -> "MegaCRNxPredictor":
        """Load an ``.npz`` checkpoint written by either package's
        ``fit_megacrnx``; the scaler stats come from its metadata (the JAX
        harness writes none: then 0 and 1)."""
        from megacrn_tpu_torch.train import checkpoint as ckpt

        flat, _, meta = ckpt.load_checkpoint(path)
        return cls(flat, cfg, meta.get("scaler_mean", 0.0),
                   meta.get("scaler_std", 1.0), max_batch, device=device)

    @torch.inference_mode()
    def _forward(self, x: np.ndarray, y_cov: np.ndarray) -> np.ndarray:
        nb, pad = len(x), self.max_batch - len(x)
        if pad:
            x, y_cov = (np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                        for a in (x, y_cov))
        x, y_cov = _upload(self.device, self.mean, self.std, x, y_cov)
        with span("serve.forward"):
            out = self.model(x[..., :self.cfg.input_dim], y_cov)
        return _copy_back(out.output[:nb], self.std, self.mean)

    predict = _predict_with_covariates


class StreamingForecaster:
    """Online serving: push one observation step at a time, get a forecast
    once the window is warm.

    ``push(obs)`` with obs (N,) or (N, C); returns (horizon, N, output_dim)
    forecast or None while warming up.
    """

    def __init__(self, predictor, cov_fn=None):
        self.predictor = predictor
        self.cfg = predictor.cfg
        self._window: list = []
        self._cov_fn = cov_fn  # optional t -> (horizon, N, ycov) covariates
        self._t = 0

    def push(self, obs: np.ndarray) -> Optional[np.ndarray]:
        obs = np.asarray(obs, np.float32)
        if obs.ndim == 1:
            obs = obs[:, None]
        self._window.append(obs)
        self._t += 1
        if len(self._window) > self.cfg.seq_len:
            self._window.pop(0)
        if len(self._window) < self.cfg.seq_len:
            return None
        with span("serve.push"):
            x = np.stack(self._window)[None]  # (1, T, N, C)
            y_cov = None
            if self._cov_fn is not None:
                y_cov = np.asarray(self._cov_fn(self._t), np.float32)[None]
            return self.predictor.predict(x, y_cov)[0]
