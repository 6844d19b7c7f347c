"""Everything the benchmark takes from the program under test,
``megacrn_tpu_torch``: the model, its graph constant, the train step and
its optimizer, the loader and upload that feed it, the predictors, and the
SpMM kernel's launch counter. Nothing else in the harness imports it."""
from __future__ import annotations

import numpy as np
import torch


class Program:
    """The program configured as ``config`` states, on ``device``."""

    def __init__(self, config: dict, device: torch.device):
        from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig

        self.device = device
        self.model_cfg = MegaCRNConfig(**config["model"])
        self.train_cfg = TrainConfig(**config["train"])
        self.graph = config["graph"]

    def model(self, weights):
        """A MegaCRN holding ``weights`` (the reference's state_dict)."""
        from megacrn_tpu_torch.models.megacrn import MegaCRN

        model = MegaCRN(self.model_cfg, device=self.device)
        model.load_state_dict(weights, strict=True)
        return model

    def graph_constant(self, supports):
        """The program's graph constant built from the supports (2, N, N),
        or None for a learned graph."""
        if supports is None:
            return None
        if self.graph["pack"] != "stacked_coo":
            raise ValueError(f"unknown pack {self.graph['pack']!r}")
        from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack

        return build_stacked_road_pack(list(supports))

    def train_step(self, model, sampling_seed: int, mean: float, std: float,
                   pack):
        """(step, optimizer): ``step(x, y, y_cov, batches_seen) -> loss``."""
        from megacrn_tpu_torch.train.optim import make_optimizer
        from megacrn_tpu_torch.train.steps import make_train_step

        gen = torch.Generator(device=self.device).manual_seed(sampling_seed)
        opt = make_optimizer(model.parameters(), self.train_cfg)
        step = make_train_step(model, self.train_cfg, opt, gen, mean, std,
                               road_supports=pack)
        return step, opt

    def loader(self, x: np.ndarray, y: np.ndarray, seed: int):
        """Batches of the train protocol, reshuffled each epoch as a function
        of (seed, epoch), endlessly: (x, y, y_cov) numpy batches."""
        from megacrn_tpu_torch.data.loader import BatchLoader, prepare_x_y

        loader = BatchLoader(x, y, self.train_cfg.batch_size, shuffle=True,
                             reshuffle_each_epoch=True, seed=seed)
        cfg = self.model_cfg
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            for xb, yb in loader:
                yield prepare_x_y(xb, yb, cfg.input_dim, cfg.output_dim)
            epoch += 1

    def upload(self, arrays):
        """numpy arrays -> device tensors, as ``fit`` uploads a batch."""
        from megacrn_tpu_torch.train.loop import to_device

        return to_device(arrays, self.device)

    def predictor(self, model, mean: float, std: float, pack,
                  max_batch: int):
        from megacrn_tpu_torch.serve import Predictor

        return Predictor(model, self.model_cfg, mean, std, max_batch,
                         road_supports=pack, device=self.device)

    def stream(self, predictor, cov_fn):
        from megacrn_tpu_torch.serve import StreamingForecaster

        return StreamingForecaster(predictor, cov_fn)

    @staticmethod
    def spmm_launches() -> int:
        """The program's count of block-COO kernel launches."""
        from megacrn_tpu_torch.kernels.spmm_coo import spmm_coo

        return spmm_coo.launches
