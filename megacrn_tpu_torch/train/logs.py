"""Run-directory artifact contract (counterpart of
``megacrn_tpu/train/logs.py``).

Mirrors the reference experiment layout (``model/traintest_MegaCRN.py:199-227``):
a timestamped run dir holding ``*_logging.txt`` (dual file+console logger with
the space-joining formatter), ``*_scores.txt``, ``*_epochlog.txt``, the model
checkpoint, and a source snapshot — so result comparison against reference
runs is diffable. Adds a machine-readable ``metrics.jsonl`` stream on top.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import time
from typing import Optional


class SpaceJoinFormatter(logging.Formatter):
    """Space-joins positional args like the reference MyFormatter
    (model/traintest_MegaCRN.py:213-218)."""

    def format(self, record):
        if record.args:
            record.msg = " ".join(
                [str(record.msg)] + [str(a) for a in record.args])
            record.args = tuple()
        return super().format(record)


class RunDir:
    def __init__(self, base: str, dataset: str, model_name: str = "MegaCRN",
                 snapshot_sources: bool = True, timestring: Optional[str] = None):
        ts = timestring or time.strftime("%Y%m%d%H%M%S", time.localtime())
        self.path = os.path.join(base, f"{dataset}_{model_name}_{ts}")
        os.makedirs(self.path, exist_ok=True)
        self.prefix = os.path.join(self.path, f"{model_name}_{ts}")
        self.logging_path = f"{self.prefix}_logging.txt"
        self.score_path = f"{self.prefix}_scores.txt"
        self.epochlog_path = f"{self.prefix}_epochlog.txt"
        self.checkpoint_path = f"{self.prefix}.npz"
        self.metrics_path = os.path.join(self.path, "metrics.jsonl")
        if snapshot_sources:
            self._snapshot()

    @staticmethod
    def latest_timestring(base: str, dataset: str,
                          model_name: str = "MegaCRN") -> Optional[str]:
        """The timestamp of the newest ``{dataset}_{model_name}_{ts}`` run
        dir under ``base`` (what a resumed run continues), or None."""
        prefix = f"{dataset}_{model_name}_"
        stamps = [d[len(prefix):] for d in (os.listdir(base)
                                            if os.path.isdir(base) else [])
                  if d.startswith(prefix) and d[len(prefix):].isdigit()]
        return max(stamps) if stamps else None

    def _snapshot(self):
        """Source provenance: copy the package into the run dir (analog of the
        reference's shutil.copy2 of entry/model/utils,
        model/traintest_MegaCRN.py:207-209). The kernels' sources come along
        (``kernels/csrc``); their build outputs live outside the package."""
        import megacrn_tpu_torch

        pkg_dir = os.path.dirname(megacrn_tpu_torch.__file__)
        dst = os.path.join(self.path, "src_snapshot", "megacrn_tpu_torch")
        if not os.path.exists(dst):
            shutil.copytree(pkg_dir, dst,
                            ignore=shutil.ignore_patterns("__pycache__"))

    def get_logger(self, name: str = "megacrn_tpu_torch") -> logging.Logger:
        logger = logging.getLogger(f"{name}:{self.path}")
        logger.setLevel(logging.INFO)
        logger.handlers.clear()
        logger.propagate = False
        fmt = SpaceJoinFormatter()
        fh = logging.FileHandler(self.logging_path, mode="a")
        fh.setFormatter(fmt)
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(ch)
        return logger

    def log_metrics(self, record: dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def append_scores(self, line: str):
        with open(self.score_path, "a") as f:
            f.write(line + "\n")

    def append_epochlog(self, line: str):
        with open(self.epochlog_path, "a") as f:
            f.write(line + "\n")


class QuietRunDir:
    """Rank 0's run dir seen from another rank of a mesh run: the same
    paths (so every rank reads the checkpoint rank 0 writes), no writes."""

    def __init__(self, run: RunDir):
        self.__dict__.update(vars(run))

    def get_logger(self, name: str = "megacrn_tpu_torch") -> logging.Logger:
        logger = logging.getLogger(f"{name}:quiet:{self.path}")
        logger.handlers.clear()
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger

    def log_metrics(self, record: dict):
        pass

    def append_scores(self, line: str):
        pass

    def append_epochlog(self, line: str):
        pass


def mesh_run_dir(base: str, dataset: str, mesh, model_name: str = "MegaCRN",
                 timestring: Optional[str] = None) -> RunDir:
    """The run dir of a CLI run: on a mesh one dir for every rank, named by
    rank 0's clock (or ``timestring``), its sources copied by rank 0."""
    if mesh is None:
        return RunDir(base, dataset, model_name, timestring=timestring)
    from megacrn_tpu_torch.parallel.comm import broadcast_object

    ts = broadcast_object(timestring or time.strftime("%Y%m%d%H%M%S",
                                                      time.localtime()))
    return RunDir(base, dataset, model_name, snapshot_sources=mesh.rank == 0,
                  timestring=ts)


def for_rank(run: RunDir, mesh) -> RunDir:
    """``run`` on rank 0 (and without a mesh), a ``QuietRunDir`` of it on
    every other rank: only rank 0 writes the log, the metrics and the
    checkpoint."""
    return run if mesh is None or mesh.rank == 0 else QuietRunDir(run)


def write_on_rank0(mesh, write) -> None:
    """``write()`` where the run dir is written: without a mesh, or on rank
    0 of it while the other ranks wait at a barrier until the file is whole
    (they read it later)."""
    if mesh is None or mesh.rank == 0:
        write()
    if mesh is not None:
        from megacrn_tpu_torch.parallel.comm import barrier

        barrier(mesh.world)


def echo_hparams(logger: logging.Logger, **sections):
    """Start-of-run hyperparameter echo (model/traintest_MegaCRN.py:229-253)."""
    for section, cfg in sections.items():
        for k, v in (cfg.__dict__ if hasattr(cfg, "__dict__") else
                     dict(cfg)).items():
            logger.info(f"{section}.{k}", v)
