"""Model configuration and dataset presets (counterpart of
``megacrn_tpu/config.py``).

The port keeps its own copy: it imports nothing of the JAX package. The
mesh is no config field: ``cli/traintest.py``'s ``--mesh_data`` and
``--mesh_node`` build the ``parallel.mesh.Mesh`` that ``fit`` takes.
MegaCRNx's config lives with its model (``models/megacrnx.py``), as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MegaCRNConfig:
    """Architecture hyper-parameters of the MegaCRN model family.

    Defaults mirror the reference defaults (``model/MegaCRN.py:117-118``,
    ``model/traintest_MegaCRN.py:162-185``).
    """

    num_nodes: int = 207
    input_dim: int = 1
    output_dim: int = 1
    horizon: int = 12
    seq_len: int = 12
    rnn_units: int = 64
    num_layers: int = 1
    cheb_k: int = 3
    ycov_dim: int = 1
    mem_num: int = 20
    mem_dim: int = 64
    cl_decay_steps: int = 2000
    use_curriculum_learning: bool = True
    # Matmul-input dtype: "float32" | "bfloat16" | "float64" (CPU parity
    # control). The memory read and the output stay at >= float32.
    compute_dtype: str = "float32"
    # Graph aggregation backend: "dense" (learned meta-graph), "road_sparse"
    # (static road supports) or "sparse_meta" (the learned meta-graph on a
    # static edge pattern); ops.graph.GRAPH_CONSTANTS lists the graph
    # constants of the last two. "dense_ring" aggregates the meta-graph on
    # the ring (parallel.ring) in a node-partitioned mesh step, and is
    # "dense" outside one.
    graph_backend: str = "dense"
    # Dense aggregation: "recursive" (the per-support feature recursion) or
    # "stacked" (the Chebyshev polynomial matrices built once per forward,
    # every aggregation ONE tall product; ops/graph.py). Same math.
    dense_impl: str = "recursive"
    remat: bool = False  # recompute each cell step in the backward pass

    def __post_init__(self):
        # The reference Chebyshev stack is [I, A, ...] so cheb_k==1 would make
        # the weight width 2*1*dim_in disagree with the 2-term stack
        # (model/MegaCRN.py:20-22); require >= 2 like every published config.
        if self.cheb_k < 2:
            raise ValueError("cheb_k must be >= 2 (reference stack is [I, A, ...])")

    @property
    def decoder_dim(self) -> int:
        # Decoder hidden width = rnn_units + mem_dim (model/MegaCRN.py:140).
        return self.rnn_units + self.mem_dim

    @property
    def num_supports(self) -> int:
        return 2  # meta-graph always yields [g1, g2] (model/MegaCRN.py:171-173)


@dataclasses.dataclass(frozen=True)
class GTSConfig:
    """GTS baseline model (graph structure learning, ``model/GTS.py``).

    Defaults follow the reference harness (``model/traintest_GTS.py:228-260``
    and the YAML block at ``model/GTS.py:485-527``). ``train_series_len`` is
    the length of the training series fed to the Conv1d feature extractor;
    it determines dim_fc = 16 * (train_series_len - 18).
    """

    num_nodes: int = 207
    input_dim: int = 2  # speed + time-of-day both enter the encoder
    output_dim: int = 1
    horizon: int = 12
    seq_len: int = 12
    rnn_units: int = 64
    num_layers: int = 1
    max_diffusion_step: int = 3
    embedding_dim: int = 100
    temperature: float = 0.5
    cl_decay_steps: int = 2000
    use_curriculum_learning: bool = True
    train_series_len: int = 23990
    knn_k: int = 10
    # Matmul/conv-input dtype: "float32" | "bfloat16" (extractor convs, fc
    # and the DCGRU gconvs narrow; BatchNorm, the edge logits, the softmax
    # and the sampling stay f32) | "float64" (CPU parity control).
    compute_dtype: str = "float32"

    @property
    def dim_fc(self) -> int:
        # Two VALID k=10 convs shrink L by 18; 16 channels out
        # (model/GTS.py:350-353,423-432).
        return 16 * (self.train_series_len - 18)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-protocol hyper-parameters.

    Defaults are the published METR-LA/PEMS-BAY protocol
    (``model/traintest_MegaCRN.py:162-185``); the EXPY-TKY preset overrides
    them per ``model_EXPYTKY/traintest_MegaCRN.py:152-176``.
    """

    lr: float = 0.01
    epsilon: float = 1e-3  # Adam eps
    lr_milestones: Tuple[int, ...] = (50, 100)  # epochs
    lr_decay_ratio: float = 0.1
    max_grad_norm: Optional[float] = 5.0  # None = no clipping (EXPY-TKY)
    batch_size: int = 64
    epochs: int = 200
    patience: int = 20
    lamb: float = 0.01  # triplet (separate) loss weight
    lamb1: float = 0.01  # compact loss weight
    # 'masked_mae_inv': masked MAE on inverse-transformed scale (METR-LA/BAY,
    #   model/traintest_MegaCRN.py:118-120); 'l1_normalized': plain L1 on the
    #   normalized scale (EXPY-TKY, model_EXPYTKY/traintest_MegaCRN.py:76-94).
    pred_loss: str = "masked_mae_inv"
    seed: Optional[int] = None  # traintestv1 uses 100; canonical is unseeded
    val_ratio: float = 0.125  # of trainval, METR-LA protocol
    # EXPY-TKY harness re-initializes every weight with xavier_uniform / bias
    # uniform after construction (model_EXPYTKY/traintest_MegaCRN.py:27-35).
    reinit_xavier_uniform: bool = False
    # Eval aggregation: 'per_batch' reproduces README numbers
    # (model/traintest_MegaCRN.py:72-98); 'concat' is the traintestv1 flavor.
    eval_aggregation: str = "per_batch"


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "METRLA"
    num_nodes: int = 207
    seq_len: int = 12
    horizon: int = 12
    interval_minutes: int = 5
    # METR-LA style npz pipeline vs EXPY-TKY monthly-CSV pipeline
    pipeline: str = "npz"  # "npz" | "expytky"
    data_dir: str = "METRLA"


# Published benchmark presets (BASELINE.md).
DATASETS = {
    "METRLA": DatasetConfig("METRLA", 207, 12, 12, 5, "npz", "METRLA"),
    "PEMSBAY": DatasetConfig("PEMSBAY", 325, 12, 12, 5, "npz", "PEMSBAY"),
    "EXPYTKY": DatasetConfig("EXPYTKY", 1843, 6, 6, 10, "expytky", "EXPYTKY"),
    "EXPYTKY_ALL": DatasetConfig("EXPYTKY_ALL", 2841, 6, 6, 10, "expytky",
                                 "EXPYTKY"),
}


def model_config_for(dataset: str, **overrides) -> MegaCRNConfig:
    """Model preset per dataset, mirroring the reference harness choices."""
    ds = DATASETS[dataset]
    base = dict(
        num_nodes=ds.num_nodes, seq_len=ds.seq_len, horizon=ds.horizon,
    )
    if dataset.startswith("EXPYTKY"):
        # model_EXPYTKY/traintest_MegaCRN.py:158-164
        base.update(rnn_units=32, mem_num=10, mem_dim=32)
    base.update(overrides)
    return MegaCRNConfig(**base)


def train_config_for(dataset: str, **overrides) -> TrainConfig:
    """Training protocol per dataset preset."""
    if dataset not in DATASETS:
        raise KeyError(f"no training preset for {dataset!r}; the port has "
                       f"{sorted(DATASETS)}")
    base: dict = {}
    if dataset.startswith("EXPYTKY"):
        # model_EXPYTKY/traintest_MegaCRN.py:152-176; the EXPY-TKY harness
        # builds Adam WITHOUT the eps override (:74 - torch default 1e-8)
        # and reshuffles every epoch (torch DataLoader(shuffle=True), :71).
        base.update(
            lr=0.001, epsilon=1e-8, lr_milestones=(200,), max_grad_norm=None,
            patience=10, lamb=0.01, lamb1=0.0, epochs=200,
            pred_loss="l1_normalized", val_ratio=0.25,
            reinit_xavier_uniform=True,
        )
    base.update(overrides)
    return TrainConfig(**base)
