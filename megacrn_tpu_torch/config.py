"""Model configuration and dataset presets (counterpart of
``megacrn_tpu/config.py``).

The port keeps its own copy: it imports nothing of the JAX package. Only the
fields the serving slice reads are here; the training fields
(``cl_decay_steps``, ``use_curriculum_learning``, ``remat``), ``dense_impl``
and the training and mesh configs come with the slices that use them.
"""
from __future__ import annotations

import dataclasses


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
    # Matmul-input dtype: "float32" | "bfloat16" | "float64" (CPU parity
    # control). The memory read and the output stay at >= float32.
    compute_dtype: str = "float32"
    # Graph aggregation backend. The port runs "dense" (learned meta-graph)
    # and "road_sparse" with a StackedRoadPack (block-COO kernel); the
    # others raise NotImplementedError until their ROADMAP slice lands.
    graph_backend: str = "dense"

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
class DatasetConfig:
    """The dataset shape a model preset reads. The data pipeline's fields
    (interval, loader, directory) and the other presets come with the data
    slice."""

    num_nodes: int
    seq_len: int
    horizon: int


# Published benchmark presets (BASELINE.md) that the serving slice runs.
DATASETS = {
    "METRLA": DatasetConfig(207, 12, 12),
    "EXPYTKY": DatasetConfig(1843, 6, 6),
}


def model_config_for(dataset: str, **overrides) -> MegaCRNConfig:
    """Model preset per dataset, mirroring the reference harness choices."""
    ds = DATASETS[dataset]
    base = dict(
        num_nodes=ds.num_nodes, seq_len=ds.seq_len, horizon=ds.horizon,
    )
    if dataset == "EXPYTKY":
        # model_EXPYTKY/traintest_MegaCRN.py:158-164
        base.update(rnn_units=32, mem_num=10, mem_dim=32)
    base.update(overrides)
    return MegaCRNConfig(**base)
