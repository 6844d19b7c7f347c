"""CLI: train and test the GTS baseline (counterpart of
``megacrn_tpu/cli/traintest_gts.py``; reference ``traintest_GTS.py``).

    python -m megacrn_tpu_torch.cli.traintest_gts --dataset SYNTH --num_nodes 32
    python -m megacrn_tpu_torch.cli.traintest_gts --dataset METRLA \\
        --data_dir METRLA --raw_h5 METRLA/metr-la.h5
    python -m megacrn_tpu_torch.cli.traintest_gts --dataset SYNTH --device cpu

The graph learner needs the raw training series (``train_feas``) for its
Conv1d feature extractor and the cosine-kNN prior
(``traintest_GTS.py:324-333``): the ``--train_frac`` head of the series,
scaled by its own scaler. For npz datasets the raw series comes from
``--raw_h5``, read without pandas (``data/hdf5.py``, through h5py).
``--mesh_data`` > 1 trains data-parallel over that many ranks
(``parallel.launch`` spawns them unless torchrun did).
``--ckpt_backend orbax`` writes the weights and the BatchNorm state as two
directories (``torch.distributed.checkpoint``; the JAX CLI has no such
flag).
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="SYNTH")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--raw_h5", type=str, default=None,
                   help="raw (time x node) HDF5 for train_feas")
    p.add_argument("--save_dir", type=str, default="save")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: 'cuda' (the card; with no card the "
                        "run stops) or 'cpu' (the plain PyTorch path)")
    p.add_argument("--num_nodes", type=int, default=207)
    p.add_argument("--seq_len", type=int, default=12)
    p.add_argument("--horizon", type=int, default=12)
    p.add_argument("--input_dim", type=int, default=2)
    p.add_argument("--output_dim", type=int, default=1)
    p.add_argument("--rnn_units", type=int, default=64)
    p.add_argument("--num_rnn_layers", type=int, default=1)
    p.add_argument("--max_diffusion_step", type=int, default=3)
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--knn_k", type=int, default=10)
    p.add_argument("--base_lr", type=float, default=0.005)
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--cl_decay_steps", type=int, default=2000)
    p.add_argument("--use_curriculum_learning", type=lambda s: s == "True",
                   default=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--synth_steps", type=int, default=2000)
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--ckpt_backend", type=str, default="npz",
                   choices=["npz", "orbax"],
                   help="'npz' (one file, either package reads it) or "
                        "'orbax' (a directory, written with "
                        "torch.distributed.checkpoint: Orbax needs JAX)")
    # trainval_ratio * (1 - val_ratio) = the raw series' train fraction
    # (traintest_GTS.py:325: 0.8 * (1 - 0.125) = 0.7).
    p.add_argument("--train_frac", type=float, default=0.7)
    return p


def train_feas_and_prior(raw: np.ndarray, train_frac: float, knn_k: int):
    """(train_feas, knn_prior): the raw series' train head scaled by its
    own scaler (traintest_GTS.py:324-328) and its cosine-kNN graph."""
    from megacrn_tpu_torch.data.graph_prior import cosine_knn_graph
    from megacrn_tpu_torch.data.scalers import StandardScaler

    train_feas = raw[: int(raw.shape[0] * train_frac)].astype(np.float32)
    train_feas = StandardScaler.fit(train_feas).transform(train_feas)
    return train_feas, cosine_knn_graph(train_feas, knn_k)


def configs_from_args(args, train_series_len: int):
    from megacrn_tpu_torch.config import GTSConfig, TrainConfig

    cfg = GTSConfig(
        num_nodes=args.num_nodes, input_dim=args.input_dim,
        output_dim=args.output_dim, horizon=args.horizon,
        seq_len=args.seq_len, rnn_units=args.rnn_units,
        num_layers=args.num_rnn_layers,
        max_diffusion_step=args.max_diffusion_step,
        temperature=args.temperature, cl_decay_steps=args.cl_decay_steps,
        use_curriculum_learning=args.use_curriculum_learning,
        train_series_len=train_series_len, knn_k=args.knn_k)
    tcfg = TrainConfig(lr=args.base_lr, epsilon=args.epsilon,
                       max_grad_norm=args.max_grad_norm, epochs=args.epochs,
                       patience=args.patience, batch_size=args.batch_size,
                       seed=args.seed)
    return cfg, tcfg


def main(argv=None):
    args = build_parser().parse_args(argv)

    from megacrn_tpu_torch.data import datasets
    from megacrn_tpu_torch.parallel import launch
    from megacrn_tpu_torch.train.gts_loop import fit_gts
    from megacrn_tpu_torch.train.logs import mesh_run_dir

    # Before any data loading: no card fails here.
    spawned, mesh, device = launch.cli_mesh(main, argv, args.mesh_data, 1,
                                            args.device)
    if spawned:
        return None
    if mesh is not None and args.seed is None:
        import time

        from megacrn_tpu_torch.parallel.comm import broadcast_object

        # One seed on every rank: the loader's order and the draws agree.
        args.seed = broadcast_object(int(time.time()))
    # With --seed the train loader's permutation is seeded too (the JAX CLI
    # draws it from OS entropy whatever the seed).
    shuffle_rng = (None if args.seed is None
                   else np.random.default_rng(args.seed))
    if args.dataset == "SYNTH":
        from megacrn_tpu_torch.data.synthetic import synthetic_speed_series

        values, index = synthetic_speed_series(args.synth_steps,
                                               args.num_nodes)
        data = datasets.build_from_series(values, index, args.seq_len,
                                          args.horizon, args.batch_size,
                                          shuffle_rng=shuffle_rng)
        raw = values
    else:
        if args.data_dir is None or args.raw_h5 is None:
            raise SystemExit("--data_dir and --raw_h5 required")
        from megacrn_tpu_torch.data.hdf5 import read_hdf

        data = datasets.load_npz_splits(args.data_dir, args.batch_size,
                                        shuffle_rng=shuffle_rng)
        raw = read_hdf(args.raw_h5)[0]

    train_feas, knn_prior = train_feas_and_prior(raw, args.train_frac,
                                                 args.knn_k)
    cfg, tcfg = configs_from_args(args, train_feas.shape[0])
    run = mesh_run_dir(args.save_dir, args.dataset, mesh, model_name="GTS")
    result = fit_gts(cfg, tcfg, data, train_feas, knn_prior, run,
                     max_epochs=args.epochs, device=device, mesh=mesh,
                     ckpt_backend=args.ckpt_backend)
    if mesh is None or mesh.rank == 0:
        print(result["test_metrics"])
    return result


if __name__ == "__main__":
    main()
