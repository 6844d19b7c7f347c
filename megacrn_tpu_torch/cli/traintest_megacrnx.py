"""MegaCRNx harness CLI: the model_futurework/traintest_MegaCRNx.py program
(counterpart of ``megacrn_tpu/cli/traintest_megacrnx.py``).

    python -m megacrn_tpu_torch.cli.traintest_megacrnx --dataset SYNTH
    python -m megacrn_tpu_torch.cli.traintest_megacrnx --dataset METRLA \\
        --data_path METRLA/metr-la.h5
    python -m megacrn_tpu_torch.cli.traintest_megacrnx --dataset SYNTH \\
        --device cpu

The flag surface mirrors the reference parser (traintest_MegaCRNx.py:210-
233); ``--dataset SYNTH`` substitutes a generated series for the h5 blobs,
which are read without pandas (``data/hdf5.py``, through h5py). Train
protocol: ratio windowing without shuffling, the inverse transform inside
the loss, no curriculum (``train/megacrnx_loop.py``). ``--mesh_data x
--mesh_node y`` (x * y > 1) trains data-parallel over x * y ranks, the
node axis replicated as in JAX (``parallel.launch`` spawns them unless
torchrun did). ``--ckpt_backend orbax`` writes the checkpoint as a
directory (``torch.distributed.checkpoint``; the JAX CLI has no such flag).
"""
from __future__ import annotations

import argparse

import numpy as np

_NODES = {"METRLA": 207, "PEMSBAY": 325}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MegaCRNx traintest")
    p.add_argument("--dataset", type=str, default="METRLA",
                   choices=["METRLA", "PEMSBAY", "SYNTH"])
    p.add_argument("--data_path", type=str, default=None,
                   help="h5 speed matrix (metr-la.h5 / pems-bay.h5 layout)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: 'cuda' (the card; with no card the "
                        "run stops) or 'cpu' (the plain PyTorch path)")
    p.add_argument("--trainval_ratio", type=float, default=0.8)
    p.add_argument("--val_ratio", type=float, default=0.125)
    p.add_argument("--seq_len", type=int, default=12,
                   help="prediction length (reference naming)")
    p.add_argument("--his_len", type=int, default=12)
    p.add_argument("--channelin", type=int, default=1)
    p.add_argument("--channelout", type=int, default=1)
    p.add_argument("--loss", type=str, default="MaskMAE",
                   choices=["MAE", "MaskMAE"])
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--hiddenunits", type=int, default=32)
    p.add_argument("--mem_num", type=int, default=10)
    p.add_argument("--mem_dim", type=int, default=32)
    p.add_argument("--memory", type=lambda s: s == "True", default=True,
                   help="whether to use memory: True or False")
    p.add_argument("--meta", type=lambda s: s == "True", default=True,
                   help="whether to use meta-graph: True or False")
    p.add_argument("--decoder", type=str, default="stepwise",
                   choices=["sequence", "stepwise"])
    p.add_argument("--lamb", type=float, default=0.01)
    p.add_argument("--lamb1", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--save_dir", type=str, default="./save")
    # The SYNTH stand-in's knobs (no reference counterpart).
    p.add_argument("--num_nodes", type=int, default=None,
                   help="override node count (SYNTH; METRLA=207, PEMSBAY=325)")
    p.add_argument("--synth_steps", type=int, default=2000)
    # The mesh: data parallel; the node axis is replicated (parallel.api).
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_node", type=int, default=1)
    p.add_argument("--ckpt_backend", type=str, default="npz",
                   choices=["npz", "orbax"],
                   help="'npz' (one file, either package reads it) or "
                        "'orbax' (a directory, written with "
                        "torch.distributed.checkpoint: Orbax needs JAX)")
    return p


def build_data(args):
    """Load or generate the (T, N) series and its weekdaytime channel, then
    window them with the ratio protocol (traintest_MegaCRNx.py:297-315)."""
    from megacrn_tpu_torch.data.windowing import (ratio_windows,
                                                  weekday_time_feature)

    if args.dataset == "SYNTH":
        from megacrn_tpu_torch.data.synthetic import synthetic_speed_series

        n = args.num_nodes or 32
        values, index = synthetic_speed_series(args.synth_steps, n,
                                               interval_minutes=5,
                                               seed=args.seed)
    else:
        if args.data_path is None:
            raise SystemExit(f"--data_path required for {args.dataset}")
        from megacrn_tpu_torch.data.hdf5 import read_hdf

        values, index, _ = read_hdf(args.data_path)
        if values.shape[1] != _NODES[args.dataset]:
            raise SystemExit(f"{args.dataset} expects {_NODES[args.dataset]}"
                             f" nodes, h5 has {values.shape[1]}")
    data_time = weekday_time_feature(index, values.shape[1],
                                     interval_minutes=5)[..., 0]

    train_num = int(values.shape[0] * args.trainval_ratio)
    mean = float(np.mean(values[:train_num]))
    std = float(np.std(values[:train_num]))

    def windows(mode):
        xs, ys, ycov = ratio_windows(values, data_time, args.his_len,
                                     args.seq_len, args.trainval_ratio, mode)
        xs = (xs - mean) / std  # only x is scaled (:116,190); y stays raw
        return xs.astype(np.float32), ys, ycov

    x_tv, y_tv, yc_tv = windows("train")
    x_te, y_te, yc_te = windows("test")
    return {"x_trainval": x_tv, "y_trainval": y_tv, "ycov_trainval": yc_tv,
            "x_test": x_te, "y_test": y_te, "ycov_test": yc_te,
            "scaler_mean": mean, "scaler_std": std,
            "num_nodes": values.shape[1]}


def configs_from_args(args, num_nodes: int):
    from megacrn_tpu_torch.models.megacrnx import MegaCRNxConfig
    from megacrn_tpu_torch.train.megacrnx_loop import MegaCRNxTrainConfig

    model_cfg = MegaCRNxConfig(
        num_nodes=num_nodes, input_dim=args.channelin,
        output_dim=args.channelout, horizon=args.seq_len,
        seq_len=args.his_len, rnn_units=args.hiddenunits,
        num_layers=args.num_layers, mem_num=args.mem_num,
        mem_dim=args.mem_dim, memory_type=args.memory, meta_type=args.meta,
        decoder_type=args.decoder)
    train_cfg = MegaCRNxTrainConfig(
        loss=args.loss, epochs=args.epoch, batch_size=args.batch_size,
        lr=args.lr, patience=args.patience, lamb=args.lamb,
        lamb1=args.lamb1, trainval_ratio=args.trainval_ratio,
        val_ratio=args.val_ratio, seed=args.seed)
    return model_cfg, train_cfg


def main(argv=None):
    args = build_parser().parse_args(argv)

    from megacrn_tpu_torch.parallel import launch
    from megacrn_tpu_torch.train.logs import mesh_run_dir
    from megacrn_tpu_torch.train.megacrnx_loop import fit_megacrnx

    # Before any data loading: no card fails here.
    spawned, mesh, device = launch.cli_mesh(main, argv, args.mesh_data,
                                            args.mesh_node, args.device)
    if spawned:
        return None
    data = build_data(args)
    model_cfg, train_cfg = configs_from_args(args, data["num_nodes"])
    run = mesh_run_dir(args.save_dir, args.dataset, mesh,
                       model_name="MegaCRNx")
    result = fit_megacrnx(model_cfg, train_cfg, data, run, device=device,
                          mesh=mesh, ckpt_backend=args.ckpt_backend)
    if mesh is None or mesh.rank == 0:
        print({k: v for k, v in result["test_metrics"].items()
               if k != "per_step"})
    return result


if __name__ == "__main__":
    main()
