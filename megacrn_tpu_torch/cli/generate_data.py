"""Offline data generation: a raw HDF5 series -> windowed
{train,val,test}.npz (counterpart of ``megacrn_tpu/cli/generate_data.py``;
the reference ``generate_training_data.py:106-122``), with a
``--synthetic`` mode that makes a plausible speed series from a seed when
the raw benchmark files are not at hand.

    python -m megacrn_tpu_torch.cli.generate_data --dataset METRLA \\
        --traffic_df_filename METRLA/metr-la.h5 --output_dir METRLA/
    python -m megacrn_tpu_torch.cli.generate_data --synthetic \\
        --num_nodes 207 --num_steps 34272 --output_dir data/synth207/

The flags are the JAX CLI's. The ``.h5`` file is the pandas "fixed" layout,
read without pandas through h5py (``data/hdf5.py``); without h5py the
command exits naming it. Nothing here needs a card.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="METRLA",
                   choices=["METRLA", "PEMSBAY"])
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--traffic_df_filename", type=str, default=None)
    p.add_argument("--seq_len", type=int, default=12)
    p.add_argument("--horizon", type=int, default=12)
    p.add_argument("--add_day_in_week", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num_nodes", type=int, default=207)
    p.add_argument("--num_steps", type=int, default=34272)
    p.add_argument("--interval_minutes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from megacrn_tpu_torch.data.windowing import (chronological_split,
                                                  generate_seq2seq_dataset,
                                                  save_npz_splits)

    if args.synthetic:
        from megacrn_tpu_torch.data.synthetic import synthetic_speed_series

        values, index = synthetic_speed_series(
            args.num_steps, args.num_nodes, args.interval_minutes, args.seed)
        output_dir = args.output_dir or f"data/synth{args.num_nodes}"
    else:
        from megacrn_tpu_torch.data.hdf5 import read_hdf

        path = args.traffic_df_filename or f"{args.dataset}/" + (
            "metr-la.h5" if args.dataset == "METRLA" else "pems-bay.h5")
        values, index, _ = read_hdf(path)
        output_dir = args.output_dir or f"{args.dataset}/"

    x, y = generate_seq2seq_dataset(
        values, index, args.seq_len, args.horizon,
        add_day_in_week=args.add_day_in_week)
    print("x shape:", x.shape, ", y shape:", y.shape)
    splits = chronological_split(x, y)
    os.makedirs(output_dir, exist_ok=True)
    for cat, (xs, ys) in splits.items():
        print(cat, "x:", xs.shape, "y:", ys.shape)
    save_npz_splits(splits, output_dir, args.seq_len, args.horizon)
    print("wrote", output_dir)


if __name__ == "__main__":
    main()
