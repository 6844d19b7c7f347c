"""CLI: train + test MegaCRN, reproducing the reference flag surface
(counterpart of ``megacrn_tpu/cli/traintest.py``).

Usage (mirrors ``python traintest_MegaCRN.py --dataset=METRLA --gpu=0``,
``README.md:53-65``; ``--device`` picks the card or the CPU):

    python -m megacrn_tpu_torch.cli.traintest --dataset METRLA --data_dir METRLA
    python -m megacrn_tpu_torch.cli.traintest --dataset SYNTH --num_nodes 64
    python -m megacrn_tpu_torch.cli.traintest --dataset SYNTH --device cpu
    python -m megacrn_tpu_torch.cli.traintest --dataset SYNTH \
        --mesh_data 2 --mesh_node 3 --graph_backend dense_ring

Every reference knob (model/traintest_MegaCRN.py:158-187) is exposed; dataset
presets hard-set num_nodes exactly as the reference does (:190-195).
``--mesh_data x --mesh_node y`` (x * y > 1) trains on a mesh: without
``WORLD_SIZE`` in the environment the CLI spawns x * y local ranks itself
(``parallel.launch``), under torchrun each rank joins the group it is
given; only rank 0 writes the run dir. ``--ckpt_backend orbax`` writes
the checkpoint as a directory, which the port writes with
``torch.distributed.checkpoint`` (Orbax needs JAX).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from megacrn_tpu_torch.config import (DATASETS, model_config_for,
                                      train_config_for)

_EXPYTKY_LINKS = 2841  # links in each EXPY-TKY month CSV


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="METRLA",
                   choices=list(DATASETS) + ["SYNTH"])
    p.add_argument("--data_dir", type=str, default=None,
                   help="dir with {train,val,test}.npz (npz pipeline)")
    p.add_argument("--save_dir", type=str, default="save")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: 'cuda' (the card; with no card the "
                        "run stops) or 'cpu' (the plain PyTorch path)")
    # model
    p.add_argument("--num_nodes", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--input_dim", type=int, default=1)
    p.add_argument("--output_dim", type=int, default=1)
    p.add_argument("--max_diffusion_step", type=int, default=3, dest="cheb_k")
    p.add_argument("--num_rnn_layers", type=int, default=1, dest="num_layers")
    p.add_argument("--rnn_units", type=int, default=None)
    p.add_argument("--mem_num", type=int, default=None)
    p.add_argument("--mem_dim", type=int, default=None)
    p.add_argument("--use_curriculum_learning", type=lambda s: s == "True",
                   default=True)
    p.add_argument("--cl_decay_steps", type=int, default=2000)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--graph_backend", type=str, default="dense",
                   choices=["dense", "road_sparse", "sparse_meta",
                            "dense_ring"],
                   help="graph aggregation backend: dense (learned "
                        "meta-graph), road_sparse (the static road graph "
                        "through a sparse product) or sparse_meta (the "
                        "learned meta-graph restricted to the road graph's "
                        "edges); dense_ring (the dense backend whose "
                        "aggregation runs the ring schedule over the mesh's "
                        "node axis)")
    p.add_argument("--adj_path", type=str, default=None,
                   help=".npy 0/1 road adjacency (expy-tky_adj01.npy "
                        "semantics, model_EXPYTKY/traintest_MegaCRN.py:"
                        "187-188); required by road_sparse unless running "
                        "on SYNTH (which generates one)")
    p.add_argument("--road_impl", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "ell"],
                   help="road_sparse SpMM: 'pallas' (the block-COO CUDA "
                        "kernel), 'xla' (its plain PyTorch version, for "
                        "comparison), 'ell' (node-level ELL gathers, plain "
                        "PyTorch), 'auto' = pallas (the faster of pallas "
                        "and ell on the H100)")
    p.add_argument("--sparse_meta_impl", type=str, default="node",
                   choices=["node", "block"],
                   help="sparse_meta granularity: 'node' (row-padded ELL "
                        "slots, O(nnz) pattern bytes) or 'block' (128x128 "
                        "tiles; keeps tens of GiB of activations at the "
                        "EXPY-TKY width unless --remat)")
    p.add_argument("--dense_impl", type=str, default="recursive",
                   choices=["stacked", "recursive"],
                   help="dense aggregation: 'recursive' (per-support "
                        "recursion) or 'stacked' (the Chebyshev polynomial "
                        "matrices built once per forward, one tall product "
                        "per aggregation)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize cell steps in the backward pass "
                        "(less device memory, more time)")
    # train
    p.add_argument("--lamb", type=float, default=None)
    p.add_argument("--lamb1", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--steps", type=_int_list, default=None,
                   help="lr milestone epochs, e.g. [50,100]")
    p.add_argument("--lr_decay_ratio", type=float, default=None)
    p.add_argument("--epsilon", type=float, default=None)
    p.add_argument("--max_grad_norm", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test_every_epoch", type=lambda s: s == "True",
                   default=True)
    p.add_argument("--reshuffle_each_epoch", action="store_true",
                   help="per-epoch shuffle (off = reference parity: one "
                        "construction-time permutation)")
    p.add_argument("--eval_aggregation", type=str, default="per_batch",
                   choices=["per_batch", "concat"],
                   help="'per_batch' reproduces README numbers; 'concat' is "
                        "the traintestv1 full-concat-and-trim flavor")
    # synthetic source
    p.add_argument("--synth_steps", type=int, default=4000)
    # mesh
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_node", type=int, default=1)
    p.add_argument("--ckpt_backend", type=str, default="npz",
                   choices=["npz", "orbax"],
                   help="'npz' (one file, either package reads it) or "
                        "'orbax' (a directory, written with "
                        "torch.distributed.checkpoint: Orbax needs JAX)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of --profile_steps "
                        "steps of the first epoch into this directory "
                        "(trace.json, Chrome trace format)")
    p.add_argument("--profile_steps", type=int, default=10)
    return p


def _int_list(text: str):
    """``[50,100]`` or ``50,100`` -> [50, 100] (the JAX CLI evals it)."""
    return [int(v) for v in text.strip("[]() ").split(",") if v.strip()]


def configs_from_args(args):
    ds = "METRLA" if args.dataset == "SYNTH" else args.dataset
    model_over = {}
    for f in ["num_nodes", "seq_len", "horizon", "rnn_units", "mem_num",
              "mem_dim"]:
        if getattr(args, f) is not None:
            model_over[f] = getattr(args, f)
    model_over.update(
        input_dim=args.input_dim, output_dim=args.output_dim,
        cheb_k=args.cheb_k, num_layers=args.num_layers,
        cl_decay_steps=args.cl_decay_steps,
        use_curriculum_learning=args.use_curriculum_learning,
        compute_dtype=args.compute_dtype, graph_backend=args.graph_backend,
        dense_impl=args.dense_impl, remat=args.remat)
    model_cfg = model_config_for(ds, **model_over)

    train_over = {"eval_aggregation": args.eval_aggregation}
    for name in ("lamb", "lamb1", "epochs", "patience", "batch_size", "lr",
                 "lr_decay_ratio", "epsilon", "seed", "max_grad_norm"):
        if getattr(args, name) is not None:
            train_over[name] = getattr(args, name)
    if args.steps is not None:
        train_over["lr_milestones"] = tuple(args.steps)
    train_cfg = train_config_for(ds, **train_over)
    return model_cfg, train_cfg


def _sub_idx(args):
    """The road subset of an EXPY-TKY data dir (``tokyo_link_idx.csv``, or
    ``tokyoall_link_idx.csv`` for EXPYTKY_ALL), or None."""
    if not (args.data_dir and os.path.isdir(args.data_dir)
            and args.dataset.startswith("EXPYTKY")):
        return None
    name = ("tokyoall_link_idx.csv" if args.dataset == "EXPYTKY_ALL"
            else "tokyo_link_idx.csv")
    path = os.path.join(args.data_dir, name)
    return np.loadtxt(path).astype(int) if os.path.exists(path) else None


def _load_expytky_data(args, model_cfg, train_cfg):
    """EXPY-TKY source: monthly CSVs from --data_dir in the reference layout
    (params.txt semantics), or the synthetic stand-in when absent."""
    from megacrn_tpu_torch.data import datasets, expytky

    if args.data_dir and os.path.isdir(args.data_dir):
        sub_idx = _sub_idx(args)

        def month(ym):
            path = os.path.join(args.data_dir, f"expy-tky_{ym}.csv.gz")
            speed = expytky.load_speed_csv(path, _EXPYTKY_LINKS, sub_idx)
            time = expytky.load_time_csv(path, _EXPYTKY_LINKS, sub_idx)
            return np.concatenate([speed, time], axis=-1).astype(np.float32)

        train_months = [month("202110"), month("202111")]
        test_months = [month("202112")]
        return datasets.build_expytky(
            train_months, test_months, model_cfg.seq_len, model_cfg.horizon,
            train_cfg.batch_size, val_ratio=train_cfg.val_ratio,
            shuffle_seed=train_cfg.seed)
    return datasets.build_expytky_synthetic(
        num_nodes=model_cfg.num_nodes, his_len=model_cfg.seq_len,
        seq_len=model_cfg.horizon, batch_size=train_cfg.batch_size,
        val_ratio=train_cfg.val_ratio, shuffle_seed=train_cfg.seed)


def build_road_supports(args, model_cfg):
    """The graph constant of the sparse backends: ``--adj_path``
    (expy-tky_adj01.npy semantics) or, on SYNTH, a synthetic stand-in.
    ``road_sparse``: dual-random-walk supports -> one block-diagonal
    ``StackedRoadPack`` (``--road_impl pallas`` and ``auto``: the block-COO
    CUDA kernel; ``xla``: its plain PyTorch version) or a stacked node-ELL
    pack (``ell``). ``sparse_meta``: the symmetrised edge pattern with self
    loops -> ``build_node_pattern`` (``--sparse_meta_impl node``) or
    ``build_block_pattern`` (``block``), whole: on a node axis the
    sharded step cuts each rank's rows. None for the dense backends.
    ``partition_road_supports`` cuts the road supports for the node axis."""
    if model_cfg.graph_backend not in ("road_sparse", "sparse_meta"):
        return None
    from megacrn_tpu_torch.data import expytky

    if args.adj_path:
        adj = expytky.load_adjacency(args.adj_path, _sub_idx(args))
        if adj.shape[0] != model_cfg.num_nodes:
            raise SystemExit(
                f"adjacency is {adj.shape[0]} nodes, model expects "
                f"{model_cfg.num_nodes}")
    else:
        if args.dataset != "SYNTH":
            raise SystemExit(
                f"--graph_backend={model_cfg.graph_backend} requires "
                "--adj_path (or --dataset SYNTH for a generated graph)")
        from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency

        adj = synthetic_road_adjacency(model_cfg.num_nodes, avg_degree=8,
                                       seed=0)
    if model_cfg.graph_backend == "road_sparse":
        from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

        supports = list(dual_random_walk_supports(adj))
        if args.mesh_node > 1:
            return partition_road_supports(args, supports)
        if args.road_impl == "ell":
            from megacrn_tpu_torch.kernels.spmm_ell_node import \
                build_stacked_node_ell

            return build_stacked_node_ell(supports)
        from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack

        # 'auto' takes the block-COO kernel: on the H100 an EXPY-TKY train
        # step (N=1843, batch 64) ran 63.0-69.6 ms through it against
        # 222.6-301.1 ms on the bucketed node-ELL pack and 259.5-262.2 ms on
        # the flat one (chip_smoke.py phases 7 and 11; NVIDIA H100 80GB
        # HBM3, 700.00 W; PERF.md). The JAX CLI's auto -> ell is a policy
        # measured on the TPU.
        impl = {"auto": "kernel", "pallas": "kernel",
                "xla": "reference"}[args.road_impl]
        return build_stacked_road_pack(supports, impl=impl)
    # sparse_meta: the learned meta-graph restricted to the symmetrised
    # edge pattern (+ self loops, so every row has at least one edge).
    pat = ((adj != 0) | (adj.T != 0)).astype(np.float32)
    np.fill_diagonal(pat, 1.0)
    if args.sparse_meta_impl == "node":
        from megacrn_tpu_torch.kernels.sparse_graph_node import \
            build_node_pattern

        return build_node_pattern(pat)
    from megacrn_tpu_torch.kernels.sparse_graph import build_block_pattern

    return build_block_pattern(pat)


def partition_road_supports(args, supports):
    """The road supports cut into the row blocks of the ``--mesh_node``
    axis for fit's node-partitioned step: node-ELL (``--road_impl ell``)
    or block-ELL packs (the others: the block-ELL CUDA kernel, or with
    ``xla`` its plain version), as the JAX CLI cuts them."""
    if args.road_impl == "ell":
        from megacrn_tpu_torch.kernels.spmm_ell_node import shard_node_ell

        return shard_node_ell(supports, args.mesh_node)
    from megacrn_tpu_torch.kernels.spmm import shard_road_packs

    return shard_road_packs(supports, args.mesh_node, impl=(
        "reference" if args.road_impl == "xla" else "kernel"))


def _predict_fn(model, road_supports):
    """``(x0, y_cov) -> normalised predictions`` (a tensor on the model's
    device) of the eval-mode forward, for ``train.eval_modes``."""
    import torch

    from megacrn_tpu_torch.models.megacrn import DTYPES
    from megacrn_tpu_torch.ops.graph import road_supports_to
    from megacrn_tpu_torch.train.loop import to_device

    device = next(model.parameters()).device
    sup = road_supports_to(road_supports, device,
                           DTYPES[model.cfg.compute_dtype])

    @torch.no_grad()
    def predict(x0, y_cov):
        x, yc = to_device((x0, y_cov), device)
        return model(x, yc, road_supports=sup).output

    return predict


def _make_concat_final_eval(model_cfg, data, road_supports=None):
    """traintestv1 flavor (model/traintestv1_MegaCRN.py:54-92): global
    metrics over concatenated, pad-trimmed, inverse-transformed preds."""
    from megacrn_tpu_torch.train.eval_modes import eval_concat

    def final_eval(model):
        return eval_concat(_predict_fn(model, road_supports),
                           data["test_loader"], model_cfg.input_dim,
                           model_cfg.output_dim, data["scaler_mean"],
                           data["scaler_std"])

    return final_eval


def _make_expytky_final_eval(model_cfg, data, road_supports=None):
    from megacrn_tpu_torch.train.eval_modes import eval_expytky

    def final_eval(model):
        return eval_expytky(_predict_fn(model, road_supports),
                            data["test_loader"], model_cfg.input_dim,
                            model_cfg.output_dim, data["scaler"])

    return final_eval


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg = configs_from_args(args)

    from megacrn_tpu_torch.data import datasets
    from megacrn_tpu_torch.parallel import launch
    from megacrn_tpu_torch.train.logs import RunDir, mesh_run_dir
    from megacrn_tpu_torch.train.loop import fit

    # Fail fast, before any data loading: no card, no adjacency.
    spawned, mesh, device = launch.cli_mesh(main, argv, args.mesh_data,
                                            args.mesh_node, args.device)
    if spawned:
        return None
    if mesh is not None and train_cfg.seed is None:
        import dataclasses
        import time

        from megacrn_tpu_torch.parallel.comm import broadcast_object

        # One seed on every rank: the loaders' order and the coins agree.
        train_cfg = dataclasses.replace(
            train_cfg, seed=broadcast_object(int(time.time())))
    road_supports = build_road_supports(args, model_cfg)

    # With --seed the construction-time permutation is seeded too, so one
    # seed gives one batch order and --resume continues it (the JAX CLI
    # draws that permutation from OS entropy whatever the seed).
    shuffle = dict(
        reshuffle_each_epoch=args.reshuffle_each_epoch,
        shuffle_seed=train_cfg.seed,
        shuffle_rng=(None if train_cfg.seed is None
                     else np.random.default_rng(train_cfg.seed)))
    if args.dataset == "SYNTH":
        data = datasets.build_synthetic(
            num_nodes=model_cfg.num_nodes, num_steps=args.synth_steps,
            seq_len=model_cfg.seq_len, horizon=model_cfg.horizon,
            batch_size=train_cfg.batch_size, **shuffle)
    elif args.dataset.startswith("EXPYTKY"):
        data = _load_expytky_data(args, model_cfg, train_cfg)
    else:
        if args.data_dir is None:
            raise SystemExit(f"--data_dir required for dataset {args.dataset}")
        data = datasets.load_npz_splits(args.data_dir, train_cfg.batch_size,
                                        **shuffle)

    # --resume continues the newest run dir of this dataset under
    # --save_dir (the JAX CLI opens a new, empty one and so starts afresh).
    run = mesh_run_dir(args.save_dir, args.dataset, mesh, timestring=(
        RunDir.latest_timestring(args.save_dir, args.dataset)
        if args.resume else None))
    final_eval_fn = None
    if args.dataset.startswith("EXPYTKY") or (
            train_cfg.eval_aggregation == "concat"):
        # The final evals run one device's forward: on the node-partitioned
        # road path they take the whole road constant.
        eval_supports = road_supports
        if args.mesh_node > 1 and model_cfg.graph_backend == "road_sparse":
            eval_supports = build_road_supports(
                argparse.Namespace(**dict(vars(args), mesh_node=1)),
                model_cfg)
        make = (_make_expytky_final_eval if args.dataset.startswith("EXPYTKY")
                else _make_concat_final_eval)
        final_eval_fn = make(model_cfg, data, eval_supports)
    result = fit(model_cfg, train_cfg, data, run, resume=args.resume,
                 test_every_epoch=args.test_every_epoch,
                 final_eval_fn=final_eval_fn, road_supports=road_supports,
                 profile_dir=args.profile_dir,
                 profile_steps=args.profile_steps, device=device, mesh=mesh,
                 ckpt_backend=args.ckpt_backend)
    if mesh is None or mesh.rank == 0:
        print({k: v for k, v in result["test_metrics"].items()})
    return result


if __name__ == "__main__":
    main()
