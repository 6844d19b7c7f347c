"""Rank functions of the port's mesh tests (tests/test_torch_mesh*.py).

A spawned rank imports the module that defines its function afresh, so
this module imports no JAX: each rank runs the port only. The parent test
computes the JAX side, pickles the cases (numpy weights, batches, the JAX
teacher-forcing masks and Gumbel draws) and reads back what every rank
saved. Run as a script it is one process of the torchrun-style multihost
test (its rank and world come from the environment).
"""
import os
import pickle
import sys

import numpy as np
import torch


def _jax_imported() -> bool:
    return any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m in sys.modules)


def _dtype(case):
    return torch.float64 if case.get("dtype") == "float64" else torch.float32


def _grads(model, num_layers):
    from megacrn_tpu_torch.interop import flat_from_state_dict

    return flat_from_state_dict(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in model.named_parameters()}, num_layers)


def _pin_draws(case):
    """Hand the port the case's teacher-forcing mask and Gumbel uniforms
    (the JAX step's draws), in this process."""
    from megacrn_tpu_torch.models import gts as tgts
    from megacrn_tpu_torch.models import megacrn as tmegacrn

    if case.get("use_truth") is not None:
        mask = torch.from_numpy(np.asarray(case["use_truth"]))
        tmegacrn.sampling_mask = lambda *a: mask
        tgts.sampling_mask = lambda *a: mask
    if case.get("uniforms") is not None:
        u = case["uniforms"]
        tgts.gumbel_uniforms = lambda shape, g, dt: torch.tensor(u, dtype=dt)


def _pattern(case):
    """The case's whole ``sparse_meta`` edge pattern (the sharded steps cut
    each rank's rows of it themselves)."""
    from megacrn_tpu_torch.kernels.sparse_graph import build_block_pattern
    from megacrn_tpu_torch.kernels.sparse_graph_node import (
        build_node_pattern, build_node_pattern_bucketed)

    adj = case["pattern_adj"]
    if case["road"] == "block_pattern":
        return build_block_pattern(adj)
    if case["road"] == "node_pattern":
        return build_node_pattern(adj, max_buckets=1)
    return build_node_pattern_bucketed(adj, case["max_buckets"])


def _road(case, mesh):
    """The case's road constant, cut for the mesh's node axis."""
    kind = case.get("road")
    if kind is None:
        return None
    if kind.endswith("_pattern"):
        return _pattern(case)
    sups = case["supports"]
    if kind == "coo":
        from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack

        return build_stacked_road_pack(sups)
    if kind == "block_ell":
        from megacrn_tpu_torch.kernels.spmm import shard_road_packs

        return shard_road_packs(sups, mesh.node)
    from megacrn_tpu_torch.kernels.spmm_ell_node import shard_node_ell

    return shard_node_ell(sups, mesh.node, max_buckets=case["max_buckets"])


def _single_road(case):
    """The same road constant for one device."""
    kind = case.get("road")
    if kind is None:
        return None
    if kind.endswith("_pattern"):
        return _pattern(case)
    sups = case["supports"]
    if kind == "coo":
        from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack

        return build_stacked_road_pack(sups)
    if kind == "block_ell":
        from megacrn_tpu_torch.kernels.spmm import build_road_ell_pairs

        return build_road_ell_pairs(sups)
    from megacrn_tpu_torch.kernels.spmm_ell_node import build_stacked_node_ell

    return build_stacked_node_ell(sups, max_buckets=case["max_buckets"])


def _megacrn(case, dtype):
    from megacrn_tpu_torch.config import MegaCRNConfig
    from megacrn_tpu_torch.interop import params_from_flat
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    cfg = MegaCRNConfig(**case["cfg"])
    model = MegaCRN(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_flat(case["flat"], cfg, dtype=dtype))
    return model


def megacrn_step(case, mesh):
    """One mesh train step of MegaCRN (the case's step), and on
    rank 0 the single-device step on the whole batch."""
    from megacrn_tpu_torch.config import train_config_for
    from megacrn_tpu_torch.interop import flat_from_state_dict
    from megacrn_tpu_torch.parallel import api
    from megacrn_tpu_torch.parallel.mesh import shard_batch
    from megacrn_tpu_torch.train.optim import make_optimizer
    from megacrn_tpu_torch.train.steps import make_train_step

    dtype = _dtype(case)
    tcfg = train_config_for(case["protocol"], **case["train"])
    batch = [np.asarray(case[k], np.float64 if dtype == torch.float64
                        else np.float32) for k in ("x", "y", "yc")]
    model = _megacrn(case, dtype)
    opt = make_optimizer(model.parameters(), tcfg)
    gen = torch.Generator().manual_seed(0)
    road = _road(case, mesh)
    make_step = {"shardmap": api.make_shardmap_train_step,
               "sharded": api.make_sharded_train_step,
               "ring": api.make_ring_train_step}.get(case["step"])
    if case["step"] == "road_node":
        step = api.make_road_node_train_step(model, tcfg, opt, mesh, road,
                                             gen, case["mean"], case["std"])
    elif case["step"] == "ring":
        step = make_step(model, tcfg, opt, mesh, gen, case["mean"],
                       case["std"])
    else:
        step = make_step(model, tcfg, opt, mesh, gen, case["mean"],
                       case["std"], road_supports=road)
    blocks = shard_batch(batch, mesh, nodes=step.shard_nodes)
    loss = step(*(torch.from_numpy(a) for a in blocks), case["seen"])
    layers = model.cfg.num_layers
    out = {"loss": loss.item(), "grads": _grads(model, layers),
           "params": flat_from_state_dict(model.state_dict(), layers)}
    if mesh.rank == 0:
        single = _megacrn(case, dtype)
        sopt = make_optimizer(single.parameters(), tcfg)
        sstep = make_train_step(single, tcfg, sopt,
                                torch.Generator().manual_seed(0),
                                case["mean"], case["std"],
                                road_supports=_single_road(case))
        out["single_loss"] = sstep(*(torch.from_numpy(a) for a in batch),
                                   case["seen"]).item()
        out["single_grads"] = _grads(single, layers)
        out["single_params"] = flat_from_state_dict(single.state_dict(),
                                                    layers)
    return out


def road_node_eval(case, mesh):
    """The node-partitioned eval forward's gathered output, and on rank 0
    the single-device forward's."""
    from megacrn_tpu_torch.parallel import api
    from megacrn_tpu_torch.parallel.mesh import shard_batch

    model = _megacrn(case, torch.float32)
    fwd = api.make_road_node_eval_forward(model, mesh, _road(case, mesh))
    x, yc = shard_batch((case["x"], case["yc"]), mesh, nodes=True)
    out = {"output": fwd(torch.from_numpy(x), torch.from_numpy(yc))
           .output.numpy()}
    if mesh.rank == 0:
        with torch.no_grad():
            out["single"] = model(torch.from_numpy(case["x"]),
                                  torch.from_numpy(case["yc"]),
                                  road_supports=_single_road(case)
                                  ).output.numpy()
    return out


def sharded_eval(case, mesh):
    """The GSPMD-style eval forward's gathered output (the node axis
    partitioning the case's backend), and on rank 0 the single-device
    forward's."""
    from megacrn_tpu_torch.parallel import api
    from megacrn_tpu_torch.parallel.mesh import shard_batch

    model = _megacrn(case, torch.float32)
    fwd = api.make_sharded_eval_forward(model, mesh, _road(case, mesh))
    x, yc = shard_batch((case["x"], case["yc"]), mesh, nodes=fwd.shard_nodes)
    out = {"output": fwd(torch.from_numpy(x), torch.from_numpy(yc))
           .output.numpy()}
    if mesh.rank == 0:
        with torch.no_grad():
            out["single"] = model(torch.from_numpy(case["x"]),
                                  torch.from_numpy(case["yc"]),
                                  road_supports=_single_road(case)
                                  ).output.numpy()
    return out


def cli(case, mesh):
    """A CLI's ``main`` inside this group (it builds its own mesh)."""
    import importlib

    importlib.import_module(case["cli"]).main(case["argv"])
    return {}


def ring_aggregate(case, mesh):
    """``make_ring_aggregate`` on the full support and batch: this rank's
    output block and x's gradient of the summed squares (its own block)."""
    from megacrn_tpu_torch.parallel.ring import make_ring_aggregate

    support = torch.from_numpy(case["support"])
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = make_ring_aggregate(mesh)(support, x)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "gx": x.grad.numpy(),
            "index": (mesh.data_index, mesh.node_index)}


def gts_step(case, mesh):
    """One data-parallel GTS train step with the case's draws, and on rank
    0 the single-device step."""
    from megacrn_tpu_torch.config import GTSConfig, TrainConfig
    from megacrn_tpu_torch.interop import (flat_from_gts_state_dict,
                                           gts_params_from_flat)
    from megacrn_tpu_torch.models.gts import GTS
    from megacrn_tpu_torch.parallel.api import make_gts_mesh_train_step
    from megacrn_tpu_torch.parallel.mesh import shard_batch
    from megacrn_tpu_torch.train.gts_loop import make_gts_train_step

    cfg = GTSConfig(**case["cfg"])
    tcfg = TrainConfig(lr=0.005, epsilon=1e-3, max_grad_norm=5.0)
    feas, prior = (torch.from_numpy(case[k]) for k in ("feas", "prior"))

    def build():
        model = GTS(cfg, device="cpu")
        model.load_state_dict(gts_params_from_flat(case["flat"], case["bn"],
                                                   cfg))
        return model, torch.optim.Adam(model.parameters(), lr=0.005,
                                       eps=1e-3)

    model, opt = build()
    step = make_gts_mesh_train_step(
        model, tcfg, opt, mesh, torch.Generator().manual_seed(0),
        case["mean"], case["std"], feas, prior, case["noise"])
    x, y = shard_batch((case["x"], case["y"]), mesh, nodes=False)
    out = {"loss": step(torch.from_numpy(x), torch.from_numpy(y),
                        case["seen"]).item()}
    out["params"], out["bn"] = flat_from_gts_state_dict(model.state_dict(),
                                                        cfg)
    if mesh.rank == 0:
        single, sopt = build()
        sstep = make_gts_train_step(
            single, tcfg, sopt, torch.Generator().manual_seed(0),
            case["mean"], case["std"], feas, prior, case["noise"])
        out["single_loss"] = sstep(torch.from_numpy(case["x"]),
                                   torch.from_numpy(case["y"]),
                                   case["seen"]).item()
        out["single_params"], out["single_bn"] = flat_from_gts_state_dict(
            single.state_dict(), cfg)
    return out


def megacrnx_step(case, mesh):
    """One data-parallel MegaCRNx train step (SGD, as the JAX parity test
    takes it: its update is proportional to the gradient)."""
    from megacrn_tpu_torch.interop import (flat_from_megacrnx_state_dict,
                                           megacrnx_params_from_flat)
    from megacrn_tpu_torch.models.megacrnx import MegaCRNx, MegaCRNxConfig
    from megacrn_tpu_torch.parallel.api import make_megacrnx_mesh_train_step
    from megacrn_tpu_torch.parallel.mesh import shard_batch
    from megacrn_tpu_torch.train.megacrnx_loop import (
        MegaCRNxTrainConfig, make_megacrnx_train_step)

    cfg = MegaCRNxConfig(**case["cfg"])
    tcfg = MegaCRNxTrainConfig(loss=case["loss"])

    def build():
        model = MegaCRNx(cfg, device="cpu")
        model.load_state_dict(megacrnx_params_from_flat(case["flat"], cfg))
        return model, torch.optim.SGD(model.parameters(), lr=case["lr"])

    def flat(model):
        return flat_from_megacrnx_state_dict(model.state_dict(),
                                             cfg.num_layers)

    model, opt = build()
    step = make_megacrnx_mesh_train_step(model, tcfg, opt, mesh,
                                         case["mean"], case["std"])
    blocks = shard_batch((case["x"], case["y"], case["yc"]), mesh,
                         nodes=False)
    out = {"vals": step(*(torch.from_numpy(a) for a in blocks)).numpy(),
           "params": flat(model)}
    if mesh.rank == 0:
        single, sopt = build()
        out["single_vals"] = make_megacrnx_train_step(
            single, tcfg, sopt, case["mean"], case["std"])(
            *(torch.from_numpy(case[k]) for k in ("x", "y", "yc"))).numpy()
        out["single_params"] = flat(single)
    return out


KINDS = {"megacrn_step": megacrn_step, "road_node_eval": road_node_eval,
         "sharded_eval": sharded_eval, "cli": cli,
         "ring_aggregate": ring_aggregate, "gts_step": gts_step,
         "megacrnx_step": megacrnx_step}


def run_cases(case_path, out_dir):
    """Every case of ``case_path`` on its mesh; this rank's results, the
    collective counts and whether JAX was imported go to
    ``out_dir/rank{r}.pkl``."""
    from megacrn_tpu_torch.parallel import comm
    from megacrn_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for case in cases:
        mesh = make_mesh(*case["mesh"])
        _pin_draws(case)
        comm.reset_counts()
        out = KINDS[case["kind"]](case, mesh)
        out["calls"], out["staged"] = dict(comm.calls), dict(comm.staged)
        results[case["name"]] = out
    rank = torch.distributed.get_rank()
    results["jax_imported"] = _jax_imported()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def fit_runs(spec_path, out_dir):
    """Mesh ``fit`` runs of the harness test: each spec trains on its mesh
    with the seeded data and the spec's initial weights, or (a spec with
    ``cli``) runs a CLI's ``main`` inside this group; every rank's results
    go to ``out_dir/rank{r}.pkl``."""
    import importlib

    from megacrn_tpu_torch import config as tconfig
    from megacrn_tpu_torch.data import datasets
    from megacrn_tpu_torch.interop import flat_from_state_dict
    from megacrn_tpu_torch.parallel import comm
    from megacrn_tpu_torch.parallel.mesh import make_mesh
    from megacrn_tpu_torch.train import logs, loop

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        specs = pickle.load(f)
    rank = torch.distributed.get_rank()
    results = {}
    for spec in specs:
        comm.reset_counts()
        if "cli" in spec:
            importlib.import_module(spec["cli"]).main(spec["argv"])
            results[spec["name"]] = {"calls": dict(comm.calls)}
            continue
        mesh = make_mesh(*spec["mesh"])
        cfg = tconfig.MegaCRNConfig(**spec["cfg"])
        tcfg = tconfig.train_config_for(spec["protocol"], **spec["train"])
        data = datasets.build_synthetic(**spec["data"])
        run = logs.mesh_run_dir(spec["save_dir"], "T", mesh,
                                timestring=spec.get("timestring"))
        out = loop.fit(cfg, tcfg, data, run, test_every_epoch=False,
                       initial_params=spec["init"],
                       road_supports=_road(spec, mesh), device="cpu",
                       mesh=mesh, max_epochs=spec.get("max_epochs"),
                       resume=spec.get("resume", False),
                       ckpt_backend=spec.get("ckpt_backend", "npz"))
        results[spec["name"]] = {
            "params": flat_from_state_dict(out["model"].state_dict(),
                                           cfg.num_layers),
            "metrics": run.metrics_path, "calls": dict(comm.calls)}
    results["jax_imported"] = _jax_imported()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def record_imports(out_dir):
    """This rank's imported modules that the port must not need."""
    import json

    import megacrn_tpu_torch.cli.traintest  # noqa: F401  (a CLI's imports)
    import megacrn_tpu_torch.parallel.api  # noqa: F401

    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "megacrn_tpu" or m.startswith("megacrn_tpu."))
    rank = torch.distributed.get_rank()
    with open(os.path.join(out_dir, f"imports{rank}.json"), "w") as f:
        json.dump(bad, f)


def fail_on_rank_one():
    """Rank 1 exits with code 3 while rank 0 would go on for minutes."""
    import time

    if torch.distributed.get_rank() == 1:
        raise SystemExit(3)
    time.sleep(300)


def multihost_main(fixtures, out_path):
    """One process of the torchrun-style multihost test: the process group
    from the environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), the
    global (data=2, node=1) mesh, this process's half of the batch, one
    ``make_sharded_train_step``, then the fixtures' CLI runs in the same
    group; the loss goes to ``out_path``."""
    from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig
    from megacrn_tpu_torch.interop import params_from_flat
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.parallel import multihost
    from megacrn_tpu_torch.parallel.api import make_sharded_train_step
    from megacrn_tpu_torch.train.optim import make_optimizer

    torch.set_num_threads(1)
    multihost.initialize(device="cpu")
    mesh = multihost.global_mesh(data=2, node=1)
    with open(fixtures, "rb") as f:
        fx = pickle.load(f)
    cfg = MegaCRNConfig(**fx["cfg"])
    model = MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(fx["flat"], cfg))
    tcfg = TrainConfig(batch_size=fx["x"].shape[0])
    opt = make_optimizer(model.parameters(), tcfg)
    step = make_sharded_train_step(model, tcfg, opt, mesh,
                                   torch.Generator().manual_seed(0))
    half = fx["x"].shape[0] // mesh.data
    rows = slice(mesh.rank * half, (mesh.rank + 1) * half)
    x, y, yc = multihost.host_local_batch_to_global(
        mesh, [fx[k][rows] for k in ("x", "y", "yc")])
    loss = step(*(torch.from_numpy(a) for a in (x, y, yc)), 0.0)
    import importlib

    for name, argv in fx.get("clis", ()):  # CLI mains inside this group
        importlib.import_module(name).main(argv)
    with open(out_path, "w") as f:
        f.write(f"{loss.item()!r} {int(_jax_imported())}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    multihost_main(*sys.argv[1:3])
