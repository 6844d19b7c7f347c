"""Train and eval steps over a (data, node) mesh (counterpart of
``megacrn_tpu/parallel/api.py``).

Every rank runs one process and holds a replica of the model and its
optimizer; the batch arrives cut to the rank's block (``mesh.shard_batch``).
JAX has two partitioning styles, GSPMD (``make_sharded_train_step``, where
XLA inserts the all-gather from sharding constraints) and ``shard_map``
(explicit ``psum``/``all_gather``/``ppermute``). PyTorch has no GSPMD, so
every step here writes its collectives out as ``shard_map`` does; the JAX
tests hold both styles to the single-device step, so the numbers are the
same.

**Parameters are replicated** on every rank, We1/We2 included. JAX's GSPMD
path row-shards We1/We2 over the node axis; that is a layout choice which
``make_ring_train_step`` itself does not make (it replicates them and
slices the node embeddings, ``parallel.ring.local_meta_supports``).

**Global loss normalisation.** Each rank computes its share of the ONE
global objective, and the shares sum to it over the step's group:
``num_r / max(den, 1)`` for the masked MAE, where only the mask count
``den`` is summed over the ranks before the division (exact under uneven
mask density across shards), ``sum_r / count`` for the plain L1 losses,
and the auxiliary losses (equal-shard means) as ``aux_r / P``. After the
backward the gradients are summed over the group, in one all-reduce with
the loss shares riding along: that is exactly the single-device gradient
(JAX's "pmean cancels the P overcount" is the same identity), and the
reported loss is the summed shares. Then the clip and Adam run on every
rank alike.

**Replicated coins.** Every rank draws the same scheduled-sampling coins
and GTS Gumbel uniforms: the caller seeds the step's ``torch.Generator``
alike on every rank.

The data-parallel steps (``make_shardmap_train_step``, the families')
run the whole forward on the rank's batch rows; under a node axis > 1 the
ranks of a data row compute the same, as the JAX ``shard_map`` over
``data`` replicates them. The node-partitioned steps (``dense`` and
``sparse_meta`` under ``make_sharded_train_step``, ``make_ring_train_step``,
``make_road_node_train_step``) hand the model the mesh's node group, and
sum over every rank. Each returned step carries ``shard_nodes``: whether
its batch blocks are cut along the nodes too.
"""
from __future__ import annotations

from typing import Callable

import torch

from megacrn_tpu_torch.models.megacrn import MegaCRNOutput
from megacrn_tpu_torch.ops import losses
from megacrn_tpu_torch.ops.graph import rank_rows
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.parallel.comm import Group, all_gather, psum
from megacrn_tpu_torch.parallel.mesh import Mesh
from megacrn_tpu_torch.train.optim import clip_gradients
from megacrn_tpu_torch.train.steps import _model_supports


def _count(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The number of elements of ``t`` over the group, in t's dtype."""
    return psum(torch.tensor(float(t.numel()), dtype=t.dtype,
                             device=t.device), group)


def _global_masked_loss(out, y, train_cfg, scaler_mean, scaler_std,
                        group: Group) -> torch.Tensor:
    """This rank's share of the composite objective: the shares sum over
    ``group`` to the single-device loss (module docstring)."""
    y = y.to(out.output.dtype)
    if train_cfg.pred_loss == "masked_mae_inv":
        y_pred = inverse_transform(out.output, scaler_std, scaler_mean)
        y_true = inverse_transform(y, scaler_std, scaler_mean)
        num, den = losses.masked_mae_sums(y_pred, y_true)
        # den is a mask count (0 or >= 1) and num is 0 wherever den is, so
        # the max() guard gives masked_mae_loss's 0-or-ratio.
        pred_loss = num / psum(den, group).clamp_min(1.0)
    elif train_cfg.pred_loss == "l1_normalized":
        err = (out.output - y).abs()
        pred_loss = err.sum() / _count(err, group)
    else:
        raise ValueError(f"unknown pred_loss {train_cfg.pred_loss!r}")
    aux = losses.megacrn_aux_losses(out.query, out.pos, out.neg,
                                    train_cfg.lamb, train_cfg.lamb1)
    return pred_loss + aux / group.size


def _sum_grads(params, group: Group, shares: torch.Tensor) -> torch.Tensor:
    """Sum every gradient over ``group`` in place, in one all-reduce with
    ``shares`` (the rank's loss terms) riding along; returns the summed
    shares."""
    if group.size == 1:
        return shares
    grads = [p.grad for p in params if p.grad is not None]
    dtype = grads[0].dtype if grads else shares.dtype
    flat = psum(torch.cat([g.reshape(-1) for g in grads]
                          + [shares.reshape(-1).to(dtype)]), group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[off:].reshape(shares.shape).to(shares.dtype)


def _megacrn_step(model, train_cfg, optimizer, generator, scaler_mean,
                  scaler_std, road_supports, group: Group, node_group,
                  shard_nodes: bool) -> Callable:
    supports = _model_supports(model, road_supports, transpose=True)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x, y, y_cov, batches_seen):
        optimizer.zero_grad(set_to_none=True)
        out = model(x, y_cov, road_supports=supports, labels=y,
                    batches_seen=batches_seen, generator=generator,
                    training=True, node_group=node_group)
        share = _global_masked_loss(out, y, train_cfg, scaler_mean,
                                    scaler_std, group)
        share.backward()
        loss = _sum_grads(params, group, share.detach())
        clip_gradients(params, train_cfg)
        optimizer.step()
        return loss

    step.shard_nodes = shard_nodes
    return step


def make_shardmap_train_step(model, train_cfg, optimizer, mesh: Mesh,
                             generator: torch.Generator,
                             scaler_mean: float = 0.0,
                             scaler_std: float = 1.0,
                             road_supports=None) -> Callable:
    """Data-parallel train step for EVERY graph backend, the block-COO
    ``StackedRoadPack`` included: each rank runs the whole forward and
    backward on its batch rows (its kernels run on its data), and the
    gradients are summed over ``data``. Returns ``(x, y, y_cov,
    batches_seen) -> loss`` (the global loss, detached), as
    ``train.steps.make_train_step`` does, for the rank's
    (B / data, T, N, C) blocks."""
    return _megacrn_step(model, train_cfg, optimizer, generator,
                         scaler_mean, scaler_std, road_supports,
                         mesh.data_group, None, shard_nodes=False)


def make_sharded_train_step(model, train_cfg, optimizer, mesh: Mesh,
                            generator: torch.Generator,
                            scaler_mean: float = 0.0,
                            scaler_std: float = 1.0,
                            road_supports=None) -> Callable:
    """The counterpart of the JAX GSPMD step: ``dense`` and ``sparse_meta``
    on the data axis, and on the node axis too. There each rank all-gathers
    the x node blocks into its rows of the supports: ``dense`` builds its
    rows of the meta-graph (the per-support recursion is kept);
    ``sparse_meta`` takes the whole pattern (``road_supports``) and cuts
    the rank's rows of it, whose SDDMM and softmax it computes from the
    whole node embeddings. ``road_sparse`` and ``dense_ring`` take their
    own steps, as in JAX."""
    backend = model.cfg.graph_backend
    if backend == "road_sparse":
        raise ValueError(
            "graph_backend='road_sparse' takes make_shardmap_train_step "
            "(data parallel) or make_road_node_train_step (node partition)")
    if backend == "dense_ring":
        raise ValueError("graph_backend='dense_ring' takes "
                         "make_ring_train_step")
    if mesh.node > 1:
        rows = rank_rows(road_supports, mesh.node_index, mesh.node)
        return _megacrn_step(model, train_cfg, optimizer, generator,
                             scaler_mean, scaler_std, rows, mesh.world,
                             mesh.node_group, shard_nodes=True)
    return make_shardmap_train_step(model, train_cfg, optimizer, mesh,
                                    generator, scaler_mean, scaler_std,
                                    road_supports)


def make_ring_train_step(model, train_cfg, optimizer, mesh: Mesh,
                         generator: torch.Generator,
                         scaler_mean: float = 0.0,
                         scaler_std: float = 1.0) -> Callable:
    """Node-partitioned + data-parallel train step of ``dense_ring``: the
    batch rows over ``data``, the nodes over ``node``; each rank builds its
    rows of the meta-graph supports and every ``support @ x`` runs the ring
    schedule (``parallel.ring``). num_nodes and the batch must divide by
    the axes."""
    if model.cfg.graph_backend != "dense_ring":
        raise ValueError("make_ring_train_step requires "
                         "graph_backend='dense_ring'")
    return _megacrn_step(model, train_cfg, optimizer, generator,
                         scaler_mean, scaler_std, None, mesh.world,
                         mesh.node_group, shard_nodes=True)


def make_road_node_train_step(model, train_cfg, optimizer, mesh: Mesh,
                              sharded_packs, generator: torch.Generator,
                              scaler_mean: float = 0.0,
                              scaler_std: float = 1.0) -> Callable:
    """Node-partitioned + data-parallel train step of ``road_sparse``: each
    rank holds the row-block packs of its nodes
    (``kernels.spmm.shard_road_packs``: block-ELL, the CUDA kernel on the
    card; or ``kernels.spmm_ell_node.shard_node_ell``: node-ELL, flat or
    bucketed), all-gathers the x node blocks and multiplies its rows
    only."""
    if model.cfg.graph_backend != "road_sparse":
        raise ValueError("make_road_node_train_step requires "
                         "graph_backend='road_sparse'")
    rows = rank_rows(sharded_packs, mesh.node_index, mesh.node)
    return _megacrn_step(model, train_cfg, optimizer, generator,
                         scaler_mean, scaler_std, rows, mesh.world,
                         mesh.node_group, shard_nodes=True)


def gather_output(out: MegaCRNOutput, mesh: Mesh,
                  nodes: bool) -> MegaCRNOutput:
    """The global forward output from the ranks' blocks: gathered over the
    node axis (with ``nodes``) and the data axis."""
    fields = []
    for name, t in zip(out._fields, out):
        if nodes:
            t = all_gather(t, mesh.node_group, dim=2 if name == "output"
                           else 1)
        fields.append(all_gather(t, mesh.data_group, dim=0))
    return MegaCRNOutput(*fields)


def _eval_forward(model, mesh: Mesh, road_supports, node_group) -> Callable:
    supports = _model_supports(model, road_supports, transpose=False)
    nodes = node_group is not None

    @torch.no_grad()
    def fwd(x, y_cov):
        out = model(x, y_cov, road_supports=supports, node_group=node_group)
        return gather_output(out, mesh, nodes)

    fwd.shard_nodes = nodes
    return fwd


def make_shardmap_eval_forward(model, mesh: Mesh,
                               road_supports=None) -> Callable:
    """Data-parallel eval forward (any backend): ``(x, y_cov) ->
    MegaCRNOutput`` of the GLOBAL batch, from the rank's
    (B / data, T, N, C) blocks."""
    return _eval_forward(model, mesh, road_supports, None)


def make_sharded_eval_forward(model, mesh: Mesh,
                              road_supports=None) -> Callable:
    """The eval forward of ``make_sharded_train_step``'s layout: the node
    axis partitions ``dense`` and ``sparse_meta`` when it is > 1."""
    if model.cfg.graph_backend == "road_sparse":
        raise ValueError("use make_shardmap_eval_forward or "
                         "make_road_node_eval_forward for road_sparse")
    if mesh.node == 1:
        return _eval_forward(model, mesh, road_supports, None)
    return _eval_forward(
        model, mesh, rank_rows(road_supports, mesh.node_index, mesh.node),
        mesh.node_group)


def make_road_node_eval_forward(model, mesh: Mesh,
                                sharded_packs) -> Callable:
    """Eval forward of the node-partitioned road_sparse path; the outputs
    come back global."""
    return _eval_forward(
        model, mesh, rank_rows(sharded_packs, mesh.node_index, mesh.node),
        mesh.node_group)


def make_gts_mesh_train_step(model, train_cfg, optimizer, mesh: Mesh,
                             generator: torch.Generator, scaler_mean,
                             scaler_std, node_feas: torch.Tensor,
                             knn_prior: torch.Tensor,
                             gumbel_noise: bool = True) -> Callable:
    """Data-parallel GTS train step: ``(x, y, batches_seen) -> loss`` on the
    rank's batch rows, as ``train.gts_loop.make_gts_train_step``.

    The graph learner's BatchNorm reads ``node_feas``, the replicated
    training series, not the batch: every rank computes the same batch
    statistics and running state, and no statistic crosses ranks. The BCE
    graph loss depends only on replicated inputs (share ``bce / P``), and
    the same generator seed on every rank samples the same graph."""
    from megacrn_tpu_torch.train.gts_loop import bce

    group = mesh.data_group
    prior = knn_prior.reshape(-1)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x, y, batches_seen):
        optimizer.zero_grad(set_to_none=True)
        out = model(x, node_feas, labels=y, batches_seen=batches_seen,
                    generator=generator, training=True,
                    gumbel_noise=gumbel_noise)
        y = y.to(out.output.dtype)
        num, den = losses.masked_mae_sums(
            inverse_transform(out.output, scaler_std, scaler_mean),
            inverse_transform(y, scaler_std, scaler_mean))
        share = (num / psum(den, group).clamp_min(1.0)
                 + bce(out.adj_prob.reshape(-1), prior) / group.size)
        share.backward()
        loss = _sum_grads(params, group, share.detach())
        clip_gradients(params, train_cfg)
        optimizer.step()
        return loss

    step.shard_nodes = False
    return step


def make_megacrnx_mesh_train_step(model, train_cfg, optimizer, mesh: Mesh,
                                  scaler_mean: float,
                                  scaler_std: float) -> Callable:
    """Data-parallel MegaCRNx train step: ``(x, y_raw, y_cov) -> (loss,
    loss1, loss2, loss3)`` as one detached tensor, as
    ``train.megacrnx_loop.make_megacrnx_train_step``; the node axis, if
    any, is replicated. ``MaskMAE`` sums its mask count over ``data``
    (``masked_mae_null_sums``), ``MAE`` its element count; the memory
    losses enter as equal-shard means. No scheduled sampling, no clip.

    With ``meta_type`` the decoder's support contracts the meta embeddings
    over the batch; here the ranks' partial contractions are summed
    (``comm.all_reduce_sum``), so the step is the single-device step. The
    JAX mesh step contracts each shard's rows alone, which equals the
    single-device step only without ``meta_type`` (ROADMAP Queue 3)."""
    group = mesh.data_group
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x, y, y_cov):
        optimizer.zero_grad(set_to_none=True)
        out = model(x, y_cov, data_group=group)
        y = y.to(out.output.dtype)
        y_pred = inverse_transform(out.output, scaler_std, scaler_mean)
        if train_cfg.loss == "MaskMAE":
            num, den = losses.masked_mae_null_sums(y_pred, y, null_val=1e-3)
            l1 = num / psum(den, group).clamp_min(1.0)
        elif train_cfg.loss == "MAE":
            err = (y_pred - y).abs()
            l1 = err.sum() / _count(err, group)
        else:
            raise ValueError(f"unknown loss {train_cfg.loss!r}")
        if out.query is None:  # memory_type=False: no memory losses
            l2 = l3 = torch.zeros((), dtype=y_pred.dtype,
                                  device=y_pred.device)
        else:
            pos, neg = out.pos.detach(), out.neg.detach()
            l2 = losses.triplet_margin_loss(out.query, pos, neg,
                                            margin=1.0) / group.size
            l3 = losses.mse(out.query, pos) / group.size
        total = l1 + train_cfg.lamb * l2 + train_cfg.lamb1 * l3
        total.backward()
        parts = torch.stack((total, l1, l2, l3)).detach()
        vals = _sum_grads(params, group, parts)
        optimizer.step()
        return vals

    step.shard_nodes = False
    return step
