# Ported from horovod_tpu/models/dlrm.py: DLRMConfig :28-38, tiny :41-42,
# _mlp_params :45-53, init_params :56-69, param_specs :72-79, _mlp :82-89,
# _embedding_exchange :92-122, forward :125-131, loss_fn :134-144, psum_loss
# :147-151, make_train_step :170-179 and synthetic_batch :182-188
# (sync_grads :154-167 is parallel/expert.py).
"""DLRM: ``BASELINE.json`` config 5, "DLRM with hvd.alltoall embedding
exchange".

Recommendation models shard their embedding tables across ranks (model
parallel) while the MLPs run data parallel.  The tables are stacked
``[n_tables, rows, dim]`` and split over the mesh's ``ep`` axis (each ep
rank owns ``n_tables/ep`` whole tables); the batch is split over dp × ep.
Each step (:func:`_embedding_exchange`):

1. an all-gather of the (small) id matrix along ep, so that this rank sees
   the ids of every ep peer's batch slice;
2. a lookup of this rank's tables for that combined batch;
3. ONE all-to-all of the (large) embedding rows, after which each rank
   holds every table's embeddings for exactly its own batch slice.

The exchange runs on the mesh (``parallel/mesh.py`` ``all_gather`` and
:class:`~horovod_tpu_torch.parallel.mesh.AllToAll`, whose backward returns
each row's cotangent to its table's rank).  The loss is each rank's mean
over its own batch: ``DistributedOptimizer`` averages the MLPs over the
world, and ``parallel.ExpertParallel`` holds the table gradients to the
expert rule (scaled by 1/ep, averaged only over the ranks holding the same
tables), fed by :func:`param_specs`.

``init_params`` draws each table from its own stream (the generator
folded with the table's index), so that a rank can draw just its own
tables (``tables=``) and a reference all of them, alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import AllToAll, all_gather
from .moe import fold_in


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_tables: int = 8                 # total sparse features
    rows_per_table: int = 1000
    embed_dim: int = 32
    dense_dim: int = 13
    bottom_mlp: Tuple[int, ...] = (64, 32)
    top_mlp: Tuple[int, ...] = (64, 32, 1)
    dtype: torch.dtype = torch.float32
    dp_axis: Optional[str] = "dp"
    ep_axis: Optional[str] = "ep"


def tiny(**kw) -> DLRMConfig:
    return DLRMConfig(**kw)


def _mlp_params(generator, dims, dtype, device):
    ps = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        dtype=torch.float32, device=device)
        ps.append({"w": (w / np.sqrt(dims[i])).to(dtype).requires_grad_(True),
                   "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                    device=device, requires_grad=True)})
    return ps


def init_params(cfg: DLRMConfig, generator: torch.Generator, device=None,
                tables: Optional[Sequence[int]] = None) -> Dict:
    """Tables ``N(0, 0.01²)`` stacked ``[len(tables), rows, dim]`` (all
    ``n_tables`` by default; ``tables=range(i·t, (i+1)·t)`` draws ep rank
    i's block alone), table ``j`` from ``fold_in(generator, j)``; then the
    bottom and top MLPs, ``N(0, 1/fan_in)`` weights and zero biases, from
    ``generator``.  Leaves require grad."""
    device = torch.device(device) if device is not None else \
        generator.device
    tables = range(cfg.n_tables) if tables is None else tables
    stack = torch.empty((len(tables), cfg.rows_per_table, cfg.embed_dim),
                        dtype=cfg.dtype, device=device)
    for i, j in enumerate(tables):
        stack[i] = (torch.randn(stack.shape[1:], generator=fold_in(
            generator, j), dtype=torch.float32, device=device) * 0.01
                    ).to(cfg.dtype)
    inter_in = cfg.bottom_mlp[-1] + cfg.embed_dim * cfg.n_tables
    return {
        "tables": stack.requires_grad_(True),
        "bottom": _mlp_params(generator, (cfg.dense_dim,) + cfg.bottom_mlp,
                              cfg.dtype, device),
        "top": _mlp_params(generator, (inter_in,) + cfg.top_mlp, cfg.dtype,
                           device),
    }


def param_specs(cfg: DLRMConfig) -> Dict:
    """The tables are split over ``cfg.ep_axis``; the MLPs are
    replicated (None)."""
    return {
        "tables": cfg.ep_axis,
        "bottom": [{"w": None, "b": None} for _ in cfg.bottom_mlp],
        "top": [{"w": None, "b": None} for _ in cfg.top_mlp],
    }


def _mlp(x, layers, final_act=None):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _ep(cfg: DLRMConfig, mesh) -> int:
    if mesh is None or cfg.ep_axis is None \
            or cfg.ep_axis not in mesh.axis_names:
        return 1
    return mesh.size(cfg.ep_axis)


def _lookup(tables, ids):
    """``tables [t, rows, dim]`` at ``ids [B, t]`` -> ``[B, t, dim]``."""
    t = torch.arange(tables.shape[0], device=ids.device)[None, :]
    return tables[t, ids.long()]


def _embedding_exchange(tables_local, sparse_ids, cfg: DLRMConfig,
                        mesh=None):
    """Lookup + all-to-all (the reference's ``hvd.alltoall`` hot path).
    ``tables_local [n_tables/ep, rows, dim]``, ``sparse_ids [B_loc,
    n_tables]`` -> ``[B_loc, n_tables · dim]``."""
    ep = _ep(cfg, mesh)
    t_loc = tables_local.shape[0]
    if ep == 1:
        looked = _lookup(tables_local, sparse_ids)
        return looked.reshape(looked.shape[0], -1)
    ep_idx = mesh.index(cfg.ep_axis)
    ids_all = all_gather(sparse_ids, mesh, cfg.ep_axis, dim=0)
    my_ids = ids_all[:, ep_idx * t_loc:(ep_idx + 1) * t_loc]
    # [B_loc*ep, t_loc, dim]: my tables' rows for every ep peer's slice.
    looked = _lookup(tables_local, my_ids)
    # Batch slices out, table groups in -> [B_loc, n_tables, dim].
    exchanged = AllToAll.apply(looked, mesh, cfg.ep_axis, 0, 1)
    return exchanged.reshape(exchanged.shape[0], -1)


def forward(params, dense, sparse_ids, cfg: DLRMConfig, mesh=None):
    """``dense [B, dense_dim]``, ``sparse_ids [B, n_tables]`` -> logits
    ``[B]``."""
    bottom_out = _mlp(dense, params["bottom"])
    emb = _embedding_exchange(params["tables"], sparse_ids, cfg, mesh)
    interact = torch.cat([bottom_out, emb.to(bottom_out.dtype)], dim=-1)
    return _mlp(interact, params["top"])[:, 0]


def loss_fn(params, dense, sparse_ids, labels, cfg: DLRMConfig, mesh=None):
    """This rank's mean binary cross-entropy over its own batch (the JAX
    ``loss_fn`` is this scaled by 1/(dp × ep), for its gradient sums)."""
    logits = forward(params, dense, sparse_ids, cfg, mesh).float()
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels.float())


def psum_loss(loss, mesh=None):
    """The global mean loss for logging (the world's mean of every rank's
    :func:`loss_fn`, through the engine)."""
    from .moe import psum_loss as _psum
    return _psum(loss, mesh)


def make_train_step(cfg: DLRMConfig, optimizer, mesh=None, experts=None):
    """``step(params, dense, sparse_ids, labels) -> loss``: zero the
    grads, :func:`loss_fn`, backward, ``optimizer.step()`` (the MLPs, a
    ``DistributedOptimizer``) and ``experts.step()`` (a
    ``parallel.ExpertParallel`` over the tables)."""

    def step(params, dense, sparse_ids, labels):
        optimizer.zero_grad()
        if experts is not None:
            experts.zero_grad()
        loss = loss_fn(params, dense, sparse_ids, labels, cfg, mesh)
        loss.backward()
        optimizer.step()
        if experts is not None:
            experts.step()
        return loss.detach()

    return step


def synthetic_batch(cfg: DLRMConfig, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(batch, cfg.dense_dim).astype(np.float32)
    sparse = rng.randint(0, cfg.rows_per_table,
                         size=(batch, cfg.n_tables)).astype(np.int32)
    labels = rng.randint(0, 2, size=(batch,)).astype(np.int32)
    return dense, sparse, labels
