"""Train-state construction: seeded init, pretrained restore, cross-step
growth.

Counterpart of ucd_tpu/engine/state.py:
  * fresh init from an explicit `torch.Generator`;
  * cross-step restore of the previous step's variables into the new model
    (the extra classifier keeps its init, optionally MiB-imprinted) and as
    the frozen donor's variables;
  * fresh optimizer state and, under a regularizer, its state from the
    previous step's export; step 0. Every counter is a tensor on the
    device (engine/train.py);
  * inside a process group, every process's state is process 0's;
  * on a 2-D data x model mesh (ucd_torch/parallel/mesh.py), each rank
    then keeps its channel shard of every wide tensor (`channel_sharding`)
    of the model, the momentum, the donor's variables and the
    regularizer's trees, as the JAX package's `channel_sharding` places
    them (`shard_state`; `unshard_state` and `unshard_reg_state` put the
    shards of a model group back together).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from .. import parallel as P
from ..config import Config
from ..device import resolve_device
from ..models.deeplab import MAP_BN_GROUPS
from ..models.layers import use_mesh
from ..models.segmentation import init_new_classifier, merge_old_params
from ..ops import regularizers as R
from .train import TrainState, make_optimizer


def shard_rows(name: str, size: int, n_model: int, model_index: int,
               min_size: int = 256) -> torch.Tensor:
    """The rows (output channels) of the tensor `name`, `size` rows long,
    that model rank `model_index` of `n_model` holds: a contiguous slice,
    or, for the ASPP's `map_bn` over sharded branches, a slice of each of
    its MAP_BN_GROUPS groups (models/deeplab.py)."""
    groups = 1
    if "map_bn" in name.split("."):
        branch = size // MAP_BN_GROUPS
        if branch >= min_size and branch % n_model == 0:
            groups = MAP_BN_GROUPS
    rows = torch.arange(size).view(groups, n_model, -1)
    return rows[:, model_index].reshape(-1)


def shard_state(sd: Mapping[str, torch.Tensor], n_model: int,
                model_index: int, min_size: int = 256
                ) -> Dict[str, torch.Tensor]:
    """Model rank `model_index`'s part of the full state dict `sd` (a
    model's, the momentum's or the donor's): its rows of every tensor
    `channel_sharding` shards (copies, in the tensor's memory format), the
    replicated ones as they are."""
    out = {}
    for name, dim in P.channel_sharding(n_model, sd, min_size).items():
        t = sd[name]
        if dim is None:
            out[name] = t
            continue
        rows = shard_rows(name, t.shape[0], n_model, model_index, min_size)
        first, n = int(rows[0]), len(rows)
        # a contiguous slice keeps the tensor's memory format
        if int(rows[-1]) == first + n - 1:
            part = t.detach().narrow(0, first, n)
        else:
            part = t.detach().index_select(0, rows.to(t.device))
        out[name] = part.clone(memory_format=torch.preserve_format)
    return out


def unshard_state(shards: Sequence[Mapping[str, torch.Tensor]],
                  like: Mapping[str, Any], min_size: int = 256
                  ) -> Dict[str, torch.Tensor]:
    """The full state dict of a model group's shards (`shards[i]` model
    rank i's, from `shard_state`); `like` gives the full shapes (tensors or
    shapes by name). Replicated tensors are model rank 0's."""
    n_model = len(shards)
    out = {}
    for name, dim in P.channel_sharding(n_model, like, min_size).items():
        if dim is None:
            out[name] = shards[0][name]
            continue
        first = shards[0][name]
        size = first.shape[0] * n_model
        full = first.new_empty((size,) + tuple(first.shape[1:]))
        for i, part in enumerate(shards):
            rows = shard_rows(name, size, n_model, i, min_size)
            full[rows.to(full.device)] = part[name]
        out[name] = full
    return out


def unshard_reg_state(states: Sequence[R.RegState],
                      like: Mapping[str, Any], min_size: int = 256
                      ) -> R.RegState:
    """The full regularizer state of a model group's states (`states[i]`
    model rank i's): every tree put back together by `unshard_state`."""
    out = dataclasses.replace(states[0], sharded=frozenset(), group=None)
    for f in R.TREE_FIELDS:
        trees = [getattr(rs, f) for rs in states]
        if trees[0] is not None:
            setattr(out, f, unshard_state(
                trees, {k: like[k] for k in trees[0]}, min_size))
    return out


@torch.no_grad()
def shard_module_(model: torch.nn.Module, mesh, min_size: int = 256):
    """Replace each wide parameter and buffer of `model` by this rank's
    shard (`shard_state`) and put the model on `mesh` (models/layers.py
    `use_mesh`). `model.sharded` names the sharded tensors."""
    full = dict(model.state_dict(keep_vars=True))
    shards = shard_state(full, mesh.n_model, mesh.model_index, min_size)
    sharded = set()
    for name, t in shards.items():
        if t is full[name]:
            continue
        sharded.add(name)
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        if attr in mod._parameters:
            mod._parameters[attr].data = t
        else:
            mod._buffers[attr] = t
    model.sharded = frozenset(sharded)
    return use_mesh(model, mesh)


def _on_device(sd: Mapping[str, torch.Tensor], like: Mapping[str,
                                                          torch.Tensor],
               device) -> Dict[str, torch.Tensor]:
    """Detached copies on `device`, each in the dtype of the tensor of the
    same name in `like` (what `load_state_dict` does for a module; a no-op
    for f32 variables and f32 masters); 4-D tensors in channels_last
    memory, the layout the model computes in."""
    out = {}
    for k, v in sd.items():
        dtype = like[k].dtype if k in like else v.dtype
        v = v.detach().to(device, dtype=dtype, copy=True)
        if v.ndim == 4:
            v = v.contiguous(memory_format=torch.channels_last)
        out[k] = v
    return out


def build_train_state(cfg: Config, model, generator: torch.Generator,
                      total_iters: int,
                      prev_model_state: Optional[Mapping] = None,
                      prev_reg_saved: Optional[Mapping] = None,
                      pretrained_body: Optional[Mapping] = None,
                      device=None, mesh=None, min_size: int = 256):
    """Build (state, old_vars); `model` is initialized in place and moved
    to `device` (CUDA unless the caller passes one).

    * step 0: fresh init drawn from `generator` (+ optional pretrained
      body, a state_dict of `model.body`), no donor;
    * step > 0: the previous step's state_dict merged into the fresh one
      (new classifier entries keep their init), optional MiB imprinting,
      donor = the previous step's variables verbatim (copied to `device`);
    * under `cfg.regularizer`, its state (ops/regularizers.py) from
      `prev_reg_saved`, the previous step's `export_state` (None: no
      penalty), anchored at the donor's parameters;
    * on a 2-D `mesh` (parallel/mesh.py `make_mesh_2d`): the full state
      as above, then this rank's channel shards of the model, the donor's
      variables and the momentum (`channel_sharding` at `min_size`, the
      JAX package's default 256) and of every tree of a regularizer's
      state, as the JAX package's `channel_sharding` shards a whole-built
      state.
    """
    dev = resolve_device(device)
    model.init_weights(generator)
    sd = dict(model.state_dict())

    if pretrained_body is not None:
        sd = merge_old_params(
            sd, {f"body.{k}": v for k, v in pretrained_body.items()})

    old_vars = None
    if prev_model_state is not None:
        sd = merge_old_params(sd, prev_model_state)
        if cfg.init_balanced:
            sd = init_new_classifier(sd, cfg.new_classes)
        old_vars = _on_device(prev_model_state, model.state_dict(), dev)

    model.load_state_dict(sd, strict=True)
    model.to(device=dev, memory_format=torch.channels_last)

    params = {k: p.detach() for k, p in model.named_parameters()}
    reg_state = None
    if cfg.regularizer is not None:
        reg_state = R.init_reg_state(
            cfg.regularizer, params,
            old_params=(None if old_vars is None else
                        {k: v for k, v in old_vars.items() if k in params}),
            saved=prev_reg_saved, alpha=cfg.reg_alpha,
            iterations=cfg.reg_iterations, normalize=cfg.reg_normalize)
    tx = make_optimizer(cfg, total_iters)
    state = TrainState(model=model, opt_state=tx.init(params),
                       reg_state=reg_state,
                       step=torch.zeros((), dtype=torch.int64, device=dev))
    # inside a process group every process holds the same state, as the
    # JAX state is replicated: process 0's, whatever each process drew
    P.broadcast_([*model.parameters(), *model.buffers(),
                  *R.state_tensors(reg_state),
                  *(old_vars.values() if old_vars is not None else ())])
    if mesh is not None:
        state, old_vars = shard_train_state(state, old_vars, mesh, min_size)
    return state, old_vars


def shard_train_state(state: TrainState, old_vars: Optional[Mapping], mesh,
                      min_size: int = 256):
    """Put a full train state on the 2-D `mesh`: this rank keeps its shards
    of the model (`shard_module_`), of the momentum, of the donor's
    variables and of every tree of the regularizer's state (its penalty
    weights as they were normalized whole). Returns (state, old_vars);
    build the train step after."""
    shard_module_(state.model, mesh, min_size)
    state.opt_state["trace"] = shard_state(
        state.opt_state["trace"], mesh.n_model, mesh.model_index, min_size)
    if old_vars is not None:
        old_vars = shard_state(old_vars, mesh.n_model, mesh.model_index,
                               min_size)
    rs = state.reg_state
    if rs is not None:
        for f in R.TREE_FIELDS:
            tree = getattr(rs, f)
            if tree is not None:
                setattr(rs, f, shard_state(tree, mesh.n_model,
                                           mesh.model_index, min_size))
        rs.sharded = frozenset(k for k in rs.old_params
                               if k in state.model.sharded)
        rs.group = mesh.model_group
    return state, old_vars
