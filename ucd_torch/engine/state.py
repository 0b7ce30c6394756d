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
  * inside a process group, every process's state is process 0's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .. import parallel as P
from ..config import Config
from ..device import resolve_device
from ..models.segmentation import init_new_classifier, merge_old_params
from ..ops import regularizers as R
from .train import TrainState, make_optimizer


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
                      device=None):
    """Build (state, old_vars); `model` is initialized in place and moved
    to `device` (CUDA unless the caller passes one).

    * step 0: fresh init drawn from `generator` (+ optional pretrained
      body, a state_dict of `model.body`), no donor;
    * step > 0: the previous step's state_dict merged into the fresh one
      (new classifier entries keep their init), optional MiB imprinting,
      donor = the previous step's variables verbatim (copied to `device`);
    * under `cfg.regularizer`, its state (ops/regularizers.py) from
      `prev_reg_saved`, the previous step's `export_state` (None: no
      penalty), anchored at the donor's parameters.
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
    return state, old_vars
