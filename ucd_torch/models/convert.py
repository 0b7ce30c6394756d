"""Weight bridge between the JAX package's variables and the port's
`state_dict`.

The flat keys are those of the inference npz (`engine/export.py`):
`params/body/mod2_block1/conv1/kernel`, `params/body/mod2_block1/bn1/bn/scale`,
`batch_stats/body/mod2_block1/bn1/bn/mean`, `params/cls_0/bias`, ... The
port names its submodules after the flax scopes, so the mapping is
mechanical:

  params/<path>/kernel  (kh, kw, in, out) -> <path>.weight (out, in, kh, kw)
  params/<path>/scale                     -> <path>.weight
  params/<path>/bias                      -> <path>.bias (a norm's, or a
                                             conv's: the classifiers, the
                                             NonLocalBlock2D's 1x1 convs)
  batch_stats/<path>/mean                 -> <path>.running_mean
  batch_stats/<path>/var                  -> <path>.running_var

plus a zero `num_batches_tracked` per BatchNorm, so that
`load_state_dict(..., strict=True)` sees every key of the module. A
GroupNorm ABN (`gn/scale`, `gn/bias`) has parameters only. The mapping
holds for any module named after its flax scopes: a whole model, one ABN,
a `NonLocalBlock2D` (`g`, `theta`, `phi`, `W` with biases, `W_bn` with its
statistics).

Arrays keep their dtype in both directions (f32, f64 for the f64 test
model; bf16 tensors widen to f32 on the way out). `load_flax_variables` and
`module_to_flax` are the two directions for a whole module, e.g. a training
model with f32 masters: one numpy tree goes into both packages, and both
packages' post-step variables come back as numpy trees with the same keys.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_STAT_LEAF_INV = {v: k for k, v in _STAT_LEAF.items()}


def flax_to_state_dict(flat: Mapping[str, object]) -> dict:
    """Flat `params/...` + `batch_stats/...` arrays (numpy or torch) -> the
    port's state_dict (torch tensors, dtypes kept)."""
    sd = {}
    for key, value in flat.items():
        collection, *path, leaf = key.split("/")
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.require(value, requirements="CW"))
        prefix = ".".join(path)
        if collection == "params" and leaf in _PARAM_LEAF:
            if leaf == "kernel":
                t = t.permute(3, 2, 0, 1).contiguous()
            sd[f"{prefix}.{_PARAM_LEAF[leaf]}"] = t
        elif collection == "batch_stats" and leaf in _STAT_LEAF:
            sd[f"{prefix}.{_STAT_LEAF[leaf]}"] = t
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((),
                                                              dtype=torch.long)
        else:
            raise KeyError(f"unexpected variable {key!r}")
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict -> flat `params/...` + `batch_stats/...` numpy
    arrays (the inverse of `flax_to_state_dict`; bf16 tensors widen to f32,
    which is exact, since numpy has no bfloat16)."""
    flat = {}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        prefix = "/".join(path)
        t = t.detach().to("cpu", copy=True)  # never an alias of the model
        if t.dtype == torch.bfloat16:
            t = t.float()
        if leaf in _STAT_LEAF_INV:
            flat[f"batch_stats/{prefix}/{_STAT_LEAF_INV[leaf]}"] = t.numpy()
        elif leaf == "weight" and t.ndim == 4:
            flat[f"params/{prefix}/kernel"] = \
                t.permute(2, 3, 1, 0).contiguous().numpy()
        elif leaf == "weight":
            flat[f"params/{prefix}/scale"] = t.numpy()
        elif leaf == "bias":
            flat[f"params/{prefix}/bias"] = t.numpy()
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
    return flat


def load_flax_variables(model: torch.nn.Module,
                        flat: Mapping[str, object]) -> torch.nn.Module:
    """Load flat `params/...` + `batch_stats/...` arrays into `model`,
    strictly (a missing or unexpected key raises); values are cast to the
    dtype each of the module's tensors already has."""
    model.load_state_dict(flax_to_state_dict(flat), strict=True)
    return model


def module_to_flax(model: torch.nn.Module) -> dict:
    """Every parameter and BatchNorm statistic of `model` as flat
    `params/...` + `batch_stats/...` numpy arrays."""
    return state_dict_to_flax(model.state_dict())
