"""The ImageNet-pretrained backbone body.

Counterpart of ucd_tpu/models/pretrained.py. The reference initializes
ResNet bodies from the mapillary inplace-abn ImageNet release
(`pretrained/{backbone}_{norm_act}.pth.tar`: strip the 'module.' prefix,
drop the classifier). Its `state_dict` maps onto `model.body` by renaming
alone; the ABN math is BatchNorm + leaky_relu(0.01) in both:

  mod1.conv1.weight                    -> mod1_conv1.weight
  mod1.bn1.{weight,bias,running_*}     -> mod1_bn1.bn.{...}
  modK.blockJ.convs.convI.weight       -> modK_blockJ.convI.weight
  modK.blockJ.convs.bnI.*              -> modK_blockJ.bnI.bn.*
  modK.blockJ.proj_conv.weight         -> modK_blockJ.proj_conv.weight
  modK.blockJ.proj_bn.*                -> modK_blockJ.proj_bn.bn.*

A converted `.npz` (the JAX package's `save_body_npz` format: flat
`params/...` and `batch_stats/...` flax keys) loads through
models/convert.py's mapping. Either way the result is a state_dict of
`model.body`, with a zero `num_batches_tracked` per BatchNorm.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .convert import flax_to_state_dict


def strip_module_prefix(state_dict: dict) -> dict:
    """Drop the DataParallel 'module.' prefix and the classifier head."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("classifier."):
            continue
        out[k] = v
    return out


def _body_name(key: str) -> Optional[str]:
    """A release key -> the `model.body` state_dict name, or None for an
    entry the body does not take (num_batches_tracked, unknown keys)."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "num_batches_tracked" or not parts[0].startswith("mod"):
        return None
    if parts[0] == "mod1" and len(parts) == 3:
        sub = parts[1]
        if sub == "conv1" and leaf == "weight":
            return "mod1_conv1.weight"
        if sub == "bn1":
            return f"mod1_bn1.bn.{leaf}"
        return None
    if len(parts) < 4:
        return None
    block = f"{parts[0]}_{parts[1]}"
    rest = parts[2:]
    if rest[0] == "convs" and len(rest) == 3:
        sub = rest[1]
        if sub.startswith("conv") and leaf == "weight":
            return f"{block}.{sub}.weight"
        if sub.startswith("bn"):
            return f"{block}.{sub}.bn.{leaf}"
    elif rest == ["proj_conv", "weight"]:
        return f"{block}.proj_conv.weight"
    elif rest[0] == "proj_bn" and len(rest) == 2:
        return f"{block}.proj_bn.bn.{leaf}"
    return None


def convert_release_body(state_dict: dict) -> dict:
    """An inplace-abn release state_dict -> a state_dict of `model.body`."""
    out = {}
    for key, val in strip_module_prefix(state_dict).items():
        name = _body_name(key)
        if name is None:
            continue
        out[name] = torch.as_tensor(np.asarray(val)) \
            if not isinstance(val, torch.Tensor) else val.detach().clone()
        if name.endswith(".running_mean"):
            out[name[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return out


def load_body_npz(path: str) -> dict:
    """A converted body npz (flat flax keys) -> a state_dict of
    `model.body`."""
    with np.load(path) as z:
        return flax_to_state_dict({k: z[k] for k in z.files})


def load_pretrained_torch(path: str) -> dict:
    """A `.pth` / `.pth.tar` release file -> a state_dict of `model.body`.
    Read with `weights_only=True`: tensors, numbers and dicts only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return convert_release_body(blob.get("state_dict", blob))


def _npz_sibling(path: str) -> str:
    for suf in (".pth.tar", ".pth"):
        if path.endswith(suf):
            return path[: -len(suf)] + ".npz"
    return path + ".npz"


def load_pretrained_body(path: str) -> Optional[dict]:
    """The pretrained body at `path` as a state_dict of `model.body`: an
    `.npz`, or a `.pth` / `.pth.tar` release (whose `.npz` sibling, when
    present, is taken first). None if the file is missing."""
    if path.endswith(".npz"):
        return load_body_npz(path) if os.path.exists(path) else None
    sibling = _npz_sibling(path)
    if os.path.exists(sibling):
        return load_body_npz(sibling)
    if not os.path.exists(path):
        return None
    return load_pretrained_torch(path)
