"""Step checkpoints with the JAX package's logical schema.

Counterpart of ucd_tpu/engine/checkpoint.py. A checkpoint is one
`torch.save` file at `cfg.ckpt_path()` holding

    {epoch, best_score, model_state{params, batch_stats}, optimizer_state,
     step, trainer_state?}

where `model_state.params` / `.batch_stats` are the model's parameters and
buffers by `state_dict` name, and `optimizer_state` is the train step's
`opt_state` ({"trace": name -> momentum buffer, "count", "nonfinite"}). It is
read back with `torch.load(..., weights_only=True)`: tensors, numbers and
dicts only. Cross-step restore is a `state_dict` merge (engine/state.py).

`import_jax_checkpoint` turns the numpy tree of a JAX step checkpoint (an
orbax directory, read by `ucd_tpu.engine.checkpoint.load_checkpoint`) into
this schema, so a step trained by the JAX package can go on in the port;
scripts/jax_ckpt_to_torch.py is the command-line bridge.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..models.convert import flax_to_state_dict

BRIDGE = "scripts/jax_ckpt_to_torch.py"

# ---------------------------------------------------------------------------
# async writes: the payload is copied to host memory at call time (so it is
# the state at the call), then torch.save and the disk write run on a
# background thread. One write in flight at a time; a failed write
# re-raises on the next save / load / wait.
# ---------------------------------------------------------------------------

_pending_lock = threading.Lock()
_pending: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None


def wait_pending() -> None:
    """Block until any in-flight async checkpoint write completes; re-raise
    its error if it failed. Called before every save and load and by
    `Experiment.close()`."""
    global _pending, _pending_error
    with _pending_lock:
        t, _pending = _pending, None
    if t is not None:
        t.join()
    with _pending_lock:
        err, _pending_error = _pending_error, None
    if err is not None:
        raise RuntimeError("async checkpoint write failed") from err


def _host(tree):
    """Detached host copies of every tensor of `tree` (never aliases of the
    live state); numbers pass through."""
    if isinstance(tree, Mapping):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write(path: str, payload: dict) -> None:
    # write, then rename: a crash mid-write never leaves a torn checkpoint
    # under the real name
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, epoch: int, best_score: float,
                    reg_saved: Optional[dict] = None,
                    reg_full: Optional[dict] = None,
                    async_write: bool = False) -> None:
    """Write the step checkpoint of `state` (an engine.train.TrainState).
    `reg_saved` / `reg_full` are the regularizer's cross-step export and
    mid-step snapshot (the regularizers come with ROADMAP A7).

    With `async_write` the device->host copy happens now, and torch.save
    plus the disk write run on a background non-daemon thread: training
    goes on during the write, and the interpreter waits for it at exit."""
    path = os.path.abspath(path)
    payload = {
        "epoch": int(epoch),
        "best_score": float(best_score),
        "model_state": {
            "params": _host(state.params),
            "batch_stats": _host(state.batch_stats),
        },
        "optimizer_state": _host(state.opt_state),
        "step": int(state.step),
    }
    trainer_state = {}
    if reg_saved is not None:
        trainer_state["regularizer"] = _host(reg_saved)
    if reg_full is not None:
        trainer_state["regularizer_full"] = _host(reg_full)
    if trainer_state:
        payload["trainer_state"] = trainer_state
    wait_pending()  # serialize writes; surface any prior failure here
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not async_write:
        _write(path, payload)
        return

    def run():
        global _pending_error
        try:
            _write(path, payload)
        except BaseException as e:  # surfaced by the next wait_pending()
            with _pending_lock:
                _pending_error = e

    global _pending
    t = threading.Thread(target=run, name="ucd-ckpt-write", daemon=False)
    with _pending_lock:
        _pending = t
    t.start()


_SCHEMA = ("epoch", "best_score", "model_state", "optimizer_state", "step")


def check_schema(ckpt: dict, path: str) -> dict:
    """An actionable failure on schema drift instead of a bare KeyError
    deep in Experiment init (the JAX package's message)."""
    missing = [k for k in _SCHEMA if k not in ckpt]
    if missing or not isinstance(ckpt.get("model_state"), dict) \
            or "params" not in ckpt["model_state"] \
            or "batch_stats" not in ckpt["model_state"]:
        raise ValueError(
            f"checkpoint at {path!r} does not match the ucd_tpu schema "
            f"(missing keys: {missing or ['model_state.params/batch_stats']}; "
            f"found: {sorted(ckpt)}). It may come from an older build — "
            f"re-save it or pass a different --ckpt.")
    return ckpt


def restore_like(template, raw):
    """`raw` (a loaded subtree) in the structure of `template`: dict keys
    must match, tensors must have the template's shape and come back on its
    device in its dtype, numbers take the template's type."""
    if template is None:
        return None
    if isinstance(template, Mapping):
        if not isinstance(raw, Mapping) or set(raw) != set(template):
            raise ValueError(
                f"checkpoint subtree mismatch: expected dict keys "
                f"{sorted(template)}, got "
                f"{sorted(raw) if isinstance(raw, Mapping) else type(raw)}")
        return {k: restore_like(v, raw[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        t = torch.as_tensor(raw)
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(t.shape)} != "
                             f"expected {tuple(template.shape)}")
        # the template's device, dtype and memory layout
        return torch.empty_like(template).copy_(t)
    return type(template)(raw)


def load_checkpoint(path: str) -> Optional[dict]:
    """The checkpoint at `path`, or None if there is none. A directory is
    an orbax checkpoint of the JAX package: it raises, naming the bridge
    that converts it (returning None would let a step train without its
    donor)."""
    wait_pending()  # a restore must see the completed in-flight write
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: an orbax checkpoint of the JAX "
            f"package. Convert it with `python {BRIDGE} {path} OUT` and "
            f"pass OUT instead.")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(path: str) -> Optional[dict]:
    ckpt = load_checkpoint(path)
    return None if ckpt is None else ckpt["model_state"]


def load_reg_saved(path: str) -> Optional[dict]:
    ckpt = load_checkpoint(path)
    if ckpt is None:
        return None
    ts = ckpt.get("trainer_state")
    return None if ts is None else ts.get("regularizer")


def load_reg_full(ckpt: Optional[dict]) -> Optional[dict]:
    """Mid-step accumulator snapshot from an already-loaded checkpoint."""
    if ckpt is None:
        return None
    ts = ckpt.get("trainer_state")
    return None if ts is None else ts.get("regularizer_full")


def state_dict_of(model_state: Mapping) -> dict:
    """A checkpoint's `model_state` as one state_dict (parameters and
    buffers), what `load_state_dict` and `build_train_state` take."""
    return {**model_state["params"], **model_state["batch_stats"]}


# ---------------------------------------------------------------------------
# JAX step checkpoint -> the port's schema
# ---------------------------------------------------------------------------

def _flatten(tree: Mapping, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


_STAT_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def import_jax_checkpoint(raw: Mapping[str, Any]) -> dict:
    """The numpy tree of a JAX step checkpoint (what
    `ucd_tpu.engine.checkpoint.load_checkpoint` returns) -> the port's
    checkpoint dict. Parameters and statistics go through
    models/convert.py's mapping (kernels transposed to OIHW, a zero
    `num_batches_tracked` per BatchNorm); optax's masked-nesterov trace
    becomes `optimizer_state["trace"]` under the same names, its schedule
    count `count`, and `apply_if_finite`'s consecutive-skip count (under
    --nan_guard) `nonfinite`; `step`, `epoch` and `best_score` carry over."""
    check_schema(raw, "<jax checkpoint>")
    if raw.get("trainer_state"):
        raise NotImplementedError(
            "the checkpoint holds regularizer state: the EWC/PI/RW "
            "regularizers are not ported yet (ROADMAP A7)")
    ms = raw["model_state"]
    sd = flax_to_state_dict({**_flatten(ms["params"], "params"),
                             **_flatten(ms["batch_stats"], "batch_stats")})
    opt = raw["optimizer_state"]
    nonfinite = 0
    if isinstance(opt, Mapping) and "inner_state" in opt:  # apply_if_finite
        nonfinite = int(np.asarray(opt["notfinite_count"]))
        opt = opt["inner_state"]
    # chain(add_decayed_weights -> EmptyState, sgd -> (TraceState,
    # ScaleByScheduleState)); orbax restores tuples as lists
    _, (trace_state, sched_state) = opt
    trace = flax_to_state_dict(_flatten(trace_state["trace"], "params"))
    return {
        "epoch": int(np.asarray(raw["epoch"])),
        "best_score": float(np.asarray(raw["best_score"])),
        "model_state": {
            "params": {k: v for k, v in sd.items()
                       if not k.endswith(_STAT_SUFFIXES)},
            "batch_stats": {k: v for k, v in sd.items()
                            if k.endswith(_STAT_SUFFIXES)},
        },
        "optimizer_state": {"trace": trace,
                            "count": int(np.asarray(sched_state["count"])),
                            "nonfinite": nonfinite},
        "step": int(np.asarray(raw["step"])),
    }
