"""ucd_torch — the PyTorch/CUDA port of ucd_tpu for NVIDIA Hopper.

The port mirrors the JAX package module by module (`ucd_torch.models.resnet`
is the counterpart of `ucd_tpu.models.resnet`, and so on) and reads the same
self-describing inference npz, so one exported file serves both packages.
It imports torch, numpy and PIL only: nothing of JAX and nothing of the JAX
package.

Entry points run on CUDA unless the caller passes ``device="cpu"``; asking
for CUDA on a host without a GPU raises instead of falling back.

Implemented so far: the serving path (`engine.export.load_inference` ->
`engine.predictor.Predictor` -> `engine.server`), with the fused
upsample+argmax kernel in `ops/csrc/fused_argmax.cu`; and the train and
validate steps (`engine.state.build_train_state` ->
`engine.train.make_train_step` / `make_eval_step`) for the FT / LWF / ILT /
MiB methods, with the fused upsample+CE/KD forward and backward kernels in
`ops/csrc/fused_loss.cu`.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
