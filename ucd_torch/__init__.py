"""ucd_torch — the PyTorch/CUDA port of ucd_tpu for NVIDIA Hopper.

The port mirrors the JAX package module by module (`ucd_torch.models.resnet`
is the counterpart of `ucd_tpu.models.resnet`, and so on) and reads the same
self-describing inference npz, so one exported file serves both packages.
It imports torch, numpy and PIL only: nothing of JAX and nothing of the JAX
package.

Entry points run on CUDA unless the caller passes ``device="cpu"``; asking
for CUDA on a host without a GPU raises instead of falling back.

What it implements:

  * serving: `engine.export.load_inference` -> `engine.predictor.Predictor`
    -> `engine.server`, with the fused upsample+argmax kernel
    (`ops/csrc/fused_argmax.cu`);
  * the train and validate steps (`engine.state.build_train_state` ->
    `engine.train.make_train_step` / `make_eval_step`) for every method
    family of the JAX package (FT / LWF / LWF-MC / ILT / EWC / PI / RW /
    MiB / UCD, `--bce`), with the fused upsample+CE/KD forward and backward
    kernels (`ops/csrc/fused_loss.cu`), under UCD the tiled
    pixel-contrastive kernels (`ops/csrc/tiled_contrastive.cu` and its
    tensor-core header), and the EWC / PI / RW regularizers
    (`ops.regularizers`); `engine.train.make_train_bundle` trains K steps
    a call through one CUDA graph;
  * the experiment around the step: the data pipeline (`data`), step
    checkpoints with the JAX package's schema and an importer for JAX step
    checkpoints (`engine.checkpoint`), the `engine.experiment.Experiment`
    loop, `engine.export.export_inference`, and the
    train / test / run-task / export / predict / serve command line
    (`python -m ucd_torch.cli`);
  * data parallelism (`parallel`): N processes (NCCL on GPUs, gloo on the
    CPU) compute the one-process step of the global batch.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
