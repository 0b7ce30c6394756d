"""Engine of the port: the train and validate steps, train-state
construction, metrics, step checkpoints and the `Experiment` loop;
inference npz export and loading, the Predictor and the micro-batching
HTTP server."""

from .train import (
    TrainState,
    compute_train_losses,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_bundle,
    make_train_step,
)
from .state import build_train_state
from .metrics import (
    AverageMeter,
    confusion_matrix_figure,
    confusion_matrix_update,
    empty_confusion,
    results_from_confusion,
    results_to_str,
)
from .checkpoint import (
    check_schema,
    import_jax_checkpoint,
    load_checkpoint,
    load_model_state,
    load_reg_full,
    load_reg_saved,
    restore_into,
    restore_like,
    save_checkpoint,
)

__all__ = [
    "TrainState", "compute_train_losses", "make_eval_step",
    "make_lr_schedule", "make_optimizer", "make_train_step",
    "make_train_bundle",
    "build_train_state", "AverageMeter", "confusion_matrix_update",
    "empty_confusion", "results_from_confusion", "results_to_str",
    "confusion_matrix_figure", "load_checkpoint", "load_model_state",
    "load_reg_saved", "load_reg_full", "save_checkpoint", "check_schema",
    "restore_like", "restore_into", "import_jax_checkpoint",
]
