#!/bin/bash
# ADE20K parity runbook of the PyTorch/CUDA port: UCD on 100-50 (set
# TASK=100-10 / 50 for the other orders), 60 epochs/step per the reference
# recipe (the reference's README.md:53,62-63). The reference repo publishes
# NO machine-readable ADE numbers (BASELINE.md: re-derive the bar from the
# TPAMI paper before claiming parity) — parity_report_torch.py records the
# aggregate without judging it.
#
# Usage:
#   scripts/parity_ade_torch.sh /path/to/ADEChallengeData2016   # real run
#   scripts/parity_ade_torch.sh --dry                           # dataset-free dry run
#   DEVICE=cpu scripts/parity_ade_torch.sh --dry                # on a host without a GPU
set -e
cd "$(dirname "$0")/.."

TASK="${TASK:-100-50}"
NAME="${NAME:-UCD-parity}"
LOGDIR="${LOGDIR:-./logs/parity_ade_torch}"
CKPTDIR="${CKPTDIR:-./checkpoints/parity_ade_torch}"
DEVICE="${DEVICE:-cuda}"

DRY=0
if [ "$1" == "--dry" ]; then
    DRY=1
    EXTRA=(--synthetic_learnable 48 --no_pretrained --backbone resnet50
           --crop_size 64 --batch_size 8 --epochs 2 --dtype float32)
    DATA_ROOT=data
else
    DATA_ROOT="${1:?usage: scripts/parity_ade_torch.sh <data_root> | --dry}"
    if [ ! -d "$DATA_ROOT/images/training" ] && \
       [ ! -d "$DATA_ROOT/ADEChallengeData2016" ]; then
        echo "ERROR: $DATA_ROOT lacks the ADEChallengeData2016 layout" >&2
        exit 3
    fi
    if [ ! -f pretrained/resnet101_iabn_sync.pth.tar ] && \
       [ ! -f pretrained/resnet101_iabn_sync.npz ]; then
        echo "ERROR: missing pretrained/resnet101_iabn_sync.{pth.tar,npz}" >&2
        exit 3
    fi
    EXTRA=(--crop_size 512 --batch_size 24 --epochs 60)
fi

N_STEPS=$(python -c "from ucd_torch import tasks; print(tasks.num_steps('ade','$TASK'))")
for STEP in $(seq 0 $((N_STEPS - 1))); do
    if [ "$STEP" -eq 0 ]; then LR=0.01; else LR=0.001; fi
    echo "=== step $STEP/$((N_STEPS - 1)) (lr=$LR) ==="
    python -m ucd_torch.cli train \
        --dataset ade --task "$TASK" --step "$STEP" \
        --method UCD --lr "$LR" --data_root "$DATA_ROOT" \
        --name "$NAME" --logdir "$LOGDIR" --ckpt_dir "$CKPTDIR" \
        --device "$DEVICE" "${EXTRA[@]}"
done

CSV="$LOGDIR/${TASK}-ade/$NAME/results.csv"
if [ "$DRY" == "1" ]; then
    python scripts/parity_report_torch.py "$CSV" ade "$TASK" || true
    echo "DRY RUNBOOK COMPLETE"
else
    python scripts/parity_report_torch.py "$CSV" ade "$TASK"
fi
