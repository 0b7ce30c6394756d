#!/bin/bash
# One-command TPAMI accuracy-parity runbook of the PyTorch/CUDA port: VOC
# 15-5s overlapped, UCD. Mirrors the reference recipe
# (the reference's README.md:51-65 + run.py:186-189): ResNet-101, crop 512,
# batch 24, 30 epochs/step, SGD nesterov wd=1e-4, PolyLR^0.9, lr 0.01 at
# step 0 and 0.001 at steps > 0, per-step chained checkpoints, then the
# average_csv aggregation diffed against the published Table-1 row
# (BASELINE.md: all-step mIoU 42.2 +- 0.5).
#
# Usage:
#   scripts/parity_voc_torch.sh /path/to/data_root            # real run
#   scripts/parity_voc_torch.sh --dry                         # dataset-free dry run
#   TASK=15-5 scripts/parity_voc_torch.sh /path/to/data_root  # other VOC task
#   DEVICE=cpu scripts/parity_voc_torch.sh --dry              # on a host without a GPU
#
# Real mode requires under DATA_ROOT the reference's VOC layout
# (splits/train_aug.txt + JPEGImages + SegmentationClassAug — see
# ucd_torch/data/datasets.py) and the ImageNet inplace-ABN backbone at
# pretrained/resnet101_iabn_sync.pth.tar (or .npz; see
# ucd_torch/models/pretrained.py).
set -e
cd "$(dirname "$0")/.."

TASK="${TASK:-15-5s}"
NAME="${NAME:-UCD-parity}"
LOGDIR="${LOGDIR:-./logs/parity_voc_torch}"
CKPTDIR="${CKPTDIR:-./checkpoints/parity_voc_torch}"
DEVICE="${DEVICE:-cuda}"

DRY=0
if [ "$1" == "--dry" ]; then
    # End-to-end rehearsal without datasets: the LEARNABLE synthetic task
    # (color-coded classes) through the same command skeleton, tiny shapes.
    DRY=1
    EXTRA=(--synthetic_learnable 48 --no_pretrained --backbone resnet50
           --crop_size 64 --batch_size 8 --epochs 2 --dtype float32)
    DATA_ROOT=data
else
    DATA_ROOT="${1:?usage: scripts/parity_voc_torch.sh <data_root> | --dry}"
    if [ ! -f "$DATA_ROOT/splits/train_aug.txt" ] || \
       [ ! -d "$DATA_ROOT/SegmentationClassAug" ]; then
        echo "ERROR: $DATA_ROOT lacks the VOC layout (splits/train_aug.txt +"
        echo "SegmentationClassAug). Fetch VOC2012 + SBD aug labels per the"
        echo "reference README, then re-run." >&2
        exit 3
    fi
    if [ ! -f pretrained/resnet101_iabn_sync.pth.tar ] && \
       [ ! -f pretrained/resnet101_iabn_sync.npz ]; then
        echo "ERROR: missing pretrained/resnet101_iabn_sync.{pth.tar,npz}" >&2
        exit 3
    fi
    EXTRA=(--crop_size 512 --batch_size 24 --epochs 30)
fi

N_STEPS=$(python -c "from ucd_torch import tasks; print(tasks.num_steps('voc','$TASK'))")
for STEP in $(seq 0 $((N_STEPS - 1))); do
    if [ "$STEP" -eq 0 ]; then LR=0.01; else LR=0.001; fi
    echo "=== step $STEP/$((N_STEPS - 1)) (lr=$LR) ==="
    python -m ucd_torch.cli train \
        --dataset voc --task "$TASK" --overlap --step "$STEP" \
        --method UCD --lr "$LR" --data_root "$DATA_ROOT" \
        --name "$NAME" --logdir "$LOGDIR" --ckpt_dir "$CKPTDIR" \
        --device "$DEVICE" "${EXTRA[@]}"
done

CSV="$LOGDIR/${TASK}-voc/$NAME/results.csv"
if [ "$DRY" == "1" ]; then
    # synthetic numbers: the diff output exercises the tooling, not the bar
    python scripts/parity_report_torch.py "$CSV" voc "$TASK" --overlap || true
    echo "DRY RUNBOOK COMPLETE"
else
    python scripts/parity_report_torch.py "$CSV" voc "$TASK" --overlap
fi
