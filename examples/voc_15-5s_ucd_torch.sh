#!/bin/bash
# Reproduce the reference's headline experiment with the PyTorch/CUDA port:
# UCD on VOC 15-5s overlapped (reference README.md:62-65 — two
# torch.distributed.launch commands per step), as one command per step on
# one GPU.
#
# Expects:
#   data/PascalVOC12/{JPEGImages,SegmentationClassAug,splits}
#   pretrained/resnet101_iabn_sync.pth.tar  (mapillary inplace-abn release)
#
# Several GPUs: prefix each command with
#   torchrun --nproc_per_node N -m ucd_torch.cli ... --distributed
# (--batch_size stays the global batch).
set -e
cd "$(dirname "$0")/.."

python -m ucd_torch.cli train --dataset voc --task 15-5s --overlap \
    --method UCD --step 0 --lr 0.01 --epochs 30 --batch_size 24 \
    --data_root data/PascalVOC12 --name UCD

for step in 1 2 3 4 5; do
  python -m ucd_torch.cli train --dataset voc --task 15-5s --overlap \
      --method UCD --step "$step" --lr 0.001 --epochs 30 --batch_size 24 \
      --data_root data/PascalVOC12 --name UCD
done

# equivalent single command (the installed console script is `ucd_torch`):
#   ucd_torch run-task --dataset voc --task 15-5s --overlap \
#       --method UCD --lr 0.001 --epochs 30 --batch_size 24 \
#       --data_root data/PascalVOC12 --name UCD

# Performance knobs: bound the contrastive anchor budget (the reference's
# effective anchor set is labeled pixels only, so a fixed budget is close
# to its real behavior):
#   ... --contrastive_capacity 4096
# and train K steps per call through a CUDA graph (the same updates):
#   ... --steps_per_call 4
