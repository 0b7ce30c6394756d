#!/bin/bash
# Reproduce the reference's ADE20k headline experiment with the PyTorch/CUDA
# port: UCD on ADE 100-50 (reference README.md:62 — torch.distributed.launch
# per step, batch 12 x 2 GPUs, 60 epochs), as one command per step.
#
# Expects:
#   data/ADEChallengeData2016/{images,annotations}
#   pretrained/resnet101_iabn_sync.pth.tar  (mapillary inplace-abn release)
#
# Two GPUs, as the reference: prefix each command with
#   torchrun --nproc_per_node 2 -m ucd_torch.cli ... --distributed
set -e
cd "$(dirname "$0")/.."

python -m ucd_torch.cli train --dataset ade --task 100-50 \
    --method UCD --step 0 --lr 0.01 --epochs 60 --batch_size 24 \
    --data_root data/ADEChallengeData2016 --name UCD

python -m ucd_torch.cli train --dataset ade --task 100-50 \
    --method UCD --step 1 --lr 0.001 --epochs 60 --batch_size 24 \
    --data_root data/ADEChallengeData2016 --name UCD

# equivalent single command:
#   python -m ucd_torch.cli run-task --dataset ade --task 100-50 \
#       --method UCD --lr 0.001 --epochs 60 --batch_size 24 \
#       --data_root data/ADEChallengeData2016 --name UCD

# At 151 classes the full-pixel contrastive set is the dominant non-conv
# cost; bound the anchor budget for about the same accuracy at a higher
# step rate:
#   ... --contrastive_capacity 4096
