#!/bin/bash
# Deployment workflow of the PyTorch/CUDA port: pack the final trained step
# of a task into ONE self-describing inference npz, then run predictions
# from it on a serving host that has nothing but ucd_torch + the npz + the
# images (no dataset tree, no pretrained backbone file, no training config).
# The npz has the JAX package's format, and the port serves an npz that
# the JAX package exported.
#
# The reference has no equivalent: its prediction dumps require the full
# test.py eval entry (dataset + NCCL init + every training flag).
set -e
cd "$(dirname "$0")/.."

CKPT=${1:-checkpoints/step/15-5s-voc_UCD_5}

# --backbone etc. describe the trained architecture (same flags as train);
# the per-step class list is read from the checkpoint's classifier heads,
# so --task/--step need not be repeated; tensors are cast to bf16 (pass
# --export_dtype float32 for exact f32)
python -m ucd_torch.cli export --ckpt "$CKPT" --out model.npz \
    --dataset voc --backbone resnet101 --no_pretrained

# serving: the fused upsample+argmax kernel (B6, one launch a batch);
# mixed image sizes pad into 128-multiple shape buckets, so a whole
# directory runs as a handful of batch shapes
python -m ucd_torch.cli predict --model model.npz \
    --images photos/ --out predictions/ --save_ids

# HTTP server with dynamic micro-batching (concurrent requests coalesce
# into batched calls on the card):
#   python -m ucd_torch.cli serve --model model.npz --port 8433 \
#       --warmup_size 512

# test-time augmentation (slower; takes the plain upsample + argmax):
#   ... --fusion-mode voting --test_scales 0.75,1.0,1.25 --test_flip
