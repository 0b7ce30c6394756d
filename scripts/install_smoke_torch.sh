#!/bin/bash
# Fresh-venv install + CLI smoke of the PyTorch/CUDA port: python -m venv,
# pip install -e ., the environment check, then a dataset-free synthetic
# training run through the installed `ucd_torch` console script on the
# CPU.
#
# Zero-egress note: pip cannot download anything here, so the venv bridges to
# the invoking interpreter's site-packages via a .pth (the preinstalled
# torch stack; also covers the case where the invoking python is itself a
# venv, which --system-site-packages would NOT inherit) and the install runs
# --no-deps --no-build-isolation.
set -e
cd "$(dirname "$0")/.."
VENV="${1:-${TMPDIR:-/tmp}/ucd_torch_venv}"

rm -rf "$VENV"
python -m venv "$VENV"
SITE=$(python -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
VSITE=$("$VENV/bin/python" -c "import sysconfig; print(sysconfig.get_paths()['purelib'])")
echo "$SITE" > "$VSITE/_parent_site.pth"

"$VENV/bin/pip" install -e . --no-deps --no-build-isolation -q

# environment manifest gate (environment/MANIFEST_torch.md): on a GPU host
# the bridged venv must expose the card's pinned stack; a host without a
# GPU is checked as a CPU host (--cpu)
if "$VENV/bin/python" -c "import sys, torch; sys.exit(not torch.cuda.is_available())"; then
    "$VENV/bin/python" scripts/check_env_torch.py
else
    "$VENV/bin/python" scripts/check_env_torch.py --cpu
fi

OUT=$(mktemp -d)
"$VENV/bin/ucd_torch" train --dataset voc --task 19-1 --step 0 \
    --method FT --backbone resnet50 --crop_size 32 --batch_size 4 \
    --epochs 1 --dtype float32 --no_pretrained --synthetic 8 \
    --logdir "$OUT/logs" --ckpt_dir "$OUT/ckpt" --name smoke --device cpu
rm -rf "$OUT"
echo "INSTALL SMOKE PASSED ($VENV)"
