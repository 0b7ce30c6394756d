"""The port's kernels. Each module holds a wrapper that launches a
hand-written CUDA kernel on CUDA tensors, its plain PyTorch version (used
for CPU tensors and as the reference on the card) and a launch count."""
