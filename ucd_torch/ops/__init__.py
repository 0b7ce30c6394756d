"""The port's ops. Each kernel module holds a wrapper that launches a
hand-written CUDA kernel on CUDA tensors, its plain PyTorch version (used
for CPU tensors and as the reference on the card) and a launch count; the
losses, the regularizers and the off-path modules (`assignment`,
`contrastive_v1`) are plain torch ops."""

from .assignment import shoot_infs, sinkhorn_knopp
from .contrastive_v1 import pixel_con_loss_v1, sup_con_loss

__all__ = ["shoot_infs", "sinkhorn_knopp", "pixel_con_loss_v1",
           "sup_con_loss"]
