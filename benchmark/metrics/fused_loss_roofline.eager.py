"""`fused_loss_roofline`, read in the cells whose rate is
`train_img_per_s.eager`."""

from benchmark.lib.readers import same_as

read = same_as(__file__, "fused_loss_roofline")
