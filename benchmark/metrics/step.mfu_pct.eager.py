"""`step.mfu_pct`, read in the cells whose rate is
`train_img_per_s.eager`."""

from benchmark.lib.readers import same_as

read = same_as(__file__, "step.mfu_pct")
