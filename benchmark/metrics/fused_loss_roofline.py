"""B1 and B2 (the fused upsample + unbiased CE / KD, forward and
backward) against their roofline: the least time of the launches in the
traced stretch (benchmark/flops.py; exp and log at the f32 rate) over
their device time by kernel name (the backward's cell and fold kernels
both)."""

from benchmark import flops
from benchmark.lib.readers import kernel_s, share_pct


def read(records):
    s = records.get("fused_loss")
    got = records.get("launches") or {}
    nf = got.get("fused_ce_kd.launches_fwd", 0)
    nb = got.get("fused_ce_kd.launches_bwd", 0)
    if not s or nf + nb <= 0:
        return None
    args = (s["B"], s["h"], s["w"], s["C"], s["Co"], s["H"], s["W"],
            s["old_cl"])
    bound = nf * flops.bound_s(*flops.fused_loss_work(*args, False),
                               flops.F32_FLOP_PER_S) \
        + nb * flops.bound_s(*flops.fused_loss_work(*args, True),
                             flops.F32_FLOP_PER_S)
    return share_pct(bound, kernel_s(records, r"fused_loss_(fwd|bwd|fold)"))
