"""B3-B5 (the contrastive term's pass 1, pass 2 and backward) against
their roofline: the least time of the launches in the traced stretch
(benchmark/flops.py, at the bf16 tensor rate in bf16 mode, else the f32
rate) over their device time by kernel name."""

from benchmark import flops
from benchmark.lib.readers import kernel_s, share_pct


def read(records):
    c = records.get("contrastive")
    n = (records.get("launches") or {}).get("contrastive.launches_pass1", 0)
    if not c or n <= 0:
        return None
    rate = flops.BF16_FLOP_PER_S if c["bf16"] else flops.F32_FLOP_PER_S
    work = flops.contrastive_work(c["P"], c["M"], c["D"], c["C"], c["bf16"])
    bound = n * sum(flops.bound_s(b, o, rate) for b, o in work.values())
    return share_pct(bound, kernel_s(
        records, r"contrastive_(pass1|pass2|bwd)"))
