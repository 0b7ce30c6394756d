"""The whole train step's share of the card's bf16 peak: model FLOPs of
every step completed in the window (donor forward, forward, backward at
twice the forward, and B3-B5's products; no recomputation) over the
window's seconds and 989 TFLOP/s."""

from benchmark import flops


def read(records):
    if not records.get("steps") or not records.get("window_s"):
        return None
    return 100.0 * records["step_flops"] * records["steps"] \
        / records["window_s"] / flops.BF16_FLOP_PER_S
