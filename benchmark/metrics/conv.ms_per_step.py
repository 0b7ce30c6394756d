"""Device ms a step of the convolutions, forward and backward, by the host
operator that launched them (profiler), over the traced steps."""

from benchmark.lib.readers import op_s, per_step_ms


def read(records):
    return per_step_ms(records, op_s(records, r"convolution"))
