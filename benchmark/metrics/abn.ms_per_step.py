"""Device ms a step of the ABN chain: the kernels of the batch-norm and
leaky-ReLU operators, forward and backward, and of the dtype casts
(`_to_copy` / `copy_`; casts outside ABN count too), by the host operator
that launched them (profiler), over the traced steps."""

from benchmark.lib.readers import op_s, per_step_ms


def read(records):
    return per_step_ms(records, op_s(
        records, r"batch_norm|leaky_relu|_to_copy|aten::copy_"))
