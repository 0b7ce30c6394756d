"""The port's train step on two gloo ranks against the JAX package's step
on the global batch under a regularizer, as tests/test_torch_dp_step.py
does for UCD (same start, same bounds, one image a rank at float64 with
ResNet-18): RW, whose accumulators (EWC's fisher, PI's path integral)
read the gradient. The all-reduce comes before them, so they are the
global batch's, as on the JAX side: every accumulator |e| <= 1e-5 |ref| +
1e-12 (tests/test_torch_families.py's bound), the iteration count exact.
"""

import numpy as np
import pytest

import torch_dp_workers as W
from test_torch_dp_step import check_method, x64  # noqa: F401 (fixture)
from test_torch_families import REG_FIELDS, _reg_flat
from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

assert tuple(REG_FIELDS) == W.REG_FIELDS


def test_rw_two_ranks_match_the_global_batch_step(free_tmp_path, x64):
    two, reg_j = check_method("RW", free_tmp_path, reg_seed=5)
    # the first iteration's penalty is 0 (the parameters sit at their
    # anchors); its accumulators took the iteration's gradient
    assert two["reg_count"] == int(reg_j.count) == 1
    for field in REG_FIELDS:
        a, b = two["reg"][field], _reg_flat(reg_j, field, True)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        assert set(a) == set(b), field
        for k in b:
            err = float(np.linalg.norm(a[k] - b[k]))
            ref = float(np.linalg.norm(b[k]))
            assert err <= 1e-5 * ref + 1e-12, (field, k, err, ref)
