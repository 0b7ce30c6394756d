"""The port's train step on two gloo ranks against the JAX package's step
on the global batch for two more method families, as
tests/test_torch_dp_step.py does for UCD (same start, same bounds, one
image a rank at float64 with ResNet-18): MiB (the UCD preset without the
contrastive term) and LWF-MC (iCaRL's BCE criterion over all pixels and
the `l_icarl` term).
"""

import pytest

from test_torch_dp_step import check_method, x64  # noqa: F401 (fixture)
from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_mib_two_ranks_match_the_global_batch_step(free_tmp_path, x64):
    two, _ = check_method("MiB", free_tmp_path)
    assert two["metrics"]["l_con"] == 0 and two["metrics"]["lkd"] > 0


def test_lwf_mc_two_ranks_match_the_global_batch_step(free_tmp_path, x64):
    two, _ = check_method("LWF-MC", free_tmp_path)
    assert two["metrics"]["l_icarl"] > 0 and two["metrics"]["l_con"] == 0
