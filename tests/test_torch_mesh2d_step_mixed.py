"""The 2 x 2 mesh step of tests/test_torch_mesh2d_step.py (UCD at VOC
15-5s step 1, ResNet-18, float64, four gloo ranks) at `min_size` 512,
where whole and sharded layers mix: only mod5's convs (512 outputs) and
the ASPP's `map_bn` (1024) are sharded. A block then takes a whole input
into sharded convs, the body's sharded output reaches the ASPP's whole
map convs, and their whole concatenation is split for `map_bn`. Held to
the JAX global-batch step and the port's one-process step under the same
bounds (a file of its own keeps each under a minute on one worker)."""

import pytest

from test_torch_mesh2d_step import check_mesh_step, x64  # noqa: F401
from torch_port_helpers import free_tmp_path  # noqa: F401 (fixture)
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_2x2_mesh_with_whole_and_sharded_layers(free_tmp_path, x64):
    ranks, like = check_mesh_step("UCD", 1, 512, free_tmp_path)
    sharded = set(ranks[0]["sharded"])
    want = {k for k, v in like.items() if v.ndim >= 1 and v.shape[0] >= 512}
    assert sharded == want
    assert "head.map_bn.bn.weight" in sharded
    assert "head.map_conv0.weight" not in sharded
    assert "body.mod5_block1.conv1.weight" in sharded
    assert "body.mod4_block2.conv2.weight" not in sharded
