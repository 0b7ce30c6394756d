"""ucd_torch.engine.metrics vs ucd_tpu.engine.metrics: the confusion-matrix
update and the result computation are exact integer / f64 host arithmetic
on both sides, so they are compared for equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucd_torch.engine import metrics as TM
from ucd_tpu.engine import metrics as JM


def _case(seed, n, shape):
    rs = np.random.RandomState(seed)
    lab = rs.randint(0, n, shape)
    lab[rs.rand(*shape) < 0.1] = 255
    return lab.astype(np.int32), rs.randint(0, n, shape).astype(np.int32)


@pytest.mark.parametrize("n,shape,label_dtype", [
    (17, (2, 32, 32), torch.uint8), (21, (3, 17, 23), torch.int32),
    (151, (2, 40, 40), torch.int64)])
def test_confusion_update_matches_jax_exactly(n, shape, label_dtype):
    hist_t = TM.empty_confusion(n, "cpu")
    hist_j = JM.empty_confusion(n)
    for seed in (0, 1):
        lab, pred = _case(seed, n, shape)
        hist_t = TM.confusion_matrix_update(
            hist_t, torch.from_numpy(lab).to(label_dtype),
            torch.from_numpy(pred), n)
        hist_j = JM.confusion_matrix_update(hist_j, jnp.asarray(lab),
                                            jnp.asarray(pred), n)
    assert hist_t.dtype == torch.int64
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    assert int(hist_t.sum()) == sum(
        int((_case(s, n, shape)[0] != 255).sum()) for s in (0, 1))


def test_results_from_confusion_match_jax_exactly():
    lab, pred = _case(3, 6, (2, 24, 24))
    lab[lab == 4] = 0  # class 4 absent: the "X" placeholder
    hist = TM.confusion_matrix_update(TM.empty_confusion(6, "cpu"),
                                      torch.from_numpy(lab),
                                      torch.from_numpy(pred), 6)
    got = TM.results_from_confusion(hist, total_samples=2)
    want = JM.results_from_confusion(hist.numpy(), total_samples=2)
    assert got == want
    assert got["Class IoU"][4] == "X"
    assert TM.results_to_str(got) == JM.results_to_str(want)
    empty = np.zeros((3, 3))
    assert TM.results_from_confusion(empty) == \
        JM.results_from_confusion(empty)


def test_average_meter_matches():
    t, j = TM.AverageMeter(), JM.AverageMeter()
    for m in (t, j):
        for v in (1.0, 2.5, 4.0):
            m.update("loss", v)
        m.update("lkd", 3.0)
        m.reset("lkd")
        m.update("lkd", 5.0)
    assert t.get_results("loss") == j.get_results("loss") == 2.5
    assert t.get_results("lkd") == j.get_results("lkd") == 5.0
    t.reset_all()
    assert t.book == {}
