"""The port's data-parallel pieces (ucd_torch/parallel, the synchronized
BatchNorm of ucd_torch/models/layers.py) on gloo groups of CPU processes.

- `maybe_initialize`'s argument and environment handling against the JAX
  function's (ucd_tpu/parallel/distributed.py), which is called only where
  it returns or raises before initializing anything;
- `local_batch_size`, `make_mesh_multiprocess` and `shard_batch`, one
  process and two;
- the contrastive term's gather at two ranks: forward in rank order,
  backward this rank's slice times the world size (exact);
- the train-mode BatchNorm at two ranks against the plain one on the
  concatenated batch at float64: outputs, input gradient, the ranks'
  summed weight and bias gradients, the running mean and the biased
  running variance, rtol 1e-10 (atol 1e-12); also the ASPP pooling
  branch's 1x1 map at one image a rank, whose variance exists only over
  the global batch;
- a failed rendezvous raises; `import ucd_torch.parallel` pulls in no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_workers as W
from ucd_torch import parallel as P
from ucd_torch.models.layers import BatchNorm2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("UCD_TPU_COORDINATOR", "UCD_TPU_NUM_PROCESSES",
            "UCD_TPU_PROCESS_ID", "UCD_TPU_DISTRIBUTED", "RANK",
            "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _both(kw):
    """(port, JAX) outcome of maybe_initialize(**kw): the return value or
    the error's type and message."""
    from ucd_tpu.parallel import distributed as JD

    out = []
    for fn in (P.maybe_initialize, JD.maybe_initialize):
        try:
            out.append(("returned", fn(**kw)))
        except ValueError as e:
            out.append(("raised", str(e)))
    return out


@pytest.mark.parametrize("args,env", [
    ({}, {}),
    ({"coordinator": "localhost:1234", "num_processes": 1}, {}),
    ({"coordinator": "localhost:1234", "num_processes": 2}, {}),
    ({}, {"UCD_TPU_COORDINATOR": "localhost:1234",
          "UCD_TPU_NUM_PROCESSES": "2"}),
    ({"num_processes": 2, "process_id": 1}, {}),
], ids=["nothing", "one_process", "no_id", "no_id_from_env", "no_coord"])
def test_maybe_initialize_matches_jax_without_a_group(clean_env, args, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    port, jax_ = _both(args)
    assert port == jax_
    assert not P.is_distributed()
    if port[0] == "raised":
        assert "--process_id" in port[1]


def test_distributed_flag_needs_the_launcher_environment(clean_env):
    clean_env.setenv("RANK", "0")
    clean_env.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="WORLD_SIZE, MASTER_PORT are"):
        P.maybe_initialize(auto=True, device="cpu")
    clean_env.setenv("UCD_TPU_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        P.maybe_initialize(device="cpu")
    assert not P.is_distributed()


def test_failed_rendezvous_raises(tmp_path):
    """Process 0 of two waits for a partner that never comes: the
    rendezvous times out and raises; nothing falls back to one process."""
    code = (
        "import sys\n"
        "from ucd_torch import parallel as P\n"
        "try:\n"
        f"    P.maybe_initialize(coordinator='file://{tmp_path}/rdzv', "
        "num_processes=2, process_id=0, device='cpu', timeout_s=2)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
        "    sys.exit(3)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 3 and "raised" in res.stdout, (
        res.stdout, res.stderr[-2000:])


def test_batch_division_and_shards_in_one_process():
    assert P.local_batch_size(24) == 24
    assert P.local_batch_size(24, 2) == 12
    with pytest.raises(ValueError, match="divide evenly over 2"):
        P.local_batch_size(7, 2)
    assert P.make_mesh_multiprocess(5) == P.DataMesh(1, 0, P.DATA_AXIS)
    batch = {"image": np.arange(24).reshape(8, 3), "label": np.arange(8)}
    for rank in (0, 1, 2, 3):
        s = P.shard_batch(batch, rank, 4)
        np.testing.assert_array_equal(s["image"], batch["image"][2 * rank:
                                                                 2 * rank + 2])
        np.testing.assert_array_equal(s["label"], [2 * rank, 2 * rank + 1])
    # the shards in rank order are the global batch, as the JAX package
    # assembles a global array from its processes' rows
    np.testing.assert_array_equal(np.concatenate(
        [P.shard_batch(batch, r, 2)["image"] for r in (0, 1)]),
        batch["image"])
    assert P.shard_batch(batch)["image"] is not None  # one process: all rows
    np.testing.assert_array_equal(P.shard_batch(batch)["label"],
                                  batch["label"])


def test_indivisible_batch_raises_at_two_ranks(tmp_path):
    W.run_ranks(W.indivisible_worker, 2, tmp_path, str(tmp_path))
    for r in (0, 1):
        got = torch.load(tmp_path / f"indivisible{r}.pt")
        assert len(got["caught"]) == 3, got["caught"]
        assert all("over 2 processes" in m for m in got["caught"])
        assert got["mesh"] == (2, r, "data")
        assert got["shard"] == [2 * r, 2 * r + 1]


def test_gather_rows_forward_and_backward_at_two_ranks(tmp_path):
    W.run_ranks(W.gather_worker, 2, tmp_path, str(tmp_path))
    xs = [torch.arange(24, dtype=torch.float64).reshape(2, 3, 4) + 100 * r
          for r in (0, 1)]
    w = torch.linspace(-1, 1, 48, dtype=torch.float64).reshape(4, 3, 4)
    for r in (0, 1):
        got = torch.load(tmp_path / f"gather{r}.pt")
        assert torch.equal(got["y"], torch.cat(xs))
        # the adjoint of the gather: every rank's copy of the loss
        # contributes this rank's slice, world = 2 times
        assert torch.equal(got["grad"], 2 * w[2 * r:2 * r + 2])
        assert got["lab"].dtype == torch.uint8
        assert got["lab"][:, 0].tolist() == [7, 8]


@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (2, 6, 1, 1)],
                         ids=["maps", "aspp_pool_1x1_one_image_a_rank"])
def test_sync_batchnorm_matches_the_global_batch(tmp_path, shape):
    rs = np.random.RandomState(3)
    c = shape[1]
    x = torch.from_numpy(rs.randn(*shape) * 2.0 + 0.5)
    g = torch.from_numpy(rs.randn(*shape))
    ref = BatchNorm2d(c, eps=1e-5, momentum=0.1, dtype=torch.float64)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(rs.rand(c) + 0.5))
        ref.bias.copy_(torch.from_numpy(rs.randn(c)))
        ref.running_mean.copy_(torch.from_numpy(rs.randn(c) * 0.1))
        ref.running_var.copy_(torch.from_numpy(rs.rand(c) + 0.5))
    spec = {"x": x, "g": g, "state": {k: v.clone() for k, v in
                                      ref.state_dict().items()}}
    torch.save(spec, tmp_path / "spec.pt")

    xr = x.clone().requires_grad_(True)
    y = ref(xr)
    (y * g).sum().backward()
    W.run_ranks(W.batchnorm_worker, 2, tmp_path, str(tmp_path / "spec.pt"),
                str(tmp_path))
    n = shape[0] // 2
    got = [torch.load(tmp_path / f"bn{r}.pt") for r in (0, 1)]

    def close(a, b, what):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=what)

    for r, gr in enumerate(got):
        close(gr["y"], y.detach()[r * n:(r + 1) * n], "output")
        close(gr["dx"], xr.grad[r * n:(r + 1) * n], "input gradient")
        for k in ("running_mean", "running_var"):
            close(gr["state"][k], ref.state_dict()[k], k)
        assert int(gr["state"]["num_batches_tracked"]) == 1
        # the statistics moved: the biased global variance, not torch's
        # unbiased one
        assert not torch.equal(gr["state"]["running_var"],
                               spec["state"]["running_var"])
    # the step's gradient all-reduce sums (and halves) the ranks' own
    # weight and bias gradients
    close(got[0]["dw"] + got[1]["dw"], ref.weight.grad, "weight gradient")
    close(got[0]["db"] + got[1]["db"], ref.bias.grad, "bias gradient")
    if shape[2] == 1:
        # one value a channel on each rank: only the global batch has a
        # variance (a plain train-mode BatchNorm refuses such a batch)
        with pytest.raises(ValueError):
            BatchNorm2d(c, dtype=torch.float64)(x[:1])


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import ucd_torch, ucd_torch.parallel\n"
            "import ucd_torch.parallel.distributed, ucd_torch.parallel.mesh\n"
            "import ucd_torch.parallel.collectives\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ucd_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
