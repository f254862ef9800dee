"""The k-rank group launcher (`repro_torch.launch.mesh`) and the command
line of sharded training (`repro_torch.launch.distributed_gcn`): one small
group whose rank fails on purpose, one whose rank never joins a
collective, the refusals that need no group, and
three training steps of the command on 4 CPU ranks (tests/test_torch_halo.py
and tests/test_torch_halo_train.py hold the forward and the gradients
against the reference)."""
import multiprocessing
import time

import pytest

import _torch_halo_ranks
from repro_torch.launch import distributed_gcn
from repro_torch.launch.mesh import GroupSpec, run_group


def test_group_reports_a_failing_rank():
    """A rank that raises ends the whole group: run_group raises with the
    rank's traceback, and no process is left behind."""
    spec = GroupSpec(k=2, backend="gloo", devices=("cpu",), timeout_s=120)
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*planned failure on rank 1"):
        run_group(spec, _torch_halo_ranks.fail_on_rank, [1, 1])
    assert not multiprocessing.active_children()


def test_group_timeout_ends_a_hung_group():
    """A rank that never joins its group's collective (as one that built its
    subgroups in another order than the others, which gloo does not detect)
    ends the group with an error inside the launcher's timeout, not a hang,
    and no process is left behind."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish|failed"):
        run_group(GroupSpec(k=2, backend="gloo", devices=("cpu",), timeout_s=5), _torch_halo_ranks.hang_on_rank,
                  [0, 0])
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_group_spec_and_arguments_are_checked():
    spec = GroupSpec(k=2, backend="gloo", devices=("cpu",), timeout_s=120)
    with pytest.raises(ValueError, match="one argument per rank"):
        run_group(spec, _torch_halo_ranks.fail_on_rank, [1])
    with pytest.raises(ValueError, match="nccl takes one rank per card"):
        GroupSpec(k=2, backend="nccl", devices=("cuda:0",))
    with pytest.raises(ValueError, match="devices names 3 devices for 2 ranks"):
        GroupSpec(k=2, devices=("cpu",) * 3)
    with pytest.raises(ValueError, match="at least one rank"):
        GroupSpec(k=0)
    assert spec.describe() == ("k=2 backend=gloo devices=cpu×2 start=spawn rendezvous=file "
                               "threads/rank=1")
    assert GroupSpec(k=2, devices=("cuda:0", "cuda:1")).device_of(1) == "cuda:1"


def test_launcher_refuses_training_steps():
    """A negative step count is refused before anything is built."""
    with pytest.raises(ValueError, match="--steps must be ≥ 0"):
        distributed_gcn.main(["--steps", "-1", "--device", "cpu"])


def test_launcher_trains_and_prints_the_examples_lines(capfd, tmp_path):
    """``--steps 3`` on 4 CPU ranks prints the lines of
    examples/train_distributed_gcn.py (plan, resume, done, plan cache) and
    passes its two asserts (the loss falls; the plan cache saw a hit and a
    miss, both checked inside `main`); every rank ends on the same
    parameters and losses."""
    out = distributed_gcn.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    lines = capfd.readouterr().out.splitlines()     # rank 0 prints the resume line itself
    for start in ("graph: cora-reduced", "wire/device/layer: halo", "group: k=4 backend=gloo",
                  f"checkpoints → {tmp_path} (resumed=False, step=0)", "done: step=3 loss",
                  "plan cache: "):
        assert sum(line.startswith(start) for line in lines) == 1, (start, lines)
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    for run in out["ranks"][1:]:
        assert run["losses"] == out["ranks"][0]["losses"]
        for n, p in run["params"].items():
            assert (p == out["ranks"][0]["params"][n]).all()
