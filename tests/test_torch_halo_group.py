"""The k-rank group launcher (`repro_torch.launch.mesh`) and the sharded
forward's command line (`repro_torch.launch.distributed_gcn`), without the
forward itself (tests/test_torch_halo.py runs that): one small group whose
rank fails on purpose, and the refusals that need no group."""
import multiprocessing

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
    """Halo training is the next slice: the command says so before it builds
    anything."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md, port slice 4"):
        distributed_gcn.main(["--steps", "3", "--device", "cpu"])
