"""The control: the reference computed with TF32 products (the precision one
step below the configurations' fp32) put in the program's place comes out
not correct against each cell's limits, while the program comes out
correct; at a small graph on the CPU (TF32 is emulated by rounding each
product's operands, so it runs on any device)."""
from __future__ import annotations

import pytest
import torch
from conftest import WORKLOADS, tiny_cell

from benchlib import harness
from families.gcn import cell as gcn_cell
from families.gcn.reference import tf32_round

CPU = torch.device("cpu")


def readings(workload: str, seed: int, control: bool) -> dict:
    c = tiny_cell(workload)
    session = gcn_cell.Session(c.config, c.traffic, CPU, c.limits)
    run = session.start(seed)
    run.window(0.2)
    run.finish()
    session.close()
    return harness.judge(c.limits, run.readings(control=control))


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_control_fails_program_passes(workload, seed):
    ok, checks = readings(workload, seed, control=False)
    assert ok, checks
    ok, checks = readings(workload, seed, control=True)
    assert not ok, checks


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-11 + 2**-20, 1.0 + 2**-12, -(1.0 + 3 * 2**-11), 3.0e-5])
    r = tf32_round(x)
    assert r[0] == 1.0 + 2**-10          # a tie rounds away from zero
    assert r[1] == 1.0 + 2**-10
    assert r[2] == 1.0
    assert r[3] == -(1.0 + 2**-9)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
