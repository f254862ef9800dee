"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(`harness.run_cell`) on the CPU at a small graph, with one fault planted in
the program: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced. (The cells run on one
chip, so no exchange between chips can be left out.) A sound run of the
same cell comes out correct.
"""
from __future__ import annotations

import time

import pytest
import torch
from conftest import WORKLOADS, tiny_cell

from benchlib import harness

CPU = torch.device("cpu")


def run(workload: str, seed: int = 20260101) -> dict:
    return harness.run_cell(tiny_cell(workload), seed, 0.3, False, CPU, time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


# ------------------------------------------------------------------ infer
def _refresh_not_taken(self, ids, rows):
    from repro_torch.models.gcn import gcn_forward

    self.layer_outputs.clear()
    g = self.graph
    logits = gcn_forward(self.params, self.x, g.senders, g.receivers, g.edge_weight, self.cfg,
                         adjacency=self.adjacency)
    return logits.argmax(dim=1)[self.pos].cpu()


def _half_the_refresh(self, ids, rows):
    half = ids.shape[0] // 2
    return _original_request(self, ids[:half], rows[:half])


def _classes_shifted(self, ids, rows):
    classes = _original_request(self, ids, rows)
    return (classes + 1) % self.cfg.layer_dims[-1]


from families.gcn.program import GcnProgram  # noqa: E402

_original_request = GcnProgram.request


@pytest.mark.parametrize("workload", ["nell_q4.infer", "nell_fp32.infer"])
@pytest.mark.parametrize("fault", [_refresh_not_taken, _half_the_refresh, _classes_shifted],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_infer_fault_is_caught(monkeypatch, workload, fault):
    monkeypatch.setattr(GcnProgram, "request", fault)
    assert not run(workload)["correct"]


@pytest.mark.parametrize("workload", ["nell_q4.infer", "nell_fp32.infer"])
def test_altered_logit_is_caught(monkeypatch, workload):
    import repro_torch.models.gcn as gcn

    inner = gcn.fused_gcn_layer

    def altered(vals, cols, lens, x, w, b, order="feature_first", relu=True):
        out = inner(vals, cols, lens, x, w, b, order=order, relu=relu)
        if not relu:                      # the last layer: one node's logit moved
            out[3, 0] += 0.01 * float(out.abs().max())
        return out

    monkeypatch.setattr(gcn, "fused_gcn_layer", altered)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > result["checks"]["logit_gap"]["limit"]


# ------------------------------------------------------------------ train
@pytest.mark.parametrize("workload", ["nell_q4.train", "nell_fp32.train"])
def test_state_unchanged_is_caught(monkeypatch, workload):
    import repro_torch.train.optimizer as optimizer

    inner = optimizer._adam_leafwise

    def unchanged(grads, state, params, *args, **kwargs):
        _, new_state = inner(grads, state, params, *args, **kwargs)
        return params, new_state

    monkeypatch.setattr(optimizer, "_adam_leafwise", unchanged)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["nell_q4.train", "nell_fp32.train"])
def test_half_batch_is_caught(monkeypatch, workload):
    init = GcnProgram.__init__

    def halved(self, *args, **kwargs):
        init(self, *args, **kwargs)
        kept = self.mask.nonzero()[:, 0]
        self.mask[kept[::2]] = 0.0

    monkeypatch.setattr(GcnProgram, "__init__", halved)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("workload", ["nell_q4.train", "nell_fp32.train"])
def test_hidden_layer_altered_after_the_first_step_is_caught(monkeypatch, workload):
    import repro_torch.models.gcn as gcn

    inner = gcn.fused_gcn_layer
    hidden_calls = []

    def altered(vals, cols, lens, x, w, b, order="feature_first", relu=True):
        out = inner(vals, cols, lens, x, w, b, order=order, relu=relu)
        if relu:
            hidden_calls.append(1)
            if len(hidden_calls) == 2:    # the second checked step's hidden layer
                out = out * 1.01
        return out

    monkeypatch.setattr(gcn, "fused_gcn_layer", altered)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["hidden_gap"]["value"] > result["checks"]["hidden_gap"]["limit"]


@pytest.mark.parametrize("workload", ["nell_q4.train", "nell_fp32.train"])
def test_altered_gradient_is_caught(monkeypatch, workload):
    import repro_torch.train.loop as loop

    inner = loop.value_and_grad

    def altered(loss_fn, params, batch):
        loss, grads = inner(loss_fn, params, batch)
        grads["w1"] = grads["w1"] * 1.01
        return loss, grads

    monkeypatch.setattr(loop, "value_and_grad", altered)
    result = run(workload)
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] > result["checks"]["grad_gap"]["limit"]
