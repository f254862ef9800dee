"""repro_torch — the PyTorch/CUDA port of `repro`, for NVIDIA Hopper (H100).

The package mirrors the layout of the JAX package so each module has a
findable twin (`repro_torch.graph.structure` ↔ `repro.graph.structure`, …),
and it imports neither JAX nor `repro`. Importing it installs nothing.

Ported so far: full-graph GCN inference and training (`models.gcn` with the
segment, bsr and dense backends, `train` with the optimizers, gradient
compression, checkpoints and `Trainer`, `launch.train` and the quickstart
twin `launch.quickstart`), the host data path and the analytic core
(energy model, CE-count solver, mesh NoC). The bsr backend runs the fused
GCN layer and the ragged block-sparse product as hand-written CUDA kernels
(`kernels/csrc/fused_gcn.cu`); their backward is the reference's custom VJP.

Entry points that create tensors take ``device=None``, which means the CUDA
card and raises when there is none (`repro_torch.device.resolve_device`);
pass ``device="cpu"`` to run on the host. Functions that take tensors follow
their inputs' device.
"""

__version__ = "0.1.0"
