"""repro_torch — the PyTorch/CUDA port of `repro`, for NVIDIA Hopper (H100).

The package mirrors the layout of the JAX package so each module has a
findable twin (`repro_torch.graph.structure` ↔ `repro.graph.structure`, …),
and it imports neither JAX nor `repro`. Importing it installs nothing.

Ported so far: full-graph GCN inference (`models.gcn.gcn_forward` with the
segment, bsr and dense backends) and its host data path; the bsr backend
runs the fused GCN layer as hand-written CUDA kernels
(`kernels/csrc/fused_gcn.cu`).

Entry points that create tensors take ``device=None``, which means the CUDA
card and raises when there is none (`repro_torch.device.resolve_device`);
pass ``device="cpu"`` to run on the host. Functions that take tensors follow
their inputs' device.
"""

__version__ = "0.1.0"
