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
The sharded (halo) GCN inference and training run over `torch.distributed`
(`dist`, `launch.distributed_gcn`). DeepFM (`models.deepfm`, with
`recsys.embedding`, `nn.layers` and the click stream of `train.data`)
serves (`launch.serve`), retrieves and trains (`launch.train`) with its FM
term in a hand-written CUDA kernel (`kernels/csrc/fm_interaction.cu`). The
LMs (`models.transformer_lm`, `nn.attention`, `nn.moe`; gemma3-12b,
stablelm-12b, granite-34b and the MoE LMs olmoe-1b-7b and
moonshot-v1-16b-a3b) serve: prefill with the causal / sliding-window
attention in a hand-written CUDA kernel (`kernels/csrc/flash_attention.cu`),
KV-cache decode and continuous batching (`serve.scheduler`), driven by
`launch.serve` and the `launch.serve_lm` twin of `examples/serve_lm.py`;
and train (`lm_loss`, `launch.train`) with that kernel in the forward and
its gradient in torch ops (`kernels.flash_attention.flash_attention_vjp`).

Entry points that create tensors take ``device=None``, which means the CUDA
card and raises when there is none (`repro_torch.device.resolve_device`);
pass ``device="cpu"`` to run on the host. Functions that take tensors follow
their inputs' device.
"""

__version__ = "0.1.0"
