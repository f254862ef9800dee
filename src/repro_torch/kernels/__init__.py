"""The kernels — the fused GCN layer (K2), the ragged block-sparse product
(K1), DeepFM's FM interaction (K3), the LM's flash attention (K4) and the
GCN's fake quantization (fake_quant.py, called by `core/quant.py`):
hand-written CUDA kernels (csrc/), their plain PyTorch versions, and the
public wrappers (ops.py; differentiable, except the forward-only K4).

`launch_counts` reads every wrapper's count of its kernels' launches in
this process (one dict, K1–K4 and fake quant), `reset_launch_counts`
zeroes them all."""


def launch_counts() -> dict:
    """{kernel name: launches} of K1, K2, K3, K4 and fake quant in this process."""
    from repro_torch.kernels import fake_quant, flash_attention, fm_interaction, fused_gcn

    return {**fused_gcn.LAUNCHES, **fm_interaction.LAUNCHES, **flash_attention.LAUNCHES, **fake_quant.LAUNCHES}


def reset_launch_counts() -> None:
    from repro_torch.kernels import fake_quant, flash_attention, fm_interaction, fused_gcn

    for mod in (fused_gcn, fm_interaction, flash_attention, fake_quant):
        mod.reset_launch_counts()
