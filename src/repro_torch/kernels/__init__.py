"""The kernels — the fused GCN layer (K2), the ragged block-sparse product
(K1), DeepFM's FM interaction (K3) and the LM's flash attention (K4):
hand-written CUDA kernels (csrc/), their plain PyTorch versions, and the
public wrappers (ops.py; differentiable, except the forward-only K4).

`launch_counts` reads every wrapper's count of its kernel's launches in
this process (one dict, K1–K4), `reset_launch_counts` zeroes them all."""


def launch_counts() -> dict:
    """{kernel name: launches} of K1, K2, K3 and K4 in this process."""
    from repro_torch.kernels import flash_attention, fm_interaction, fused_gcn

    return {**fused_gcn.LAUNCHES, **fm_interaction.LAUNCHES, **flash_attention.LAUNCHES}


def reset_launch_counts() -> None:
    from repro_torch.kernels import flash_attention, fm_interaction, fused_gcn

    for mod in (fused_gcn, fm_interaction, flash_attention):
        mod.reset_launch_counts()
