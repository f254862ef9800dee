"""Published peaks of the card the cells run on (NVIDIA H100 SXM data
sheet, dense rates, at its 700 W power limit). A card set to a lower power
limit reaches less; each run reports its limit beside its numbers."""

H100_SXM = dict(
    hbm_bytes_per_s=3.35e12,
    fp32_flop_per_s=67e12,       # outside the tensor cores
    tf32_flop_per_s=495e12,
    bf16_flop_per_s=989e12,
)
