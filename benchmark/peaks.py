"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).  A roofline share is stated against them, with
the card's power limit beside it."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
