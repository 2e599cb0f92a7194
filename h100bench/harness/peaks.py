"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit; a run reports the card's own limit beside them)."""
BF16_FLOPS_PER_S = 989e12     # tensor cores, bf16 / fp16 dense
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
