"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). A card set below its limit runs slower under
load: results carry the card's power limit beside them."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores: the highest rate any of the port's policies reaches
