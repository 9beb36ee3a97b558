"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full power limit of 700 W.  Shares of these peaks are
stated with the card's own power limit beside them."""

BF16_FLOPS = 989e12      # tensor cores, bfloat16 and float16
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12      # bytes/s
HBM_CAPACITY = 80e9      # bytes
