"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates, at its 700 W power limit); a card set below that limit runs
slower, so every run records ``power.limit`` beside the shares."""

HBM_BYTES_S = 3.35e12  # HBM3 bandwidth
FP32_FLOPS = 67e12  # FP32 outside the tensor cores
FP64_FLOPS = 34e12  # FP64 outside the tensor cores
