"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates without
sparsity, from NVIDIA's data sheet.  They assume the card's full 700 W
power limit; each run prints the card's own limit beside its shares."""

FLOPS = {"float32": 67e12,    # FP32 outside the tensor cores (TF32 off)
         "tf32": 495e12,
         "bfloat16": 989e12,
         "float16": 989e12,
         "fp8": 1979e12}
INT8_OPS = 1979e12
BYTES_PER_S = 3.35e12          # HBM3
MEMORY_BYTES = 80e9
