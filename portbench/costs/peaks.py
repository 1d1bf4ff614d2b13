"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). The configurations state float32 with TF32
off, so the compute peak is the one outside the tensor cores."""

FP32_FLOPS = 67e12          # FLOP/s, float32, no tensor cores
HBM_BYTES = 3.35e12         # bytes/s
