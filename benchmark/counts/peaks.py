"""The peaks every roofline and ``mfu`` share of the benchmark is taken
against: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's published dense figures at
the card's full power limit of 700 W. Frozen: they read the same work whatever
implements it.

- Memory: 3.35 TB/s.
- Float32 operations: 165 TFLOP/s. The published dense TF32 tensor-core rate
  is 495 TFLOP/s; a float32-accurate product on tensor cores takes three TF32
  passes (the split of each float32 operand into a high and a low TF32 part,
  hi*hi + hi*lo + lo*hi, the form ``csrc/sa.cu`` already computes), so 495 / 3
  is the fastest float32-accurate rate the published figures support. The
  CUDA-core float32 rate, 67 TFLOP/s, is not a bound: a tensor-core kernel can
  run above it, and a share against it could pass 100%. One TF32 pass alone is
  a lower precision, which the comparison that decides ``correct`` refuses.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 495e12 / 3


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a piece of work: bytes over the memory peak or
    operations over the float32 peak, the larger."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)
