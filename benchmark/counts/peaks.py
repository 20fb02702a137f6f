"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit).  A kernel's roofline takes the peak of the kind of work
it does, whatever units a version of it runs on: the networks' products
take the tensor cores' float32-operand rate (TF32), the env step's scalar
math the float32 rate outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def least_seconds(ops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time the card could take: operations at the peak or
    bytes at the memory's rate, whichever is longer."""
    return max(ops / flops_per_s, nbytes / HBM_BYTES_PER_S)
