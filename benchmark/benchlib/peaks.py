"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
700 W power limit: the yardstick of every roofline share."""

HBM_BYTES_PER_S = 3.35e12  # device memory rate
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take for this work: the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
