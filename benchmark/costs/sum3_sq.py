"""Squared norms over a last axis of 3, rounded as the reference's
compiled reduction (the program's csrc/f32ops.cu), costed from one
launch's arguments: 12 bytes read and 4 written a vector, 5 operations."""

KERNELS = ("sum3_sq_kernel",)
OP = "scaloam::sum3_sq"


def cost(args):
    n = args[0].numel() // 3
    return n * 16, n * 5
