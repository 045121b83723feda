"""The 2-NN squared distances |q|^2 + |t|^2 - 2 q.t of a [Q, T] block,
rounded as the reference rounds them (the program's csrc/f32ops.cu),
costed from one launch's arguments.

Bytes: the points read once (12 each), the block written once (4 a pair).
Operations: per pair the dot's multiply and two fused multiply-adds (5),
the sum, the doubling and the difference; per point its squared norm (5)."""

KERNELS = ("sq_dist_kernel",)
OP = "scaloam::sq_dist"


def cost(args):
    B, Q, T = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    return B * ((Q + T) * 12 + Q * T * 4), B * (Q * T * 8 + (Q + T) * 5)
