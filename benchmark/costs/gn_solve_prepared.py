"""K2 entry B, mapping's Gauss-Newton solve over prepared factors (the
program's csrc/gn_odometry.cu), costed from one launch's arguments.

Bytes a problem: each corner factor (three points and a valid byte), each
surf factor (point, normal, offset and a valid byte), the pose in and out.
Operations: the iterations' work depends on how many factors are valid,
which the shapes do not say, so none are counted and the bound is the
bytes' (it can only read low)."""

KERNELS = ("prepared_solve_kernel",)
OP = "scaloam::gn_solve_prepared"


def cost(args):
    P, Nc = args[2].shape[0], args[2].shape[1]
    Ns = args[6].shape[1]
    return P * (Nc * (9 * 4 + 1) + Ns * (7 * 4 + 1) + 2 * 7 * 4), 0
