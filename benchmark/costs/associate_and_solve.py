"""K2 entry A, odometry's association and Gauss-Newton solve (the
program's csrc/gn_odometry.cu), costed from one launch's arguments.

Bytes a problem: each corner point with its two candidate pairs and mask
(15 floats and a byte), each surf point with its three candidate pairs
and mask (21 floats and a byte), the pose in and out, the two counts.
Operations: the association of every corner (55) and surf point (105) in
each outer pass. The Gauss-Newton iterations' operations depend on how
many factors are valid, which the launch's shapes do not say; they are
left out, so the bound can only read low (at the program's shapes the
bytes bound it: tests/test_costs.py)."""

KERNELS = ("assoc_solve_kernel",)
OP = "scaloam::associate_and_solve"
OPS_ASSOC = (55, 105)


def cost(args):
    P, Nc = args[0].shape[0], args[0].shape[1]
    Ns = args[4].shape[1]
    outer = args[11]
    n_bytes = P * (Nc * (15 * 4 + 1) + Ns * (21 * 4 + 1) + 2 * 7 * 4 + 8)
    return n_bytes, P * outer * (Nc * OPS_ASSOC[0] + Ns * OPS_ASSOC[1])
