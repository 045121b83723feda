"""K1, the greedy curvature feature selection (the program's
csrc/selection.cu), costed from one launch's arguments.

Bytes: the curvature, both extents, the eligibility mask and the labels
written, one row of each (4 + 4 + 4 + 1 + 1 bytes a point), the
subregion bounds read, and one pick (5 bytes) a subregion and a round
written. Operations: a flag test, the threshold and a max compare for
each point of a subregion in each round (3), counted over every point of
the rows, which the picks scan at most: the bytes bound the launch at the
program's shapes either way (see tests/test_costs.py)."""

KERNELS = ("select_kernel",)
OP = "scaloam::select_features"


def cost(args):
    curv, sp = args[0], args[4]
    n_rounds = args[7] + args[8]  # corner picks + flat picks a subregion
    rows_w = curv.numel()
    n_bytes = rows_w * (4 + 4 + 4 + 1 + 1) + 2 * sp.numel() * 4 + sp.numel() * n_rounds * 5
    return n_bytes, 3 * n_rounds * rows_w
