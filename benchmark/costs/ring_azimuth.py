"""A scan's ring ids, validity and raw azimuths in one pass (the program's
csrc/ring_azimuth.cu), costed from one launch's arguments.

Bytes a point: its xyz read (12), its ring id (4), validity (1) and
azimuth (4) written. Operations a point: two atan2f (34 each), the fused
multiply-add and root and the ring formula (15)."""

KERNELS = ("ring_azimuth_kernel",)
OP = "scaloam::ring_azimuth"
OPS_POINT = 2 * 34 + 15


def cost(args):
    n = args[0].shape[0]
    return n * 21, n * OPS_POINT
