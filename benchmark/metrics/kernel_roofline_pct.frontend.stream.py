"""Layer: hand kernels: front end. As kernel_roofline_pct.frontend, in the
cells paced by one stream; moves scans_per_s.stream."""

from benchlib import roofline


def read(run):
    return roofline.share(run, roofline.FRONT_KERNELS, roofline.FRONT_MODULES)
