"""Layer: hand kernels: front end. The least time (costs/) of the front
end's hand-kernel launches over their device time in the traced window;
moves scans_per_s."""

from benchlib import roofline


def read(run):
    return roofline.share(run, roofline.FRONT_KERNELS, roofline.FRONT_MODULES)
