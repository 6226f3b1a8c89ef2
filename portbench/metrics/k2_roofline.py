"""k2_roofline.train / .render: the least time of K2's launches for their
rows (flops.k2_bound_s) over the device time of sdf_split_kernel, in percent."""
from portbench.metrics._common import roofline


def read(reading, suffix):
    return roofline(reading, suffix, "k2", "sdf_split_kernel")
