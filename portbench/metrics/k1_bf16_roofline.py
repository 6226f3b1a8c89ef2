"""k1_bf16_roofline.train / .render: the least time of K1 bf16's launches
for the rows each was given (flops.k1_bf16_bound_s), over the device time
of its kernel (sdf_tc_kernel), in percent."""
from portbench.metrics._common import roofline


def read(reading, suffix):
    return roofline(reading, suffix, "k1_bf16", "sdf_tc_kernel")
