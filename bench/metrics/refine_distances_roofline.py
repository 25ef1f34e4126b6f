"""Share of its roofline that ``refine_distances`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "refine_distances"
# The __global__ kernels of csrc/refine_distances.cu.
KERNELS = (
    "refine_mark_kernel",
    "refine_plan_kernel",
    "refine_place_kernel",
    "refine_compute_kernel",
)


def read(record):
    return roofline_pct(record, OP)
