"""Share of its roofline that ``knn_distance`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "knn_distance"
# The __global__ kernels of csrc/knn_distance.cu.
KERNELS = (
    "knn_distance_kernel",
)


def read(record):
    return roofline_pct(record, OP)
