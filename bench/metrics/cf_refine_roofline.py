"""Share of its roofline that ``cf_refine`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "cf_refine"
# The __global__ kernels of csrc/cf_refine.cu and cf_sparse.cuh.
KERNELS = (
    "cf_compact_kernel",
    "cf_refine_kernel",
)


def read(record):
    return roofline_pct(record, OP)
