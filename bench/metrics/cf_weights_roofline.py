"""Share of its roofline that ``cf_weights`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "cf_weights"
# The __global__ kernels of csrc/cf_weights.cu and cf_sparse.cuh.
KERNELS = (
    "cf_compact_kernel",
    "cf_col_count",
    "cf_col_scan",
    "cf_col_start",
    "cf_col_place",
    "cf_weights_kernel",
)


def read(record):
    return roofline_pct(record, OP)
