"""Share of its roofline that ``distance_topk`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "distance_topk"
# The __global__ kernels of csrc/distance_topk.cu.
KERNELS = (
    "distance_topk_small_kernel",
    "distance_topk_chunk_kernel",
    "distance_topk_merge_kernel",
)


def read(record):
    return roofline_pct(record, OP)
