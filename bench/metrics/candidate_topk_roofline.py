"""Share of its roofline that ``candidate_topk`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "candidate_topk"
# The __global__ kernels of csrc/candidate_topk.cu.
KERNELS = (
    "candidate_topk_warp_kernel",
    "candidate_topk_block_kernel",
)


def read(record):
    return roofline_pct(record, OP)
