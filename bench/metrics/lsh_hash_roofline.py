"""Share of its roofline that ``lsh_hash`` reaches: the least time of
its launches at the card's peaks (``bench.work``) over the device time of
all its kernels in the traced slice, in %."""
from bench.record import roofline_pct

OP = "lsh_hash"
# The __global__ kernels of csrc/lsh_hash.cu.
KERNELS = (
    "lsh_kernel",
)


def read(record):
    return roofline_pct(record, OP)
