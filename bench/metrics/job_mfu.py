"""The job's share of the card's fp32 peak: the operations a job needs
(``bench.work``: LSH projections, aggregation, stage 1, refinement; CF by
rated and co-rated entries) over the window's mean job time times
67 TFLOP/s, in %."""
from bench import work


def read(record):
    if record.job_flops <= 0 or record.job_s <= 0:
        return None
    return 100.0 * record.job_flops / (record.job_s * work.PEAK_FP32)
