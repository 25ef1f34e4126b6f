"""Device milliseconds a job of everything that is not one of the port's
own kernels: the torch operations of ``core/`` (LSH bucketing, segment
sums, ranking, selection) and the apps' glue, copies and sets included."""


def read(record):
    if record.jobs <= 0 or not record.trace.device:
        return None
    spent = sum(d.end - d.start for d in record.trace.device if d.op is None)
    return spent * 1e-3 / record.jobs
