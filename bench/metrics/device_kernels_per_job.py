"""Device kernels a job: every kernel the profiler saw in the traced
slice, the port's and torch's, over its jobs (the host's dispatch)."""


def read(record):
    kernels = record.trace.kernels()
    if record.jobs <= 0 or not kernels:
        return None
    return len(kernels) / record.jobs
