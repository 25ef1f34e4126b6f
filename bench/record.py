"""What a per-layer metric's reader reads: the traced slice and the work
of its jobs.  A reader (``bench/metrics/<metric>.py``) defines
``read(record) -> float | None`` and returns None where it finds nothing
to read; a kernel's roofline reader also names its ``OP`` and the
``KERNELS`` (``__global__`` names) of its sources."""
from __future__ import annotations

import dataclasses

from bench import trace as trace_lib
from bench import work


@dataclasses.dataclass
class Record:
    trace: trace_lib.Trace
    jobs: int              # jobs in the traced slice
    launches: list         # (op, flops, bytes) of every launch they need
    job_flops: float       # operations a job needs (mean over the checked)
    job_s: float           # mean time of the window's jobs (host clock)


def roofline_pct(record: Record, op: str) -> float | None:
    """The least time of all the op's launches in the slice over the device
    time of all its kernels there, in %; None where it did not run."""
    spent = sum(d.end - d.start for d in record.trace.device
                if d.op == op) * 1e-6
    least = sum(work.least_s(f, b) for o, f, b in record.launches if o == op)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
