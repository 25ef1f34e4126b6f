"""Device milliseconds a job of the ops launched inside the program's
``map.refine`` stage span (``bench.stages``)."""
from bench import stages


def read(record):
    return stages.device_ms(record, "map.refine")
