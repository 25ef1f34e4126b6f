"""Device milliseconds a job of the ops launched inside the program's
``map.stage1`` stage span (``bench.stages``)."""
from bench import stages


def read(record):
    return stages.device_ms(record, "map.stage1")
