"""Idle milliseconds a job of the card that end at a launch inside the
program's ``map.refine`` stage span (``bench.stages``)."""
from bench import stages


def read(record):
    return stages.idle_ms(record, "map.refine")
