"""Idle milliseconds a job of the card that end at a launch outside every
``job`` span of the program (the harness's inputs, LSH draws and
synchronise between jobs), with the slice's tail after its last device op
(``bench.stages``)."""
from bench import stages


def read(record):
    return stages.idle_ms(record, stages.BETWEEN)
