"""Share of the traced slice in which the card runs nothing, in %: one
minus the union of its busy intervals over the slice's length."""


def read(record):
    if record.trace.window_s <= 0 or not record.trace.device:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)
