"""The frame's bytes, timed inside the program: the median device ms of the
window's `gui.to_bytes` spans (the quantisation on the card and the copy
to the host), the interval `readback_ms` times from outside."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "gui.to_bytes")
