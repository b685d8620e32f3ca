"""The device's idle share over the profiled window, in percent: 1 - the union
of the trace's kernel, memcpy and memset intervals over the window's length."""


def read(run):
    return run.idle_share()
