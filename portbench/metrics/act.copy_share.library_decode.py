"""The share of the window (%) in which a copy between host and device
ran (the frames' upload, the PCM's copy back): the union of the trace's
memcpy intervals over the window."""

from portbench.trace import union_s


def read(view, work):
    if not view.copies:
        return None
    return 100.0 * union_s(view.copies) / view.window_s
