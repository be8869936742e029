"""The device's idle share of the window (%): 1 minus the union of its
kernel, copy and memset intervals over the window, from the trace."""

from portbench.trace import idle_pct


def read(view, work):
    return idle_pct(view)
