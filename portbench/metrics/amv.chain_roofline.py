"""The transcode chain's share of its roofline (%): the chain's contract
bytes (each frame's unescaped scan read once, its re-encoded scan written
once) over the HBM peak, divided by the device time of every kernel the
window launched (so it holds whichever kernels a later change runs)."""

from portbench.roofline import bound_s
from portbench.trace import kernel_s


def read(view, work):
    busy = kernel_s(view)
    if busy <= 0:
        return None
    return 100.0 * bound_s(nbytes=work["chain_bytes"]) / busy
