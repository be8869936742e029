"""Kernel G's share of its roofline (%): the larger of the G.729A
decoder's operations over the 32-bit peak and its bytes (frames in, PCM
out) over the HBM peak, for the frames the window decoded, divided by the
device time of the G.729A decode kernels."""

from portbench import roofline
from portbench.trace import kernel_s


def read(view, work):
    g = kernel_s(view, "g729_decode")
    if g <= 0:
        return None
    n = work["frames"]
    return 100.0 * roofline.bound_s(roofline.g729a_decode_ops(n),
                                    roofline.g729a_decode_bytes(n)) / g
