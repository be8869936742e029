"""Device microseconds of the G.729A decode kernels a frame decoded in
the window (one stream a launch, so G's serial chain over frames)."""

from portbench.trace import kernel_s


def read(view, work):
    g = kernel_s(view, "g729_decode")
    if g <= 0 or not work["frames"]:
        return None
    return 1e6 * g / work["frames"]
