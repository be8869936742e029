"""Host microseconds of the native C passes a frame served: the C unescape
(`native.unescape`, in `serve.issue` on the main thread) and the C escape
(`native.escape`, in `serve.drain` on the worker), both threads summed,
over the frames issued (`serve.frames`), from the program's spans."""

from portbench.program_spans import aligned, seconds


def read(view, work):
    al = aligned(view)
    if al is None or not al.counters.get("serve.frames"):
        return None
    return 1e6 * seconds(al, "native.unescape", "native.escape") / \
        al.counters["serve.frames"]
