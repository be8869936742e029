"""Host microseconds of the AMV container a frame served: the RIFF demux
and mux of each file (`riff.demux`, `riff.mux`) over the frames issued
(`serve.frames`), from the program's spans."""

from portbench.program_spans import aligned, seconds


def read(view, work):
    al = aligned(view)
    if al is None or not al.counters.get("serve.frames"):
        return None
    return 1e6 * seconds(al, "riff.demux", "riff.mux") / \
        al.counters["serve.frames"]
