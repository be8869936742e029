"""Host microseconds of one ACT file's demux (`act.demux`, the program's
span), over the window's calls: the part of the harness's demux span that
is the container's, the rest being its stack of the frames."""

from portbench.program_spans import aligned


def read(view, work):
    al = aligned(view)
    if al is None:
        return None
    d = [r.b - r.a for r in al.spans if r.name == "act.demux"]
    return 1e6 * sum(d) / len(d) if d else None
