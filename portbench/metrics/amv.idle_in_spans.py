"""The share (%) of the device's idle time in the window (no kernel, copy
or memset running) during which a program span below `transcode_bytes`
was open on any thread, on the window's clock: how much of the card's
wait the program's named host stages account for."""

from portbench.program_spans import aligned, idle_share_in


def read(view, work):
    al = aligned(view)
    if al is None or not any(r.name == "transcode_bytes" for r in al.spans):
        return None
    return idle_share_in(view, [(r.a, r.b) for r in al.spans
                                if r.name != "transcode_bytes"])
