"""Host microseconds a frame served that `transcode_bytes` spent outside
every child span (its self time: the Python between the demux, the
serving stages and the mux, such as the per-frame slices of the escaped
buffer), over the frames issued (`serve.frames`), from the program's
spans."""

from portbench.program_spans import aligned


def read(view, work):
    al = aligned(view)
    if al is None or not al.counters.get("serve.frames"):
        return None
    glue = sum(al.self_s[r.id] for r in al.spans
               if r.name == "transcode_bytes")
    return 1e6 * glue / al.counters["serve.frames"]
