"""The share (%) of the window in which the main thread of the served
transcode waited: for a drained batch to free its slot
(`serve.wait_slot`) or for a batch's bit counts (`serve.wait_count`),
from the program's spans."""

from portbench.program_spans import aligned


def read(view, work):
    al = aligned(view)
    if al is None:
        return None
    main = {r.thread for r in al.spans if r.name == "transcode_bytes"}
    if not main:
        return None
    wait = sum(r.b - r.a for r in al.spans if r.thread in main and
               r.name in ("serve.wait_slot", "serve.wait_count"))
    return 100.0 * wait / view.window_s
