"""Milliseconds of a `cli.main` call spent other than waiting for kernel
G's PCM: each call's span (argument parsing, the file read, the ACT
demux, the launch, the WAV write) less its `cli.copy_back` (the `.cpu()`
that waits for G), averaged over the window's calls."""

from portbench.program_spans import aligned


def read(view, work):
    al = aligned(view)
    if al is None:
        return None
    calls = {r.id: r.b - r.a for r in al.spans if r.name == "cli.main"}
    if not calls:
        return None
    for r in al.spans:
        if r.name == "cli.copy_back" and r.request in calls:
            calls[r.request] -= r.b - r.a
    return 1e3 * sum(calls.values()) / len(calls)
