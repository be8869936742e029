"""Structural AMV comparison, compare_amv.c reimplemented: the port's copy
of `amv_tpu/verify/compare.py` (`--compare`).

Walks two AMV files chunk-by-chunk from the fixed movi offset, comparing
chunk ids, lengths and per-audio-chunk sample counts
(AMVmuxer/compare_amv.c:29-96).  Returns a list of mismatch descriptions
(empty == structurally identical).
"""

from __future__ import annotations

import struct

MOVI = 0x138


def compare_amv(a: bytes, b: bytes) -> list[str]:
    issues = []
    for name, d in (("A", a), ("B", b)):
        if d[MOVI:MOVI + 4] != b"movi":
            return [f"{name}: wrong header size (movi not at 0x138)"]
    pa = pb = MOVI + 4
    idx = 0
    while True:
        ta, tb = a[pa:pa + 4], b[pb:pb + 4]
        enda = ta[:4] == b"AMV_" or len(ta) < 4
        endb = tb[:4] == b"AMV_" or len(tb) < 4
        if enda or endb:
            if enda != endb:
                issues.append(f"chunk {idx}: EOF mismatch (A={enda}, B={endb})")
            break
        if ta != tb:
            issues.append(f"chunk {idx}: id mismatch {ta!r} vs {tb!r}")
            break
        if ta not in (b"00dc", b"01wb"):
            issues.append(f"chunk {idx}: bad id {ta!r}")
            break
        la = struct.unpack_from("<I", a, pa + 4)[0]
        lb = struct.unpack_from("<I", b, pb + 4)[0]
        if la != lb:
            issues.append(f"chunk {idx} ({ta.decode()}): len 0x{la:X} vs 0x{lb:X}")
        if ta == b"01wb" and la >= 8 and lb >= 8:
            sa = struct.unpack_from("<I", a, pa + 12)[0]
            sb = struct.unpack_from("<I", b, pb + 12)[0]
            if sa != sb:
                issues.append(f"chunk {idx}: sample count {sa} vs {sb}")
        pa += 8 + la
        pb += 8 + lb
        idx += 1
    return issues
