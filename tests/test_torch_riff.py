"""amv_tpu_torch.containers.riff's tables against the JAX package's
`amv_tpu.containers.riff`, the reference, on the CPU.

`walk` gives each stream's payload offsets and sizes into the file's
bytes (one C pass); `write` writes a file from such tables (one C pass).
Every case holds the tables to the reference's `demux` chunks, the
port's `demux` lists to the reference's, and the files that `write`
(video in one batch and in batches of two frames, each batch in a buffer
of its own) and `mux` make to the reference's `mux`, byte for byte, with
the chunks written counted under `riff.chunks`.  Tolerance: byte
equality.
"""

import dataclasses
import re
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from amv_tpu.containers import riff as ref_riff  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.containers import riff  # noqa: E402
from amv_tpu_torch.utils import profiling as prof  # noqa: E402

W, H, FPS, RATE = 48, 32, 16, 22050


def _payloads(rng, n, lo, hi):
    return [rng.integers(0, 256, int(rng.integers(lo, hi)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _file(nv, na, seed, lo=40, hi=400):
    """The reference muxer's file of nv video and na audio payloads."""
    rng = np.random.default_rng(seed)
    return ref_riff.mux(_payloads(rng, nv, lo, hi), _payloads(rng, na, 0, hi),
                        width=W, height=H, fps=FPS, sample_rate=RATE)


def _chunk_at(data, k):
    """The position of the movi's k-th chunk."""
    pos = riff.MOVI_OFFSET + 4
    for _ in range(k):
        pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
    return pos


def _retag(data, k, tag):
    pos = _chunk_at(data, k)
    return data[:pos] + tag + data[pos + 4:]


def _zero_sizes(data):
    """The size fields a device leaves at 0: RIFF, hdrl and movi LIST
    sizes and the frame count."""
    b = bytearray(data)
    for at in (4, 16, 0x30, riff.MOVI_OFFSET - 4):
        b[at:at + 4] = bytes(4)
    return bytes(b)


CASES = {
    "equal": lambda: _file(5, 5, 1),
    "more_video": lambda: _file(7, 3, 2),
    "more_audio": lambda: _file(3, 7, 3),
    "no_audio": lambda: _file(6, 0, 4),
    "no_frames": lambda: _file(0, 0, 5),
    # the last audio payload cut 5 bytes short, and no AMV_END_
    "cut_last": lambda: _file(4, 4, 6)[:-8 - 5],
    # "AMV_" where the sixth chunk's tag was: the walk stops there
    "early_end": lambda: _retag(_file(5, 5, 7), 5, b"AMV_"),
    "zeroed_header": lambda: _zero_sizes(_file(5, 4, 8)),
    # 41 + 40 chunks of at most 7 bytes, some empty: many chunks a
    # small file, each one its own table entry
    "tiny_chunks": lambda: _file(41, 40, 9, lo=0, hi=8),
}


def _asdict(info):
    return dataclasses.asdict(info)


@pytest.mark.parametrize("case", [*CASES, "unknown_tag"])
def test_walk_and_write_match_the_reference(case):
    if case == "unknown_tag":
        data = _retag(_file(5, 5, 10), 3, b"02xx")
        with pytest.raises(ValueError) as want:
            ref_riff.demux(data)
        with pytest.raises(ValueError) as got:
            riff.walk(data)
        assert str(got.value) == str(want.value)
        assert "b'02xx' at 0x" in str(got.value)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            riff.demux(data)
        return
    data = CASES[case]()
    ref = ref_riff.demux(data)
    nv, na = len(ref.video_chunks), len(ref.audio_chunks)

    info, v_off, v_size, a_off, a_size = riff.walk(data)
    assert _asdict(info) == _asdict(ref.info)
    for t in (v_off, v_size, a_off, a_size):
        assert t.dtype == np.int64
    assert [data[o:o + n] for o, n in zip(v_off, v_size)] == ref.video_chunks
    assert [data[o:o + n] for o, n in zip(a_off, a_size)] == ref.audio_chunks

    s = riff.demux(data)
    assert _asdict(s.info) == _asdict(ref.info)
    assert s.video_chunks == ref.video_chunks
    assert s.audio_chunks == ref.audio_chunks
    assert s.order == ref.order

    want = ref_riff.mux(ref.video_chunks, ref.audio_chunks, width=W,
                        height=H, fps=FPS, sample_rate=RATE)
    kw = {"width": W, "height": H, "fps": FPS, "sample_rate": RATE}
    audio = (data, a_off, a_size)
    whole = [(data, v_off, v_size)] if nv else []
    pairs = [native.tables(ref.video_chunks[i:i + 2])
             for i in range(0, nv, 2)]
    prof.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert riff.write(whole, audio, **kw) == want
            assert riff.write(pairs, audio, **kw) == want
            assert riff.mux(ref.video_chunks, ref.audio_chunks, **kw) == want
        assert prof.recorded()[1] == {"riff.chunks": 3 * (nv + na)}
    finally:
        prof.reset()
    assert riff.demux(want).video_chunks == ref.video_chunks


def test_write_refuses_a_table_outside_its_buffer():
    data = _file(3, 3, 11)
    _, v_off, v_size, a_off, a_size = riff.walk(data)
    kw = {"width": W, "height": H, "fps": FPS}
    with pytest.raises(ValueError, match="outside"):
        riff.write([(data, v_off, v_size + len(data))],
                   (data, a_off, a_size), **kw)
    with pytest.raises(ValueError, match="outside"):
        riff.write([(data, v_off, v_size)], (data, a_off - a_off[0] - 1,
                                             a_size), **kw)
