"""AMV container (RIFF 'AMV ') demuxer and muxer (the port's copy of
`amv_tpu/containers/riff.py`).

Pure host-side byte handling.  Layout facts come from three reference
sources, which agree structurally:

* the device sample file C-AMVDecoder/bin/AMV1.amv (movi LIST at 0x130,
  "movi" tag at 0x138, first '00dc' chunk at 0x13c),
* the reference muxer AMVmuxer/ffmpeg/libavformat/amvenc.c:116-344,
* the fixed-layout structs C-AMVDecoder/amvlib/AMVHeader.h:18-136.

Chunk stream: strictly interleaved '00dc' (video) / '01wb' (audio) chunks,
each "<4s<u32 size" + payload with NO 2-byte alignment padding
(amvenc.c:320-321), terminated by the literal tag "AMV_END_"
(amvenc.c:336).

The chunk stream is handled as tables: `walk` gives each stream's payload
offsets and sizes into the file's bytes (one C pass), and `write` writes
the file from such tables (one C pass, each output byte once), so the
served transcode makes no Python object per chunk.  `demux` and `mux`
keep their lists of payloads, made and joined at that edge.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..utils.profiling import count, span


MOVI_OFFSET = 0x138  # "movi" tag position (compare_amv.c:30-41)


@dataclass
class AmvInfo:
    width: int = 0
    height: int = 0
    fps_num: int = 16          # frames per second (amvh dwSpeed)
    fps_den: int = 1
    micro_sec_per_frame: int = 0
    total_frames: int = 0      # back-patched by the muxer; may be 0 in device files
    duration_sec: int = 0      # amvh dwTimeSec/Min/Hour combined
    sample_rate: int = 22050
    channels: int = 1
    audio_format: int = 1      # wFormatTag as stored (1 even though ADPCM)
    bits_per_sample: int = 16


@dataclass
class AmvStreams:
    info: AmvInfo
    video_chunks: list = field(default_factory=list)  # list[bytes] raw '00dc' payloads
    audio_chunks: list = field(default_factory=list)  # list[bytes] raw '01wb' payloads
    # interleave order as (stream, index) pairs for exact re-muxing
    order: list = field(default_factory=list)


def _u16(b, o):
    return struct.unpack_from("<H", b, o)[0]


def _u32(b, o):
    return struct.unpack_from("<I", b, o)[0]


def parse_header(data: bytes) -> AmvInfo:
    """Parse the fixed 0x138-byte AMV header.

    Validates the FOURCC skeleton the same way amvlib's AmvOpen does
    (AMVDec.c:15-129) but tolerates zeroed size fields (device files) and
    filled ones (reference muxer output).
    """
    if len(data) < MOVI_OFFSET + 4:
        raise ValueError("file too short for AMV header")
    if data[0:4] != b"RIFF" or data[8:12] != b"AMV ":
        raise ValueError("not an AMV file (RIFF/AMV signature missing)")
    if data[12:16] != b"LIST" or data[20:24] != b"hdrl":
        raise ValueError("missing hdrl LIST")
    if data[24:28] != b"amvh":
        raise ValueError("missing amvh header")
    if data[0x138:0x13C] != b"movi":
        raise ValueError("movi tag not at fixed offset 0x138")

    info = AmvInfo()
    info.micro_sec_per_frame = _u32(data, 0x20)
    # amvh "reserved" region doubles as avih fields in muxer output:
    # nb_frames lives at 0x30 (amvenc.c:156-157). Zero in device files.
    info.total_frames = _u32(data, 0x30)
    info.width = _u32(data, 0x40)
    info.height = _u32(data, 0x44)
    info.fps_num = _u32(data, 0x48)  # dwSpeed
    sec = data[0x54]
    minute = data[0x55]
    hour = _u16(data, 0x56)
    info.duration_sec = hour * 3600 + minute * 60 + sec
    # audio strf at 0x11C (AMVWaveFormatEx body)
    info.audio_format = _u16(data, 0x11C)
    info.channels = _u16(data, 0x11E)
    info.sample_rate = _u32(data, 0x120)
    info.bits_per_sample = _u16(data, 0x12A)
    return info


def walk(data):
    """The header and the movi chunk stream as tables: (AmvInfo, video
    offsets, video sizes, audio offsets, audio sizes), int64 arrays into
    data, payload i of a stream being data[off[i]:off[i] + size[i]].

    Mirrors avi_read_packet's chunk walk for AMV (avidec.c:600-700) and
    AmvReadNextFrame (AMVDec.c:150-238): '00dc' -> video, '01wb' -> audio,
    stop at "AMV_" or when fewer than 8 bytes remain; a payload that runs
    past the end is cut there; another tag raises ValueError.  The header
    is parsed in Python, the chunks walked in one C pass
    (`native.riff_walk`)."""
    with span("riff.demux"):
        info = parse_header(data)
        return (info, *native.riff_walk(data, MOVI_OFFSET + 4))


def demux(data: bytes) -> AmvStreams:
    """`walk`, with each payload sliced out of data and the chunks'
    interleave order as (stream, index) pairs."""
    info, v_off, v_size, a_off, a_size = walk(data)
    nv = len(v_off)
    order = np.argsort(np.concatenate([v_off, a_off]))
    return AmvStreams(
        info=info,
        video_chunks=[data[o:o + n] for o, n in zip(v_off.tolist(),
                                                    v_size.tolist())],
        audio_chunks=[data[o:o + n] for o, n in zip(a_off.tolist(),
                                                    a_size.tolist())],
        order=[(0, i) if i < nv else (1, i - nv) for i in order.tolist()])


def read(path: str) -> AmvStreams:
    with open(path, "rb") as f:
        return demux(f.read())


# ---------------------------------------------------------------------------
# Muxer — byte-for-byte reproduction of amvenc.c avi_write_header /
# avi_write_packet / avi_write_trailer output.
# ---------------------------------------------------------------------------

def mux(video_chunks, audio_chunks, **kw) -> bytes:
    """Mux pre-encoded AMV video frames + ADPCM audio chunks, sequences
    of bytes-like payloads (`bytes`, or memoryviews), into a .amv file:
    each list joined into one table (`native.tables`), then `write`."""
    return write([native.tables(video_chunks)], native.tables(audio_chunks),
                 **kw)


def write(video, audio, *, width, height, fps, sample_rate=22050,
          audio_bit_rate=None, video_bit_rate=0, streamed=False) -> bytes:
    """Write a .amv file from tables: video a list of (buf, offsets,
    sizes), one a batch of frames in stream order (such as
    `AsyncTranscoder.batches` yields), audio one (buf, offsets, sizes)
    table (such as `walk` gives into the input file).

    Interleaving follows amv_interleave_packet (amvenc.c:378-406): strict
    alternation starting with video (last_stream_index initialized to 1,
    amvenc.c:124).  The counters that avi_write_counters /
    avi_write_trailer back-patch (amvenc.c:72-110, 327-344) are known from
    the tables before any chunk is written, so the output is allocated
    once at its size and one C pass fills it (`native.riff_file`).
    """
    with span("riff.mux"):
        nv = sum(len(t[1]) for t in video)
        na = len(audio[1])
        audio_bytes = int(np.sum(audio[2]))
        movi_bytes = 8 * (nv + na) + audio_bytes + sum(
            int(np.sum(t[2])) for t in video)
        head = _header(nv, audio_bytes, movi_bytes, width=width,
                       height=height, fps=fps, sample_rate=sample_rate,
                       audio_bit_rate=audio_bit_rate,
                       video_bit_rate=video_bit_rate, streamed=streamed)
        out = native.riff_file(head, video, audio, b"AMV_END_")
        count("riff.chunks", nv + na)
        return out


def _header(nv, audio_bytes, movi_bytes, *, width, height, fps, sample_rate,
            audio_bit_rate, video_bit_rate, streamed) -> bytes:
    """The file's first MOVI_OFFSET + 4 bytes, for nv video chunks,
    audio_bytes of audio payload and movi_bytes of chunks (tags, sizes
    and payloads), followed by "AMV_END_"."""
    # AMV flags: TRUSTCKTYPE|HASINDEX|ISINTERLEAVED (amvenc.c:153-155,
    # values from libavformat/amv.h:26-37: HASINDEX=0x10,
    # ISINTERLEAVED=0x100, TRUSTCKTYPE=0x800).
    flags = 0x800 | 0x100 | (0 if streamed else 0x10)
    if audio_bit_rate is None:
        # ffmpeg CLI default audio bit rate is 64k (ffmpeg.c
        # audio_bit_rate); amvh stores (video+audio bitrate)/8
        # (amvenc.c:150).
        audio_bit_rate = 64000
    bitrate = video_bit_rate + audio_bit_rate

    pb = io.BytesIO()
    w32 = lambda v: pb.write(struct.pack("<I", v & 0xFFFFFFFF))
    w16 = lambda v: pb.write(struct.pack("<H", v & 0xFFFF))
    w8 = lambda v: pb.write(struct.pack("<B", v & 0xFF))

    patch_sites = {}

    def start_tag(name):
        pb.write(name)
        patch = pb.tell()
        w32(0)
        return patch

    def end_tag(patch):
        cur = pb.tell()
        pb.seek(patch)
        w32(cur - patch - 4)
        pb.seek(cur)

    # --- RIFF / hdrl ---------------------------------------------------------
    riff_patch = start_tag(b"RIFF")
    pb.write(b"AMV ")
    hdrl_patch = start_tag(b"LIST")
    pb.write(b"hdrl")

    pb.write(b"amvh")
    w32(14 * 4)
    w32(1_000_000 * 1 // fps)          # dwMicroSecPerFrame
    w32(bitrate // 8)
    w32(0)
    w32(flags)
    patch_sites["nb_frames"] = pb.tell()
    w32(0)                             # total frames (patched later)
    w32(0)                             # initial frame
    w32(2)                             # nb streams
    w32(1024 * 1024)                   # suggested buffer size
    w32(width)
    w32(height)
    w32(fps)                           # dwSpeed
    w32(1)
    w32(0)
    patch_sites["seconds"] = pb.tell()
    w8(0)
    patch_sites["minutes"] = pb.tell()
    w8(0)
    patch_sites["hours"] = pb.tell()
    w16(0)

    # --- video strl ---------------------------------------------------------
    strl_patch = start_tag(b"LIST")
    pb.write(b"strl")
    strh_patch = start_tag(b"strh")
    pb.write(b"vids")
    w32(0)      # codec_tag (AMV has no bmp tag -> 0)
    w32(0)      # flags
    w16(0)      # priority
    w16(0)      # language
    w32(0)      # initial frame
    w32(1)      # scale (time_base.num)
    w32(fps)    # rate
    w32(0)      # start
    patch_sites["video_len"] = pb.tell()
    w32(0)      # length (patched: packet count)
    w32(1024 * 1024)  # suggested buffer size
    w32(0xFFFFFFFF)   # quality = -1
    w32(0)      # sample size
    w32(0)
    w16(width)
    w16(height)
    end_tag(strh_patch)
    strf_patch = start_tag(b"strf")
    for _ in range(9):
        w32(0)
    end_tag(strf_patch)
    end_tag(strl_patch)

    # --- audio strl ---------------------------------------------------------
    strl_patch = start_tag(b"LIST")
    pb.write(b"strl")
    strh_patch = start_tag(b"strh")
    pb.write(b"auds")
    w32(1)
    w32(0)
    w16(0)
    w16(0)
    w32(0)
    w32(1)      # au_scale = video time_base.num (amvenc.c:202-207)
    w32(fps)    # au_byterate = video fps
    w32(0)      # start
    patch_sites["audio_len"] = pb.tell()
    w32(0)      # length (patched: audio bytes / au_ssize(=2))
    w32(2)      # sample size (au_ssize=2, amvenc.c:204)
    w32(0)
    w16(0)
    w16(0)
    end_tag(strh_patch)
    strf_patch = start_tag(b"strf")
    # put_wav_header (riff.c): tag 0x1, mono, rate, byterate,
    # blockalign, bps
    w16(1)
    w16(1)
    w32(sample_rate)
    w32(audio_bit_rate // 8)
    w16(2)      # block align = channels*16 >> 3
    w16(16)     # bits per sample
    w32(0)      # trailing le32 0 (amvenc.c:254)
    end_tag(strf_patch)
    end_tag(strl_patch)

    end_tag(hdrl_patch)

    # --- movi ----------------------------------------------------------------
    movi_patch = start_tag(b"LIST")
    pb.write(b"movi")
    assert pb.tell() == MOVI_OFFSET + 4, \
        f"movi misplaced: 0x{pb.tell()-4:x}"

    # --- the chunks and "AMV_END_" follow: the sizes that close them --------
    end = MOVI_OFFSET + 4 + movi_bytes
    pb.seek(movi_patch); w32(end - movi_patch - 4)
    pb.seek(riff_patch); w32(end + 8 - riff_patch - 4)

    # --- back-patch counters (avi_write_counters, amvenc.c:72-110) -----------
    pb.seek(patch_sites["video_len"]); w32(nv)
    pb.seek(patch_sites["audio_len"]); w32(audio_bytes // 2)
    pb.seek(patch_sites["nb_frames"]); w32(nv)
    dur = nv // fps
    pb.seek(patch_sites["seconds"]); w8(dur % 60)
    # NOTE: reference writes total/60 for minutes and total/3600 for hours
    # (amvenc.c:100-109) -- minutes is NOT %60.  Reproduced faithfully.
    pb.seek(patch_sites["minutes"]); w8(dur // 60)
    pb.seek(patch_sites["hours"]); w16(dur // 3600)
    return pb.getvalue()
