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
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

from ..utils.profiling import span


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


def demux(data: bytes) -> AmvStreams:
    """Walk the movi chunk stream; returns raw per-chunk payloads.

    Mirrors avi_read_packet's chunk walk for AMV (avidec.c:600-700) and
    AmvReadNextFrame (AMVDec.c:150-238): '00dc' -> video, '01wb' -> audio,
    stop at "AMV_" or EOF.
    """
    with span("riff.demux"):
        info = parse_header(data)
        s = AmvStreams(info=info)
        pos = MOVI_OFFSET + 4
        n = len(data)
        while pos + 8 <= n:
            tag = data[pos:pos + 4]
            if tag[:4] == b"AMV_":
                break
            size = _u32(data, pos + 4)
            payload = data[pos + 8:pos + 8 + size]
            if tag == b"00dc":
                s.order.append((0, len(s.video_chunks)))
                s.video_chunks.append(payload)
            elif tag == b"01wb":
                s.order.append((1, len(s.audio_chunks)))
                s.audio_chunks.append(payload)
            else:
                raise ValueError(f"unexpected chunk tag {tag!r} at 0x{pos:x}")
            pos += 8 + size
        return s


def read(path: str) -> AmvStreams:
    with open(path, "rb") as f:
        return demux(f.read())


# ---------------------------------------------------------------------------
# Muxer — byte-for-byte reproduction of amvenc.c avi_write_header /
# avi_write_packet / avi_write_trailer output.
# ---------------------------------------------------------------------------

def mux(video_chunks, audio_chunks, *, width, height, fps, sample_rate=22050,
        audio_bit_rate=None, video_bit_rate=0, streamed=False) -> bytes:
    """Mux pre-encoded AMV video frames + ADPCM audio chunks into a .amv file.

    The chunks are sequences of bytes-like payloads: `bytes`, or
    memoryviews into one buffer, such as `native.escape_packed`'s frames,
    which are written from that buffer with no copy of their own.

    Interleaving follows amv_interleave_packet (amvenc.c:378-406): strict
    alternation starting with video (last_stream_index initialized to 1,
    amvenc.c:124).  Back-patching of sizes, frame counts and duration follows
    avi_write_counters / avi_write_trailer (amvenc.c:72-110, 327-344).
    """
    with span("riff.mux"):
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

        # --- RIFF / hdrl -----------------------------------------------------
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

        # --- video strl ------------------------------------------------------
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

        # --- audio strl ------------------------------------------------------
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

        # --- movi ------------------------------------------------------------
        movi_patch = start_tag(b"LIST")
        pb.write(b"movi")
        assert pb.tell() == MOVI_OFFSET + 4, \
            f"movi misplaced: 0x{pb.tell()-4:x}"

        # Strict V/A alternation starting with video; once one stream runs dry
        # the other is drained in order (amv_interleave_packet behavior on
        # flush).
        nv, na = len(video_chunks), len(audio_chunks)
        audio_bytes = 0
        vi = ai = 0
        last = 1  # so the first packet out is video
        while vi < nv or ai < na:
            take_video = (last == 1 and vi < nv) or ai >= na
            if take_video:
                pb.write(b"00dc")
                w32(len(video_chunks[vi]))
                pb.write(video_chunks[vi])
                vi += 1
                last = 0
            else:
                pb.write(b"01wb")
                w32(len(audio_chunks[ai]))
                pb.write(audio_chunks[ai])
                audio_bytes += len(audio_chunks[ai])
                ai += 1
                last = 1

        end_tag(movi_patch)
        pb.write(b"AMV_END_")
        end_tag(riff_patch)

        # --- back-patch counters (avi_write_counters, amvenc.c:72-110) -------
        end = pb.tell()
        pb.seek(patch_sites["video_len"]); w32(nv)
        pb.seek(patch_sites["audio_len"]); w32(audio_bytes // 2)
        pb.seek(patch_sites["nb_frames"]); w32(nv)
        dur = nv // fps
        pb.seek(patch_sites["seconds"]); w8(dur % 60)
        # NOTE: reference writes total/60 for minutes and total/3600 for hours
        # (amvenc.c:100-109) -- minutes is NOT %60.  Reproduced faithfully.
        pb.seek(patch_sites["minutes"]); w8(dur // 60)
        pb.seek(patch_sites["hours"]); w16(dur // 3600)
        pb.seek(end)
        return pb.getvalue()
