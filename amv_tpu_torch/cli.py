"""ffmpeg-shaped CLI of the PyTorch/CUDA port.

  python -m amv_tpu_torch -i in.amv -f amv out.amv              # transcode
  python -m amv_tpu_torch -i in.amv out.yuv                     # decode video
  python -m amv_tpu_torch -i in.amv out.wav                     # decode audio
  python -m amv_tpu_torch -i in.amv out.avi                     # to I420 AVI
  python -m amv_tpu_torch -i in.avi -f amv -r 16 -s 160x120 -ac 1 \\
      -ar 22050 out.amv                                         # encode AVI
  python -m amv_tpu_torch -i in.yuv -i in.wav -f amv -s 160x120 -r 16 \\
      -ar 22050 out.amv                                         # encode
  python -m amv_tpu_torch -i in.amv -f amv -s 96x72 -psnr out.amv
  python -m amv_tpu_torch -i cam_mjpg.avi -f amv -r 16 -s 160x120 -ac 1 \
      -ar 22050 -trellis out.amv                                # MJPG in
  python -m amv_tpu_torch -i in.amv -vcodec mjpeg out.avi       # MJPG out
  python -m amv_tpu_torch -i in.amv -vcodec copy out.avi        # AMV scans
  python -m amv_tpu_torch -i in.amv frames/f_%04d.jpg           # AMV scans
  python -m amv_tpu_torch -i in.amv -acodec copy out.wav        # raw ADPCM
  python -m amv_tpu_torch -i rec.act out.wav                    # G.729A
  python -m amv_tpu_torch -i rec.act out.bit                    # ITU serial
  python -m amv_tpu_torch -i in.wav -f act out.act              # G.729A enc
  python -m amv_tpu_torch -i in.amv -pix_fmt rgb565 out.raw     # kernel Y
  python -m amv_tpu_torch -i in.amv out.rgb                     # rgb24
  python -m amv_tpu_torch -i in.amv --color amvlib f_%04d.bmp   # BMP frames
  python -m amv_tpu_torch --info clip.amv                       # probe
  python -m amv_tpu_torch --compare good.amv bad.amv            # compare_amv
  python -m amv_tpu_torch -i in.amv --benchmark out.yuv         # utime line
  ... --device cpu                                              # plain versions

Every route runs on the GPU (`--device cuda`, the default) unless the
caller asks for the CPU; `-f act` runs the host encoder
(`codecs/g729a_encoder.py`, as the JAX package does) after the resampling
on the device.  The flags are `amv_tpu.cli`'s.  Every route runs under
`utils.profiling.trace("cli")` (a torch.profiler trace when AMV_TRACE_DIR
is set).  Still refused, naming the `amv_tpu` module it waits for:
progressive (SOF2) and lossless (SOF3) MJPEG input.
"""

from __future__ import annotations

import argparse
import os
import resource
import struct
import sys
import time

import numpy as np

_USE_JAX = "(use python -m amv_tpu)"
_SWS = ["bilinear", "bicubic", "point", "area", "lanczos", "gauss", "sinc",
        "spline", "experimental", "bicublin"]
_PIX_FMTS = ["rgb32", "bgr32", "rgb24", "bgr24", "rgb565", "bgr565",
             "rgb555", "bgr555", "rgb8", "bgr8", "rgb4", "bgr4", "rgb4_byte",
             "bgr4_byte", "monob", "yuyv422", "uyvy422"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="amv_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", dest="inputs", action="append", default=[],
                   help="input file (.amv, .avi, or .yuv and .wav to encode)")
    p.add_argument("-f", dest="format", default=None, help="force format (amv)")
    p.add_argument("-r", dest="fps", type=int, default=16, help="frame rate")
    p.add_argument("-s", dest="size", default=None,
                   help="WxH frame size (required for raw .yuv input; "
                        "rescales AVI and AMV input)")
    p.add_argument("-sws_flags", dest="sws_flags", default="bicubic",
                   choices=_SWS, help="rescale filter (libswscale's SWS_* "
                                      "set; default bicubic like ffmpeg)")
    p.add_argument("-ar", dest="sample_rate", type=int, default=22050,
                   help="audio rate (other input rates are resampled)")
    p.add_argument("-ac", dest="channels", type=int, default=1)
    p.add_argument("-qscale", dest="qscale", type=int, default=2)
    p.add_argument("-amv_quant", dest="amv_quant", choices=["ffmpeg", "q60"],
                   default="ffmpeg",
                   help="AMV encode quantizer: ffmpeg = the reference "
                        "encoder's (MPEG-1 matrix x qscale, bit-exact); q60 "
                        "= the decoder's own sp5x Q60 tables (>=30 dB round "
                        "trips)")
    p.add_argument("-vcodec", dest="vcodec", default="rawvideo",
                   choices=["rawvideo", "mjpeg", "copy"],
                   help="AVI output video codec: rawvideo (I420), mjpeg "
                        "(baseline JPEG frames with full headers) or copy "
                        "(the AMV scans under the canned JPEG header, "
                        "sp5xdec.c:50-88; bottom-up as stored)")
    p.add_argument("-acodec", dest="acodec", choices=["pcm", "copy"],
                   default="pcm",
                   help="WAV output codec: pcm (decode) or copy (the raw "
                        "IMA-ADPCM chunks with a fact header, "
                        "AMVDec.c:447-530)")
    p.add_argument("-pix_fmt", dest="pix_fmt", default=None,
                   choices=_PIX_FMTS,
                   help="packed pixel format of .rgb/.raw output (default "
                        "rgb24; libswscale's yuv2rgb family with its "
                        "ordered dithering, kernel Y)")
    p.add_argument("-trellis", dest="trellis", action="store_true",
                   help="Viterbi ADPCM quantizer (kernel L; lower audio "
                        "distortion)")
    p.add_argument("-psnr", dest="psnr", action="store_true",
                   help="after encoding, print the mean Y/U/V/All PSNR of "
                        "the output against the encoded planes")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("-t", dest="duration", type=float, default=None,
                   help="limit output duration in seconds (frames = t * "
                        "source fps)")
    p.add_argument("--seek", type=int, default=0,
                   help="start decoding at this frame index")
    p.add_argument("-y", dest="overwrite", action="store_true",
                   help="overwrite output (outputs are always overwritten)")
    p.add_argument("--compare", nargs=2, metavar=("GOOD", "BAD"),
                   help="structural diff of two AMV files (compare_amv)")
    p.add_argument("--info", metavar="FILE",
                   help="print stream info (ffprobe-style) and exit")
    p.add_argument("--color", choices=["bt601", "amvlib"], default="bt601",
                   help="YUV->RGB of .bmp output: full-range BT.601 or "
                        "amvlib's StoreBuffer constants")
    p.add_argument("--benchmark", action="store_true",
                   help="print utime, wall and maxrss after the operation "
                        "(ffmpeg -benchmark)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; a missing "
                        "card is an error, never a silent CPU run)")
    p.add_argument("output", nargs="?", help="output file")
    args = p.parse_args(argv)
    if args.channels != 1:
        raise SystemExit("-ac must be 1: AMV audio is mono "
                         "(IMA-ADPCM AMV, adpcm.c mono guard)")
    if args.info:
        return _info(args.info)
    if args.compare:
        from .verify.compare import compare_amv
        with open(args.compare[0], "rb") as fa, \
                open(args.compare[1], "rb") as fb:
            issues = compare_amv(fa.read(), fb.read())
        for msg in issues:
            print(msg)
        print("Check successfully finished" if not issues
              else f"{len(issues)} mismatches")
        return 1 if issues else 0
    if not args.inputs or not args.output:
        p.error("need -i input(s) and an output")

    src_ext = os.path.splitext(args.inputs[0])[1].lower()
    out_ext = os.path.splitext(args.output)[1].lower()
    if args.duration is not None and args.max_frames is None:
        fps = args.fps
        if src_ext == ".act":
            fps = 100                   # 10 ms G.729 frames
        elif src_ext == ".amv":
            from .containers import riff
            with open(args.inputs[0], "rb") as f:
                fps = riff.parse_header(f.read(0x140)).fps_num
        args.max_frames = max(1, int(args.duration * fps))

    from .utils.profiling import trace
    t0 = time.perf_counter()
    try:
        with trace("cli"):      # a torch.profiler trace under AMV_TRACE_DIR
            return _route(args, src_ext, out_ext)
    finally:
        if args.benchmark:
            ru = resource.getrusage(resource.RUSAGE_SELF)
            print(f"bench: utime={ru.ru_utime:.3f}s "
                  f"wall={time.perf_counter() - t0:.3f}s "
                  f"maxrss={ru.ru_maxrss // 1024}MB")


def _route(args, src_ext: str, out_ext: str) -> int:
    if src_ext == ".act":
        return _decode_act(args, out_ext)
    if args.format == "amv" or out_ext == ".amv":
        if len(args.inputs) == 1 and src_ext == ".amv" and not args.size \
                and not args.psnr:
            return _transcode(args)
        return _encode(args)
    if args.format == "act" or out_ext == ".act":
        return _encode_act(args)
    if args.format is not None or src_ext != ".amv":
        raise SystemExit(f"unsupported route {src_ext or 'raw'} -> "
                         f"{args.format or out_ext}")
    return _decode(args, out_ext)


def _transcode(args) -> int:
    """AMV -> AMV re-encode: the device chain D -> T -> E, or D -> U -> V ->
    E for -amv_quant q60 and odd sizes; audio passes through."""
    from .pipeline.transcode import transcode_bytes
    with open(args.inputs[0], "rb") as f:
        data = f.read()
    out = transcode_bytes(data, qscale=args.qscale or 2,
                          quant=args.amv_quant, device=args.device)
    with open(args.output, "wb") as f:
        f.write(out)
    mode = ("quant=q60" if args.amv_quant == "q60"
            else f"qscale={args.qscale or 2}")
    print(f"wrote {args.output}: {len(out)} bytes (requantized {mode}, "
          f"device {args.device})")
    return 0


def _decode_act(args, ext: str) -> int:
    """ACT -> the ITU serial format (.bit, no decode), or G.729A decoded
    by kernel G into a PCM WAV (any other extension, as in the JAX
    package): one stream, all its frames in one launch."""
    from .containers import act, wav
    src, out = args.inputs[0], args.output
    with open(src, "rb") as f:
        frames, rate, _ = act.demux(f.read())
    if args.max_frames:
        frames = frames[:args.max_frames]
    if ext == ".bit":
        with open(out, "wb") as f:
            f.write(act.to_itu_bitstream(frames))
        print(f"wrote {out}: {len(frames)} ITU serial frames")
        return 0
    from .codecs import g729a
    from .pipeline import resolve_device, upload
    dev = resolve_device(args.device)
    pcm = g729a.decode_streams(upload(frames[:, None], dev))[0]
    wav.write_pcm(out, pcm.cpu().numpy(), rate, 1)
    print(f"wrote {out}: {len(pcm)} samples @ {rate} Hz (G.729A, device "
          f"{args.device})")
    return 0


def _encode_act(args) -> int:
    """WAV -> G.729A -> .act (`amv_tpu/cli.py:_encode_act`): the mono mean
    as int16, resampled to 8 kHz on the device, then the host encoder
    (`codecs/g729a_encoder.py:encode_stream`, the "high" preset)."""
    from .codecs.g729a_encoder import encode_stream
    from .codecs.wav_audio import downmix
    from .containers import act, wav
    from .pipeline import resolve_device
    dev = resolve_device(args.device)
    pcm, rate = wav.read_pcm(args.inputs[0], device=dev)
    if pcm.dim() > 1:
        pcm = downmix(pcm)
    if rate != 8000:
        from .kernels.resample import resample_pcm
        print(f"resampling audio {rate} -> 8000 Hz")
        pcm = resample_pcm(pcm, rate, 8000, device=dev)
    if args.max_frames:
        pcm = pcm[:args.max_frames * 80]
    frames = encode_stream(pcm.cpu().numpy())
    data = act.mux(np.frombuffer(b"".join(frames), np.uint8)
                   .reshape(-1, 10), sample_rate=8000)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {args.output}: {len(frames)} G.729A frames, {len(data)} "
          f"bytes (device {args.device})")
    return 0


def _info(path: str) -> int:
    """Stream info of an .act, .avi or .amv file (`amv_tpu/cli.py:_info`,
    the same lines)."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".act":
        from .containers import act
        frames, rate, dur = act.demux(data)
        print(f"Input: ACT, G.729A mono {rate} Hz")
        print(f"  {len(frames)} frames ({len(frames) * 10} ms), "
              f"recorded duration {dur / 100:.2f} s")
        return 0
    if ext == ".avi":
        from .containers import avi
        for st in avi.demux(data):
            if st.kind == "video":
                print(f"Stream: video {st.codec!r} {st.width}x{st.height} "
                      f"{st.fps_num}/{st.fps_den} fps, {len(st.chunks)} "
                      "frames")
            else:
                print(f"Stream: audio fmt={st.codec!r} {st.sample_rate} Hz "
                      f"{st.channels}ch {st.bits}bit, {len(st.chunks)} "
                      "chunks")
        return 0
    from .containers import riff
    s = riff.demux(data)
    i = s.info
    n_samples = sum(2 * max(len(c) - 8, 0) for c in s.audio_chunks)
    print(f"Input: AMV, {i.width}x{i.height} @ {i.fps_num} fps, "
          f"duration {i.duration_sec} s")
    print(f"  Stream 0: video (AMV MJPEG-variant), {len(s.video_chunks)} "
          "frames")
    print(f"  Stream 1: audio (IMA-ADPCM AMV), mono {i.sample_rate} Hz, "
          f"{len(s.audio_chunks)} chunks, {n_samples} samples")
    return 0


def _write_bmp(path: str, rgb: np.ndarray):
    """One uint8 RGB frame [H, W, 3] as a 24-bit BMP: bottom-up BGR rows
    padded to 4 bytes (`amv_tpu/cli.py:_write_bmp`)."""
    h, w, _ = rgb.shape
    row = (w * 3 + 3) & ~3
    img = np.zeros((h, row), dtype=np.uint8)
    bgr = rgb[::-1, :, ::-1]  # bottom-up, BGR
    img[:, :w * 3] = bgr.reshape(h, w * 3)
    hdr = b"BM" + struct.pack("<IHHI", 54 + img.size, 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img.size, 2835,
                       2835, 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + img.tobytes())


def _export_jpeg(path: str, payload: bytes, width: int, height: int):
    """One AMV frame as a canonical JPEG (sp5xdec.c:50-88): the canned
    header, the stored scan, EOI.  The picture stays upside down, as
    stored (the AMV flip lives in the decoders)."""
    from .codecs.jpeg_tables import canned_jpeg_header
    with open(path, "wb") as f:
        f.write(canned_jpeg_header(width, height))
        f.write(payload[2:len(payload) - 2])
        f.write(b"\xFF\xD9")


def _pixels(args, ext: str) -> int:
    """AMV -> packed pixels (.rgb/.raw by -pix_fmt, rgb24 by default:
    kernel Y, or the YUYV/UYVY packing) or BMP frames (.bmp by --color:
    `kernels/color.py`; one file, or every frame when the name has %).
    Kernels D and U decode; the planes stay on the device and one copy
    brings the packed frames to the host."""
    import torch

    from .codecs.amv_video import decode_frames_device
    from .containers import riff
    from .kernels import yuv2rgb_dither as y2r
    from .pipeline import resolve_device
    dev = resolve_device(args.device)
    s = riff.read(args.inputs[0])
    w, h = s.info.width, s.info.height
    vchunks = s.video_chunks[args.seek:]
    if args.max_frames:
        vchunks = vchunks[:args.max_frames]
    if vchunks:
        y, cb, cr = decode_frames_device(vchunks, w, h, device=dev)
    else:
        y = torch.zeros((0, h, w), dtype=torch.uint8, device=dev)
        cb = torch.zeros((0, h // 2, w // 2), dtype=torch.uint8, device=dev)
        cr = cb
    out = args.output
    if ext == ".bmp":
        from .kernels.color import yuv420_to_rgb
        rgb = yuv420_to_rgb(y, cb, cr, mode=args.color)
        n = rgb.shape[0] if "%" in out else min(1, rgb.shape[0])
        frames = rgb[:n].cpu().numpy()
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        for i in range(n):
            _write_bmp(out % i if "%" in out else out, frames[i])
        print(f"wrote {rgb.shape[0] if '%' in out else 1} BMP frame(s)")
        return 0
    fmt = args.pix_fmt or "rgb24"
    if fmt == "yuyv422":
        frames = y2r.yuv420_to_yuyv422(y, cb, cr)
    elif fmt == "uyvy422":
        frames = y2r.yuv420_to_uyvy422(y, cb, cr)
    else:
        frames = y2r.yuv420_to_packed(
            y, cb, cr, fmt="monoblack" if fmt == "monob" else fmt)
    # uint16/uint32 formats come as int16/int32 bits: little-endian bytes
    host = frames.cpu().numpy()
    host = host.astype(host.dtype.newbyteorder("<"), copy=False)
    with open(out, "wb") as f:
        f.write(host.tobytes())
    print(f"wrote {out}: {frames.shape[0]} frames {w}x{h} {fmt}")
    return 0


def _decode(args, ext: str) -> int:
    """AMV -> PCM WAV (kernel A) or the raw ADPCM chunks (-acodec copy),
    raw yuv420p frames (kernels D, U), packed pixels or BMP frames
    (`_pixels`), an AVI of I420, MJPEG (kernels V, E) or copied AMV scans
    and PCM, or JPEG files of the stored scans."""
    from .containers import riff, wav
    from .pipeline.decode import decode_file
    if ext in (".rgb", ".raw", ".bmp"):
        return _pixels(args, ext)
    if ext not in (".wav", ".yuv", ".avi", ".jpg", ".jpeg"):
        raise SystemExit(f"unsupported output format: {ext}")
    src, out = args.inputs[0], args.output
    if ext == ".wav" and args.acodec == "copy":
        s = riff.read(src)
        chunks = s.audio_chunks[args.seek:]
        if args.max_frames:
            chunks = chunks[:args.max_frames]
        wav.write_adpcm_raw(out, chunks, s.info.sample_rate)
        print(f"wrote {out}: {len(chunks)} raw ADPCM chunks @ "
              f"{s.info.sample_rate} Hz (stream copy)")
        return 0
    if ext in (".jpg", ".jpeg"):
        s = riff.read(src)
        n = len(s.video_chunks[:args.max_frames] if args.max_frames
                else s.video_chunks)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        for i in range(n if "%" in out else min(n, 1)):
            _export_jpeg(out % i if "%" in out else out, s.video_chunks[i],
                         s.info.width, s.info.height)
        print(f"wrote {n if '%' in out else 1} JPEG frame(s)")
        return 0
    if ext == ".avi" and args.vcodec == "copy":
        from .codecs.jpeg_tables import canned_jpeg_header
        from .containers import avi
        s = riff.read(src)
        vchunks = s.video_chunks[args.seek:]
        if args.max_frames:
            vchunks = vchunks[:args.max_frames]
        hdr = canned_jpeg_header(s.info.width, s.info.height)
        chunks = [hdr + c[2:len(c) - 2] + b"\xFF\xD9" for c in vchunks]
        dec = decode_file(src, video=False, max_frames=args.max_frames,
                          start_frame=args.seek, device=args.device)
        geom = np.broadcast_to(np.uint8(0), (len(chunks), s.info.height,
                                             s.info.width))   # shape only
        with open(out, "wb") as fh:
            fh.write(avi.mux(geom, geom, geom, dec.pcm, fps=s.info.fps_num,
                             sample_rate=s.info.sample_rate,
                             video_chunks=chunks))
        print(f"wrote {out}: {len(chunks)} frames MJPG (stream copy) + PCM")
        return 0
    dec = decode_file(src, video=ext != ".wav", audio=ext != ".yuv",
                      max_frames=args.max_frames, start_frame=args.seek,
                      device=args.device)
    if ext == ".wav":
        wav.write_pcm(out, dec.pcm, dec.info.sample_rate, dec.info.channels)
        print(f"wrote {out}: {len(dec.pcm)} samples @ "
              f"{dec.info.sample_rate} Hz (device {args.device})")
        return 0
    f = dec.y.shape[0]
    if ext == ".avi":
        from .containers import avi
        chunks = None
        if args.vcodec == "mjpeg":
            from .codecs.mjpeg import encode_mjpeg_frames
            chunks = encode_mjpeg_frames(dec.y, dec.cb, dec.cr,
                                         qscale=args.qscale or 2,
                                         device=args.device)
        with open(out, "wb") as fh:
            fh.write(avi.mux(dec.y, dec.cb, dec.cr, dec.pcm,
                             fps=dec.info.fps_num,
                             sample_rate=dec.info.sample_rate,
                             video_chunks=chunks))
        print(f"wrote {out}: {f} frames {'MJPG' if chunks else 'I420'} + "
              f"PCM (device {args.device})")
        return 0
    planes = [p.reshape(f, -1) for p in (dec.y, dec.cb, dec.cr)]
    with open(out, "wb") as fh:
        fh.write(np.concatenate(planes, axis=1).tobytes())
    print(f"wrote {out}: {f} frames {dec.info.width}x"
          f"{dec.info.height} yuv420p (device {args.device})")
    return 0


def _read_yuv(path: str, w: int, h: int, max_frames):
    """Raw yuv420p frames -> (y, cb, cr) uint8 arrays."""
    raw = np.fromfile(path, np.uint8)
    fb = w * h * 3 // 2
    n = len(raw) // fb
    if max_frames:
        n = min(n, max_frames)
    frames = raw[:n * fb].reshape(n, fb)
    y = frames[:, :w * h].reshape(n, h, w)
    cb = frames[:, w * h:w * h * 5 // 4].reshape(n, h // 2, w // 2)
    cr = frames[:, w * h * 5 // 4:].reshape(n, h // 2, w // 2)
    return y, cb, cr


def _rescale(args, planes, src_wh, wh, dev):
    from .kernels.scale import resize_yuv420
    from .pipeline import upload
    print(f"rescaling {src_wh[0]}x{src_wh[1]} -> {wh[0]}x{wh[1]} "
          f"({args.sws_flags})")
    return resize_yuv420(*(upload(p, dev) for p in planes), wh[1], wh[0],
                         filt=args.sws_flags)


def _resample(pcm, rate: int, args, dev):
    from .kernels.resample import resample_pcm
    print(f"resampling audio {rate} -> {args.sample_rate} Hz")
    return resample_pcm(pcm, rate, args.sample_rate, device=dev)


def _encode(args) -> int:
    """AVI, raw .yuv (+ .wav) or AMV -> AMV (kernels V, E and Q): AVI video
    unpacked on the device, -s rescaling and -ar resampling there, AMV input
    through the full decode first."""
    from .containers import wav
    from .pipeline import resolve_device
    from .pipeline.encode import encode_to_file
    dev = resolve_device(args.device)
    wh = tuple(map(int, args.size.lower().split("x"))) if args.size else None
    src = {}
    for path in args.inputs:
        ext = os.path.splitext(path)[1].lower()
        src[ext if ext in (".wav", ".avi", ".amv") else ".yuv"] = path
    pcm = None
    if ".amv" in src:
        from .pipeline.decode import decode_file
        dec = decode_file(src[".amv"], max_frames=args.max_frames,
                          start_frame=args.seek, device=dev)
        y, cb, cr, pcm = dec.y, dec.cb, dec.cr, dec.pcm
        src_wh = (dec.info.width, dec.info.height)
        wh = wh or src_wh
        if src_wh != wh:
            y, cb, cr = _rescale(args, (y, cb, cr), src_wh, wh, dev)
        if dec.info.sample_rate != args.sample_rate and len(pcm):
            pcm = _resample(pcm, dec.info.sample_rate, args, dev)
    elif ".avi" in src:
        from .containers import avi
        streams = avi.read(src[".avi"])
        vst = next((st for st in streams if st.kind == "video"), None)
        ast = next((st for st in streams if st.kind == "audio"), None)
        if vst is None:
            raise SystemExit("AVI input has no video stream")
        if args.seek:
            # index-based seek: back up to the nearest keyframe
            start = avi.seek_frame(vst, args.seek)
            vst.chunks, vst.index = vst.chunks[start:], vst.index[start:]
        if args.max_frames:
            vst.chunks = vst.chunks[:args.max_frames]
        try:
            y, cb, cr = avi.extract_yuv420(vst, device=dev)
        except NotImplementedError as e:
            raise SystemExit(f"{e} {_USE_JAX}") from None
        src_wh = (vst.width, vst.height)
        if wh and src_wh != wh:
            y, cb, cr = _rescale(args, (y, cb, cr), src_wh, wh, dev)
        # only PCM audio is taken from an AVI, as in the JAX package
        if ast is not None and ast.codec == b"\x01\x00":
            pcm = avi.extract_pcm(ast, device=dev)
            rate = ast.sample_rate or args.sample_rate
            if rate != args.sample_rate:
                pcm = _resample(pcm, rate, args, dev)
    elif ".yuv" in src:
        if wh is None:
            raise SystemExit("raw YUV encode requires -s WxH")
        y, cb, cr = _read_yuv(src[".yuv"], wh[0], wh[1], args.max_frames)
    else:
        raise SystemExit("encode requires a raw .yuv or .avi input")
    if pcm is None and ".wav" in src:
        from .codecs.wav_audio import downmix
        pcm, rate = wav.read_pcm(src[".wav"], device=dev)
        if pcm.dim() > 1:
            pcm = downmix(pcm)
        if rate != args.sample_rate:
            pcm = _resample(pcm, rate, args, dev)
    n = y.shape[0]
    if pcm is None:
        pcm = np.zeros(n * args.sample_rate // args.fps, np.int16)
    size = encode_to_file(args.output, y, cb, cr, pcm, fps=args.fps,
                          sample_rate=args.sample_rate, qscale=args.qscale,
                          trellis=args.trellis, quant=args.amv_quant,
                          device=dev)
    print(f"wrote {args.output}: {size} bytes, {n} frames (device "
          f"{args.device})")
    if args.psnr:
        _print_psnr(args.output, (y, cb, cr), dev)
    return 0


def _print_psnr(path: str, planes, dev):
    """The mean Y/U/V/All PSNR of the file's decoded planes against the
    encoded ones (CODEC_FLAG_PSNR's summary, mpegvideo_enc.c)."""
    import torch

    from .pipeline.decode import decode_file
    dec = decode_file(path, audio=False, device=dev)
    want = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p
            for p in planes]
    sse = [float(np.sum((p.astype(np.int64) - q.astype(np.int64)) ** 2))
           for p, q in zip((dec.y, dec.cb, dec.cr), want)]
    cnt = [float(p.size) for p in want]

    def db(s, n):
        return 99.99 if s == 0 else min(
            99.99, 10 * np.log10(255.0 * 255.0 * n / s))

    print(f"PSNR Mean Y:{db(sse[0], cnt[0]):2.2f} "
          f"U:{db(sse[1], cnt[1]):2.2f} V:{db(sse[2], cnt[2]):2.2f} "
          f"All:{db(sum(sse), sum(cnt)):2.2f}")


if __name__ == "__main__":
    sys.exit(main())
