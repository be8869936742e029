"""ffmpeg-shaped CLI of the PyTorch/CUDA port.

  python -m amv_tpu_torch -i in.amv -f amv out.amv              # transcode
  python -m amv_tpu_torch -i in.amv out.yuv                     # decode video
  python -m amv_tpu_torch -i in.amv out.wav                     # decode audio
  python -m amv_tpu_torch -i in.yuv -i in.wav -f amv -s 160x120 -r 16 \\
      -ar 22050 out.amv                                         # encode
  ... --device cpu                                              # plain versions

Every route runs on the GPU (`--device cuda`, the default) unless the
caller asks for the CPU.  The flags are `amv_tpu.cli`'s for these routes;
every other route of that CLI (AVI/BMP/JPEG/RGB outputs, AVI input,
rescaling, audio resampling, -acodec copy, -trellis, -psnr, G.729A/ACT,
probes) is not yet ported and exits non-zero saying so.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_USE_JAX = "(use python -m amv_tpu)"


def _not_ported(what: str):
    raise SystemExit(f"{what} is not yet ported {_USE_JAX}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="amv_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", dest="inputs", action="append", default=[],
                   help="input file (.amv, or .yuv and .wav to encode)")
    p.add_argument("-f", dest="format", default=None, help="force format (amv)")
    p.add_argument("-r", dest="fps", type=int, default=16, help="frame rate")
    p.add_argument("-s", dest="size", default=None,
                   help="WxH frame size (required for raw .yuv input)")
    p.add_argument("-ar", dest="sample_rate", type=int, default=22050)
    p.add_argument("-ac", dest="channels", type=int, default=1)
    p.add_argument("-qscale", dest="qscale", type=int, default=2)
    p.add_argument("-amv_quant", dest="amv_quant", choices=["ffmpeg", "q60"],
                   default="ffmpeg",
                   help="AMV encode quantizer: ffmpeg = the reference "
                        "encoder's (MPEG-1 matrix x qscale, bit-exact); q60 "
                        "= the decoder's own sp5x Q60 tables (>=30 dB round "
                        "trips)")
    p.add_argument("-acodec", dest="acodec", choices=["pcm", "copy"],
                   default="pcm", help="WAV output codec (copy is not yet "
                                       "ported)")
    p.add_argument("-trellis", dest="trellis", action="store_true",
                   help="Viterbi ADPCM quantizer (not yet ported)")
    p.add_argument("-psnr", dest="psnr", action="store_true",
                   help="print encode PSNR (not yet ported)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("-t", dest="duration", type=float, default=None,
                   help="limit output duration in seconds (frames = t * "
                        "source fps)")
    p.add_argument("--seek", type=int, default=0,
                   help="start decoding at this frame index")
    p.add_argument("-y", dest="overwrite", action="store_true",
                   help="overwrite output (outputs are always overwritten)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; a missing "
                        "card is an error, never a silent CPU run)")
    p.add_argument("output", nargs="?", help="output file")
    args = p.parse_args(argv)
    if not args.inputs or not args.output:
        p.error("need -i input(s) and an output")
    if args.channels != 1:
        raise SystemExit("-ac must be 1: AMV audio is mono "
                         "(IMA-ADPCM AMV, adpcm.c mono guard)")
    for flag, on in (("-trellis", args.trellis), ("-psnr", args.psnr),
                     ("-acodec copy", args.acodec == "copy")):
        if on:
            _not_ported(flag)

    src_ext = os.path.splitext(args.inputs[0])[1].lower()
    out_ext = os.path.splitext(args.output)[1].lower()
    if args.duration is not None and args.max_frames is None:
        fps = args.fps
        if src_ext == ".amv":
            from .containers import riff
            with open(args.inputs[0], "rb") as f:
                fps = riff.parse_header(f.read(0x140)).fps_num
        args.max_frames = max(1, int(args.duration * fps))

    if args.format == "amv" or out_ext == ".amv":
        if len(args.inputs) == 1 and src_ext == ".amv" and not args.size:
            return _transcode(args)
        return _encode(args)
    if args.format is not None or src_ext != ".amv":
        _not_ported(f"the route {src_ext or 'raw'} -> "
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


def _decode(args, ext: str) -> int:
    """AMV -> PCM WAV (kernel A) or raw yuv420p frames (kernels D, U)."""
    from .containers import wav
    from .pipeline.decode import decode_file
    if ext not in (".wav", ".yuv"):
        _not_ported(f"the decode output {ext or args.output!r}")
    dec = decode_file(args.inputs[0], video=ext == ".yuv", audio=ext == ".wav",
                      max_frames=args.max_frames, start_frame=args.seek,
                      device=args.device)
    if ext == ".wav":
        wav.write_pcm(args.output, dec.pcm, dec.info.sample_rate,
                      dec.info.channels)
        print(f"wrote {args.output}: {len(dec.pcm)} samples @ "
              f"{dec.info.sample_rate} Hz (device {args.device})")
        return 0
    f = dec.y.shape[0]
    planes = [p.reshape(f, -1) for p in (dec.y, dec.cb, dec.cr)]
    with open(args.output, "wb") as fh:
        fh.write(np.concatenate(planes, axis=1).tobytes())
    print(f"wrote {args.output}: {f} frames {dec.info.width}x"
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


def _encode(args) -> int:
    """Raw .yuv (+ .wav) -> AMV (kernels V, E and Q), or AMV -> AMV through
    the full decode and re-encode when -s is given."""
    from .containers import wav
    from .pipeline.encode import encode_to_file
    w = h = None
    if args.size:
        w, h = map(int, args.size.lower().split("x"))
    exts = [os.path.splitext(s)[1].lower() for s in args.inputs]
    unknown = [e for e in exts if e not in (".yuv", ".wav", ".amv")]
    if unknown or len(args.inputs) > 2:
        _not_ported(f"encoding from {', '.join(unknown or exts)}")
    src = dict(zip(exts, args.inputs))
    pcm = None
    if ".amv" in src:
        from .pipeline.decode import decode_file
        dec = decode_file(src[".amv"], max_frames=args.max_frames,
                          start_frame=args.seek, device=args.device)
        if (dec.info.width, dec.info.height) != (w or dec.info.width,
                                                 h or dec.info.height):
            _not_ported("rescaling (-s other than the input's size)")
        w, h = dec.info.width, dec.info.height
        y, cb, cr, pcm = dec.y, dec.cb, dec.cr, dec.pcm
        if len(pcm) and dec.info.sample_rate != args.sample_rate:
            _not_ported("audio resampling (-ar other than the input's rate)")
    elif ".yuv" in src:
        if w is None:
            raise SystemExit("raw YUV encode requires -s WxH")
        y, cb, cr = _read_yuv(src[".yuv"], w, h, args.max_frames)
    else:
        raise SystemExit("encode requires a raw .yuv input")
    if pcm is None and ".wav" in src:
        pcm, rate = wav.read_pcm(src[".wav"])
        if pcm.ndim > 1:
            pcm = pcm.mean(axis=1).astype(np.int16)
        if rate != args.sample_rate:
            _not_ported(f"audio resampling ({rate} -> {args.sample_rate} "
                        "Hz)")
    if pcm is None:
        pcm = np.zeros(y.shape[0] * args.sample_rate // args.fps, np.int16)
    size = encode_to_file(args.output, y, cb, cr, pcm, fps=args.fps,
                          sample_rate=args.sample_rate, qscale=args.qscale,
                          quant=args.amv_quant, device=args.device)
    print(f"wrote {args.output}: {size} bytes, {y.shape[0]} frames "
          f"(device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
