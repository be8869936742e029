"""ffmpeg-shaped CLI of the PyTorch/CUDA port (the transcode route).

  python -m amv_tpu_torch -i in.amv -f amv out.amv            # on the GPU
  python -m amv_tpu_torch -i in.amv -f amv -qscale 4 out.amv --device cpu

The flags are `amv_tpu.cli`'s for its AMV->AMV transcode route; every
other route of that CLI (decode, encode, G.729A, probes) is not yet
ported and exits non-zero saying so.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="amv_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", dest="inputs", action="append", default=[],
                   help="input .amv file")
    p.add_argument("-f", dest="format", default=None, help="force format (amv)")
    p.add_argument("-qscale", dest="qscale", type=int, default=2)
    p.add_argument("-amv_quant", dest="amv_quant", choices=["ffmpeg", "q60"],
                   default="ffmpeg",
                   help="AMV encode quantizer (q60 is not yet ported)")
    p.add_argument("-y", dest="overwrite", action="store_true",
                   help="overwrite output (outputs are always overwritten)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; a missing "
                        "card is an error, never a silent CPU run)")
    p.add_argument("output", nargs="?", help="output .amv file")
    args = p.parse_args(argv)
    if len(args.inputs) != 1 or not args.output:
        p.error("need one -i input and an output")
    src_ext = os.path.splitext(args.inputs[0])[1].lower()
    out_ext = os.path.splitext(args.output)[1].lower()
    if src_ext != ".amv" or not (args.format == "amv" or out_ext == ".amv"):
        raise SystemExit("only the AMV -> AMV transcode is ported; this "
                         "route is not yet ported (use python -m amv_tpu)")

    from .pipeline.transcode import transcode_bytes
    with open(args.inputs[0], "rb") as f:
        data = f.read()
    out = transcode_bytes(data, qscale=args.qscale or 2,
                          quant=args.amv_quant, device=args.device)
    with open(args.output, "wb") as f:
        f.write(out)
    print(f"wrote {args.output}: {len(out)} bytes (requantized "
          f"qscale={args.qscale or 2}, device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
