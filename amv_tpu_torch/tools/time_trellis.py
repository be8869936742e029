"""Time kernel L (the `-trellis` Viterbi quantizer), its chain round by
round, and the MS-ADPCM expand (kernel M, or the torch loop of a tree
before it) of the amv_tpu_torch package that comes first on sys.path, at
the main paths' shapes on one GPU:

* L at 22,050 Hz and 16 fps: `chip_smoke.py`'s 300 s of seeded audiogen
  PCM in the encoder's chunk layout (4,800 chunks of 1,378 samples) from
  the chain's fixed point (phase 13's launch), and at 44,100 Hz and 12
  fps (chunks of ~3,675 samples) from seeded random start states;
* the chain (`encode_chain` from kernel Q's step indices, as
  `encode_stream(trellis=True)` runs it): each round's chunks, its
  launch's time (CUDA events) and its wall time with the round's host
  sync (`torch.nonzero`), and the chain's median wall time;
* the MS-ADPCM expand (`kernels.adpcm.decode_ms_nibbles`) on phase 12's
  lanes (300 s of seeded 44,100 Hz stereo MS-ADPCM at block_align 2,048:
  12,998 lanes of 2,034 samples), also in a burst of `--burst` launches
  queued back to back with the SM clock nvidia-smi reads meanwhile (a
  launch that ends in a synchronize runs before the card has left its
  idle clocks), and the whole WAVE decode (`codecs.wav_audio.decode_ms`,
  host clock) in Msamples/s.

Each result is held bit-exact against its plain version (`trellis_chunks_
plain`; `decode_ms_nibbles_plain`, or a tree's torch loop itself).  Times:
the median of CUDA events over `--reps` calls after a warm-up, and the
device time per call from `torch.profiler`; `nvcc -Xptxas -v` of the
kernels' sources gives registers and spills, and `cuobjdump -sass` of the
built library L's per-sample loop by pipe (`loop_counts`).  Prints one
JSON line: the tree, the card's name and power limit, and the readings.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_trellis.py

To compare two trees, run it from each in turns (parent, change, change,
parent) inside one command.  `--device cpu` runs the plain versions at a
size given by the flags (the tests' rehearsal); it measures no device
time.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import time

import numpy as np
import torch

WAV_RATE, WAV_BLOCK = 44100, 2048
# an instruction of cuobjdump -sass or nvdisasm output: its address, its
# opcode and its operands (a guard predicate dropped)
SASS_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][\w.]*)\s*([^;]*);")
_TARGET = re.compile(r"(\.L_\w+|0x[0-9a-f]+)")
# SASS opcodes off the integer ALU pipe: the multiply-add pipe (IMAD),
# memory and shuffles (MIO), and control
_NOT_ALU = ("IMAD", "SHFL", "LDS", "STS", "LDG", "STG", "BRA", "BSSY",
            "BSYNC", "WARPSYNC", "NOP", "S2R", "UMOV", "ULDC", "CS2R", "MOV")


def backward_branches(body, index):
    """(first, last) positions of each loop in body [(opcode, operands,
    ...)]: a branch whose target, a label (nvdisasm) or an address
    (cuobjdump), is at or before it in index {target: position}."""
    out = []
    for i, (op, args, *_) in enumerate(body):
        t = _TARGET.search(args)
        if op.startswith("BRA") and t and index.get(t.group(1), i + 1) <= i:
            out.append((index[t.group(1)], i))
    return out


def loop_counts(sass: str, kernel: str):
    """Opcodes of the innermost loop of `kernel` in cuobjdump -sass text
    that holds a warp shuffle and more than 200 instructions (kernel L's
    per-sample loop; its uniform path, not the divergent fallback that
    holds WARPSYNC): {"instructions", "alu", "imad", "mio", opcode counts}
    or None where there is no such loop."""
    text = next((sec for sec in re.split(r"\n\s*Function : ", sass)
                 if kernel in sec.split("\n")[0]), None)
    if text is None:
        return None
    ins = [(m.group(2), m.group(3), int(m.group(1), 16))
           for m in map(SASS_INSN.match, text.splitlines()) if m]
    best = None
    for lo, hi in backward_branches(
            ins, {f"0x{a:x}": i for i, (_, _, a) in enumerate(ins)}):
        ops = [o for o, _, _ in ins[lo:hi + 1]]
        if (len(ops) > 200 and "SHFL.IDX" in ops and not any(
                o.startswith("WARPSYNC") for o in ops)
                and (best is None or len(ops) < len(best))):
            best = ops
    if best is None:
        return None
    c = collections.Counter(best)
    return {"instructions": len(best),
            "alu": sum(v for k, v in c.items() if not k.startswith(_NOT_ALU)),
            "imad": sum(v for k, v in c.items() if k.startswith("IMAD")),
            "mio": sum(v for k, v in c.items()
                       if k.startswith(("SHFL", "LDS", "STS"))),
            "opcodes": dict(c.most_common())}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def event_ms(fn, reps, dev):
    """Median milliseconds of fn() (CUDA events on the card, the host
    clock on the CPU) after a warm-up, and the last result."""
    out = fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times), out


def device_ms(fn, reps, dev):
    """Device milliseconds a launch of each kernel fn runs, by kernel name
    (torch.profiler: each kernel's total over the launches it recorded,
    so a record the profiler drops does not halve the time); None on the
    CPU."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0:
            split[ev.key[:60]] = ev.device_time_total / 1e3 / ev.count
    return split


def burst_ms(fn, n, smi):
    """Milliseconds a call of fn runs when n calls are queued back to back
    (CUDA events around all n, after n more queued the same way, so the
    card has left its idle clocks), and the SM clock nvidia-smi reads
    while those first n drain."""
    for _ in range(n):
        fn()
    clock = smi("clocks.sm")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, clock


def ms_stream(seconds, rng):
    """`seconds` of 44,100 Hz stereo MS-ADPCM blocks of WAV_BLOCK bytes
    from seeded random bytes, headers in range (as chip_smoke.py phase
    12 makes them)."""
    n = int(seconds * WAV_RATE) * 2
    ms = rng.integers(0, 256, (-(-n // (2 * (WAV_BLOCK - 14) + 4)),
                               WAV_BLOCK), dtype=np.uint8)
    ms[:, :2] = rng.integers(0, 7, (len(ms), 2))
    ms[:, 2:6] = rng.integers(-200, 4000, (len(ms), 2)).astype(
        "<i2").view(np.uint8)
    return ms.tobytes()


def trellis_readings(L, amv_audio, adpcm, fixtures, dev, args):
    """L at both chunk sizes and the chain round by round."""
    out = {}
    pcm = fixtures.audiogen(args.seconds, 22050, seed=0)
    frame = (2 * 22050 + 16) // (2 * 16)
    ns, starts, padded, reset = amv_audio.stream_layout(pcm, frame, 22050)
    x = torch.from_numpy(padded).to(dev)
    st = torch.from_numpy(starts).to(dev)
    pairs = torch.tensor(ns, dtype=torch.int32, device=dev)
    pred0 = x[st].to(torch.int32)
    _, sidx_even = adpcm.encode_streams(
        x[None], torch.from_numpy(reset[None]).to(dev),
        torch.zeros(1, dtype=torch.int32, device=dev))
    guess = sidx_even[0, st // 2].to(torch.int32)

    # the chain round by round: each round's chunks, launch and wall time
    launch, rounds = L.trellis_chunks, []

    def counted(x_, starts_, *a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if dev.type == "cuda" else None
        t = time.perf_counter()
        if ev:
            ev[0].record()
        r = launch(x_, starts_, *a)
        if ev:
            ev[1].record()
        rounds.append((starts_.shape[0], t, ev))
        return r

    L.trellis_chunks = counted
    try:
        t0 = time.perf_counter()
        _, step, _ = L.encode_chain(x, st, pairs, 0, guess)
        _sync(dev)
        t_end = time.perf_counter()
    finally:
        L.trellis_chunks = launch
    per = []
    for k, (n, t, ev) in enumerate(rounds):
        t_next = rounds[k + 1][1] if k + 1 < len(rounds) else t_end
        per.append({"chunks": n, "wall_ms": 1e3 * (t_next - t),
                    "launch_ms": ev[0].elapsed_time(ev[1]) if ev else None})
    out["chain_rounds"] = per
    out["chain_first_wall_ms"] = 1e3 * (t_end - t0)
    out["chain_ms"] = event_ms(lambda: L.encode_chain(x, st, pairs, 0,
                                                      guess), 3, dev)[0]

    # L from the fixed point: phase 13's launch
    def run(fn, x_, st_, pairs_, step_, pred_):
        buf = torch.zeros(x_.numel() // 2, dtype=torch.uint8, device=dev)
        return buf, fn(x_, st_, pairs_, step_, pred_, buf)

    args_l = (x, st, pairs, step, pred0)
    out["L_ms"], got = event_ms(lambda: run(L.trellis_chunks, *args_l),
                                args.reps, dev)
    out["L_device_ms"] = device_ms(lambda: run(L.trellis_chunks, *args_l),
                                   args.reps, dev)
    t = time.perf_counter()
    want = run(L.trellis_chunks_plain, *args_l)
    _sync(dev)
    out["L_plain_ms"] = 1e3 * (time.perf_counter() - t)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "L != plain"
    assert torch.equal(step[1:], got[1][:-1]), "off the fixed point"
    out["L_chunks"], out["L_chunk_samples"] = len(ns), 2 * ns[0]

    # L at 44,100 Hz and 12 fps from seeded random starts
    pcm = fixtures.audiogen(args.seconds_44k, 44100, seed=1)
    frame = (2 * 44100 + 12) // (2 * 12)
    ns, starts, padded, _ = amv_audio.stream_layout(pcm, frame, 44100)
    x = torch.from_numpy(padded).to(dev)
    st = torch.from_numpy(starts).to(dev)
    pairs = torch.tensor(ns, dtype=torch.int32, device=dev)
    step = torch.from_numpy(np.random.default_rng(2).integers(
        0, 89, len(ns)).astype(np.int32)).to(dev)
    args_l = (x, st, pairs, step, x[st].to(torch.int32))
    out["L_44k_ms"], got = event_ms(lambda: run(L.trellis_chunks, *args_l),
                                    args.reps, dev)
    want = run(L.trellis_chunks_plain, *args_l)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "L 44k"
    out["L_44k_chunks"], out["L_44k_chunk_samples"] = len(ns), 2 * ns[0]
    return out


def ms_readings(adpcm, wav_audio, dev, args):
    """The MS-ADPCM expand alone and the whole WAVE decode."""
    data = ms_stream(args.ms_seconds, np.random.default_rng(0))
    sizes, lanes = wav_audio._lanes(data, 2, WAV_BLOCK, 14,
                                    wav_audio._ms_lanes)
    t = [torch.from_numpy(a).to(dev) for a in lanes]
    plain = getattr(adpcm, "decode_ms_nibbles_plain", None)
    looped = plain is None                      # a tree's loop: ~350 ms
    reps = 2 if looped else args.reps
    plain = plain or adpcm.decode_ms_nibbles
    out = {"M_lanes": int(t[0].shape[0]), "M_samples": int(t[0].shape[1])}
    out["M_ms"], got = event_ms(lambda: adpcm.decode_ms_nibbles(*t), reps,
                                dev)
    split = device_ms(lambda: adpcm.decode_ms_nibbles(*t), reps, dev)
    out["M_device_ms"] = None if split is None else sum(split.values())
    if dev.type == "cuda" and args.burst and not looped:
        from amv_tpu_torch.tools import time_transcode_kernel as tk
        out["M_burst_ms"], out["M_burst_sm_clock"] = burst_ms(
            lambda: adpcm.decode_ms_nibbles(*t), args.burst, tk.smi)
    want = plain(*t)
    assert torch.equal(got, want), "M != plain"
    ms_dec, pcm = event_ms(lambda: wav_audio.decode_ms(
        data, 2, WAV_BLOCK, device=dev), 3, dev)
    out["wav_ms_decode_ms"] = ms_dec
    out["wav_ms_msamples_s"] = pcm.numel() / ms_dec / 1e3
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=300.0,
                    help="PCM at 22,050 Hz for L and the chain")
    ap.add_argument("--seconds-44k", type=float, default=60.0,
                    help="PCM at 44,100 Hz for L's 3,675-sample chunks")
    ap.add_argument("--ms-seconds", type=float, default=300.0,
                    help="44,100 Hz stereo MS-ADPCM for M")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--burst", type=int, default=2000,
                    help="M's launches queued back to back for M_burst_ms")
    args = ap.parse_args(argv)
    import amv_tpu_torch
    from amv_tpu_torch.codecs import amv_audio, wav_audio
    from amv_tpu_torch.kernels import _build, adpcm
    from amv_tpu_torch.kernels import adpcm_trellis as L
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.verify import fixtures

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --device cpu)")
    ptx = None
    if dev.type == "cuda":
        srcs = [s for s in ("adpcm_trellis.cu", "adpcm_ms.cu")
                if os.path.exists(os.path.join(tk._csrc(_build), s))]
        ptx = tk.ptxas_start(_build, srcs)
        _build.library()
    out = {"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__)))}
    out["card"] = tk.smi("name,power.limit") if dev.type == "cuda" \
        else "cpu"
    ms = trellis_readings(L, amv_audio, adpcm, fixtures, dev, args)
    ms.update(ms_readings(adpcm, wav_audio, dev, args))
    out["ms"] = ms
    out["ptxas"] = tk.ptxas_lines(ptx) if ptx else None
    if dev.type == "cuda":
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        out["L_loop_sass"] = loop_counts(subprocess.run(
            [cuobjdump, "-sass", _build.build()], capture_output=True,
            text=True, check=True).stdout, "trellis_kernel")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
