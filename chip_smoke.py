#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (amv_tpu_torch) on one NVIDIA GPU and check
its paths end to end: the complete AMV->AMV transcode (with each of its
entropy encoders), the record-IR decode, the AMV decode (video and audio),
the AMV encode, the q60 quantizer and odd picture sizes.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
 1. the card: nvidia-smi name and power limit, torch.cuda required;
 2. build the twelve CUDA kernels from amv_tpu_torch/csrc (nvcc, sm_90a,
    one nvcc per source, all started together), and log the registers,
    spills and shared memory ptxas gives kernels D, E, Q, V, T, A, X, P
    and F, and kernel T's SASS instructions (cuobjdump, static counts: one
    thread a block), logged in phase 4 with a static-count estimate of
    each T entry's issue time at its own blocks;
 3. a 160x120 corpus at the reference's canonical shape (16 fps, 22,050 Hz
    ADPCM audio): 4,800 frames (5 minutes) of seeded videogen/rotozoom
    pictures with noise, each C-encoded at qscale 2, muxed into an .amv
    with one encoded second of audio repeated; and 300 s of audiogen PCM
    for the encode path;
 4. each kernel against its plain torch version on the card, bit-exact,
    at the main paths' shapes, with each one's median time (CUDA events)
    beside the plain version's and its bound (the least time the card
    could take: the bytes it must move over the memory rate, or its
    integer operations over the peak rate, whichever is larger):
    D, T, E (and E's count entry) on the corpus as the transcode hands it
    over, with D's sync rounds per frame; I on the
    corpus blocks; F on the blocks of the raw corpus pictures; U (both
    entries) on the corpus levels and DC, un-sorting as the decode does;
    V on the raw corpus pictures (the path entry with each quantizer, the
    contract entry on their coded planes); A on the
    file's audio chunks; Q on the 300 s stream's chunk layout, with its
    passes' device times (torch.profiler) and one chunk's walk alone; R and X
    (the record decode) on the transcode's scans, in a budget no frame
    overflows; P on the record encoder's records of the re-encode levels;
    and the other entries over the same kernels: T's dequantized entry on
    the corpus's dequantized blocks and its wrap 64 times over the first
    N_CHECK frames' blocks, I's raw idct_put on the corpus's dequantized
    blocks, F's raster fdct_quantize, A's wrap entry 64 times over and Q's
    8 times over.  Then extra cases: malformed scans (D, R), kernel D's
    subsequence cases (data ending at and around subsequence boundaries,
    scans cut by 1-3 bytes, failures in the first and the last
    subsequence, a spent token budget, wider rows and so a larger
    subsequence), no edge replication (T), an overflowing word
    budget (E, P), kernel E's edges (a frame ending exactly at 32 w_out
    bits and one bit past, a w_out too large for shared memory, 320x240 and
    175x97 pictures, q60 flat frames), DC-only blocks
    (I), qscale 1 (F, V), flat frames at luma 0/255/128/13 under q60 (V),
    168x120 and an odd size (U, V), 168x120 (T, both entries), clamp-stress
    payloads (A), a stream
    with no reset at sample 0, one starting at step index 88 and 2 s as
    one segment (Q); R + X
    against D's levels, in the budget and in JAX's default one;
 5. the transcode through the user's entry point, amv_tpu_torch.cli.main:
    video byte-identical to the C reference transcode, audio passed
    through, D, T and E launched; frames/s and the split between the
    device chain and the host stages; then the record decode path
    (decode_scans_async: R and X launched, levels equal to D's) and the
    transcode's device chain with each entropy encoder (transcode_complete
    with enc = record, rechunk, parallel beside async): bytes equal to
    the C reference, P launched by record and rechunk, E by none of them,
    and each chain's time;
 6. the decode through cli.main, to .yuv and to .wav: every frame
    byte-identical to the C decoder, the PCM to the C ADPCM decoder chunk
    by chunk, D, U and A launched and not I; frames/s, Msamples/s and the
    split; the old chain (I + assembly) against the new (U), interleaved;
 7. the encode through cli.main from .yuv + .wav: every video chunk
    byte-identical to the C encoder, every audio chunk to the Python
    ADPCM oracle, V, E and Q launched and not F; frames/s, Msamples/s and
    the split; the old chain (extraction + F) against the new (V),
    interleaved; a zero-frame encode on the card equal to the CPU route's;
 8. -amv_quant q60 through cli.main: the encode and the transcode of the
    corpus (the two-stage route D, U, V, E; not T), frames/s; every q60
    payload decoded by the C decoder to the port's planes, Y round trips
    of at least 30 dB, the first 256 frames' bytes equal to the port's CPU
    route;
 9. 64 frames at 168x120 (width not whole MCUs) through the transcode
    (with each entropy encoder), the decode and the encode,
    byte-identical to C; then 64 frames at 175x97 (odd: the two-stage
    transcode, each entropy encoder) byte-identical to C, and their q60
    transcode and encode equal to the port's CPU route;
10. 256 frames at 320x240 through transcode_bytes and through the
    transcode's device chain with each entropy encoder, byte-identical to
    C.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

N_FRAMES, W, H, FPS, RATE, QSCALE = 4800, 160, 120, 16, 22050, 2
N_CHECK = 512
N_PAD, W_PAD = 64, 168          # 168 = 10.5 MCUs: right-hand pad columns
# an odd size: 97 = 16 * 6 + 1 rows leave the last MCU row 48 chroma rows,
# none in its own MCU row (kernel T refuses it; the two-stage route runs)
ODD_W, ODD_H = 175, 97
N_CPU = 256                     # q60 frames also run on the port's CPU route
WRAP = 64                       # kernel A's wrap entry: the chunks 64 times

# Peaks of one H100 SXM at 700 W, from its datasheet: device memory, and
# float32 outside the tensor cores, the rate for the scalar units, against
# which the bounds count each integer operation.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Integer operations per unit of work, counted from the CUDA sources
# (multiplies, adds, shifts, compares, selects; loads and stores not):
OPS_DEQUANT = 190    # dct.cuh callers: Q60 dequant and the DC slot
OPS_IDCT = 1410      # dct.cuh: simple_idct row pass 600 + column pass 810
OPS_FDCT = 1600      # dct.cuh: two jfdctint passes 1,200 + quantizer 400
OPS_FDCT_Q60 = 3100  # the passes 1,200 + the q60 quantizer: 64 x (a divide
                     # by a run-time divisor ~20 + ~10 others)
Q_WRAP = 8           # kernel Q's wrap entry: the stream 8 times
OPS_TOKEN = 20       # a Huffman token: peek, table walk, extend, store
OPS_EXPAND = 15      # an ADPCM decode sample (adpcm_decode.cu expand)
OPS_COMPRESS = 25    # an ADPCM encode sample (adpcm_encode.cu compress)
OPS_SCATTER = 8      # a record expanded (record_expand.cu)
OPS_RECORD = 12      # a record packed (record_pack.cu: its length in the
                     # scan, the code's mask and shifts, one or two ORs)


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port() -> SimpleNamespace:
    """The port's modules this script drives; nothing of JAX or amv_tpu."""
    from amv_tpu_torch import cli, native
    from amv_tpu_torch.codecs import amv_audio, amv_video, jpeg_tables
    from amv_tpu_torch.containers import riff, wav
    from amv_tpu_torch.kernels import _build, adpcm, fdct, idct
    from amv_tpu_torch.kernels import decode_fused as U
    from amv_tpu_torch.kernels import encode_fused as V
    from amv_tpu_torch.kernels import entropy_decode as D
    from amv_tpu_torch.kernels import entropy_encode as E
    from amv_tpu_torch.kernels import entropy_parallel as EP
    from amv_tpu_torch.kernels import entropy_records as R
    from amv_tpu_torch.kernels import record_pack as RP
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.pipeline import decode, encode
    from amv_tpu_torch.pipeline import transcode as P
    from amv_tpu_torch.tools import time_transcode_kernel as tools_t
    from amv_tpu_torch.verify import fixtures, ref_adpcm
    return SimpleNamespace(**locals())


def pictures(m, n, h, w, seed):
    """n seeded YUV420 pictures: videogen and rotozoom, interleaved in
    runs of 16, with +-3 luma noise."""
    rng = np.random.default_rng(seed)
    half = n // 2
    vg = m.fixtures.videogen(half, h, w, seed=seed)
    rz = m.fixtures.rotozoom(n - half, h, w)
    y = np.empty((n, h, w), np.uint8)
    cb = np.empty((n, h // 2, w // 2), np.uint8)
    cr = np.empty_like(cb)
    for i in range(n):
        src = vg if (i // 16) % 2 == 0 else rz
        k = i // 32 * 16 + i % 16
        y[i] = np.clip(src[0][k].astype(np.int16) +
                       rng.integers(-3, 4, src[0][k].shape), 0, 255)
        cb[i] = src[1][k][:h // 2, :w // 2]
        cr[i] = src[2][k][:h // 2, :w // 2]
    return y, cb, cr


def c_encode(m, pics):
    return [m.native.ref_encode_frame(pics[0][i], pics[1][i], pics[2][i],
                                      QSCALE) for i in range(len(pics[0]))]


def c_transcode(m, pays, w, h):
    return [m.native.ref_encode_frame(*m.native.ref_decode_frame(p, w, h),
                                      QSCALE) for p in pays]


def c_decode_matches(m, pays, w, h, y, cb, cr) -> None:
    for i, p in enumerate(pays):
        ry, rcb, rcr = m.native.ref_decode_frame(p, w, h)
        if not (np.array_equal(y[i], ry) and np.array_equal(cb[i], rcb)
                and np.array_equal(cr[i], rcr)):
            raise AssertionError(f"{w}x{h} frame {i} differs from the C "
                                 "decoder")


def cuda_ms(fn, reps, warmup=True):
    """(median milliseconds of fn() on the current stream (CUDA events),
    the last call's result); one warm-up call first unless warmup=False."""
    import torch
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


Q_PASSES = (("pass 1", ("window_ends",)),
            ("pass 2", ("group_maps", "group_chain", "window_chain")),
            ("pass 3", ("window_encode",)))


def q_passes(fn, reps=10):
    """Device milliseconds per call of fn (kernel Q's wrapper) by pass, from
    torch.profiler's kernel times: Q's three passes and the rest (the
    counters' memset and any torch work of the wrapper, "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k, _ in Q_PASSES}
    out["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = getattr(ev, "cuda_time_total", 0) if us is None else us
        if us <= 0:
            continue
        key = next((k for k, names in Q_PASSES
                    if any(nm in ev.key for nm in names)), "other")
        out[key] += us / 1e3 / reps
    assert out["pass 1"] > 0 and out["pass 3"] > 0, \
        f"torch.profiler saw no device time for kernel Q's passes: {out}"
    return out


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over pairs of integer tensors; raises if
    shapes or dtypes differ."""
    err = 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
    return err


def bound(nbytes: float, ops: float):
    """(bound in ms, what bounds it) for a function that moves nbytes and
    does ops integer operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def staged(split, name, fn):
    """Run fn, synchronize, and add its host-clock seconds to split."""
    import torch
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    split[name] = time.perf_counter() - t
    return r


def log_split(what, split, extra=""):
    total = sum(split.values())
    dev = sum(v for k, v in split.items() if k.startswith("device"))
    log(f"{what} split (s): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in split.items())
        + f"; device {dev / total:.1%} of {total:.3f}{extra}")


def timed_cli(m, argv, runs=3):
    """Median wall seconds of cli.main(argv) over `runs` passes, and the
    walls."""
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        rc = m.cli.main(argv)
        walls.append(time.perf_counter() - t0)
        assert rc == 0, argv
    return statistics.median(walls), walls


def ptxas_start(m):
    """nvcc -Xptxas -v of kernels D's and R's, E's, Q's, V's, T's, A's, X's,
    P's and F's sources, started beside the build (the object goes
    nowhere)."""
    return m.tools_t.ptxas_start(m._build, (
        "entropy_decode.cu", "entropy_encode.cu", "adpcm_encode.cu",
        "encode_fused.cu", "transcode.cu", "adpcm_decode.cu",
        "record_expand.cu", "record_pack.cu", "fdct.cu"))


def ptxas_log(m, procs) -> None:
    """Each kernel's registers, spills and shared memory, as ptxas says
    (stack and spill lines only where they are not all 0)."""
    for name, lines in m.tools_t.ptxas_lines(procs).items():
        for line in lines:
            if not line.split(": ", 1)[1].startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes"):
                log(f"ptxas {name} {line}")


def reset_launches(m):
    m.D.LAUNCHES = m.T.LAUNCHES = m.E.LAUNCHES = m.E.COUNT_LAUNCHES = 0
    m.idct.LAUNCHES = m.fdct.LAUNCHES = m.U.LAUNCHES = m.V.LAUNCHES = 0
    m.adpcm.DECODE_LAUNCHES = m.adpcm.ENCODE_LAUNCHES = 0
    m.R.RECORD_LAUNCHES = m.R.EXPAND_LAUNCHES = m.RP.LAUNCHES = 0


def launches(m):
    return {"D": m.D.LAUNCHES, "T": m.T.LAUNCHES, "E": m.E.LAUNCHES,
            "E count": m.E.COUNT_LAUNCHES,
            "I": m.idct.LAUNCHES, "F": m.fdct.LAUNCHES,
            "U": m.U.LAUNCHES, "V": m.V.LAUNCHES,
            "A": m.adpcm.DECODE_LAUNCHES, "Q": m.adpcm.ENCODE_LAUNCHES,
            "R": m.R.RECORD_LAUNCHES, "X": m.R.EXPAND_LAUNCHES,
            "P": m.RP.LAUNCHES}


def route_bytes(m, pays, w, h, enc):
    """The video chunks of transcode_complete(enc=...) over payloads,
    length-sorted as transcode_bytes sorts them."""
    import torch
    rows, lens = m.native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    words, bits, ok = m.P.transcode_complete(
        torch.from_numpy(rows[order]).cuda(),
        torch.from_numpy(lens[order]).cuda(), n_mcu, QSCALE, (w, h), enc=enc)
    assert ok.all()
    inv = np.argsort(order)
    return m.native.escape_frames(words.cpu().numpy()[inv],
                                  bits.cpu().numpy()[inv])


def check_routes(m, pays, w, h, want) -> None:
    """Every entropy encoder's bytes equal the C reference's, and kernel E
    runs in none but "async"."""
    for enc in m.P.ENCODERS:
        e0 = m.E.LAUNCHES
        assert route_bytes(m, pays, w, h, enc) == want, (enc, w, h)
        assert (m.E.LAUNCHES > e0) == (enc == "async"), (enc, "kernel E")


def d_cases(m, rows, lens, nb, rng):
    """Kernel D's subsequence cases on corpus scans (S is 1,024 bits, 128
    bytes, for rows up to 16 KB): (name, rows, lens, budget or None)."""
    import torch
    n = len(rows)
    out = []
    r, ln = rows.copy(), lens.copy()
    for f in range(n):                   # data ending on and around 128 k
        ln[f] = min(int(lens[f]), 128 * (1 + f // 3)) + f % 3 - 1
    out.append(("boundaries", r, ln, None))
    out.append(("cut", rows, lens - (np.arange(n) % 3 + 1), None))
    r = rows.copy()
    r[::2, 3:7] = 0xFF
    out.append(("fail_first", r, lens, None))
    r = rows.copy()
    for f in range(0, n, 2):
        at = min((8 * int(lens[f]) - 1) // 1024 * 128 + 2, int(lens[f]) - 4)
        r[f, at:at + 4] = 0xFF
    out.append(("fail_last", r, lens, None))
    budget = m.D.token_budget(torch.from_numpy(lens), nb, rows.shape[1])
    budget[::2] = torch.from_numpy(rng.integers(1, 900, (n + 1) // 2))
    out.append(("budget", rows, lens, budget))
    for stride in (20000, 170000):       # wider strides: a larger S
        wide = np.zeros((n, stride), np.uint8)
        wide[:, :rows.shape[1]] = rows
        out.append((f"stride {stride}", wide, lens, None))
    return out


def e_fit(m, lv, target):
    """lv's frame 0 with levels zeroed from its end until its bits are
    target mod 32 -> (levels, its bits)."""
    lv = lv.clone()
    bits = int(m.E.count_bits_plain(lv[:1])[0])
    for b in range(lv.shape[1] - 1, 0, -1):
        for k in range(63, 0, -1):
            if bits % 32 == target:
                return lv, bits
            if lv[0, b, k]:
                lv[0, b, k] = 0
                bits = int(m.E.count_bits_plain(lv[:1])[0])
    raise AssertionError("no fit found")


def rand_levels(rng, n_blocks, dense=0.15):
    """Sparse levels int16 [n_blocks, 64] in +-1023, some blocks saturated."""
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


def interleaved(fns, rounds=4):
    """Median milliseconds (CUDA events) of each of fns, run in turns:
    forward in even rounds, backward in odd ones, after one warm-up."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(cuda_ms(fns[k], 1, warmup=False)[0])
    return {k: statistics.median(v) for k, v in times.items()}


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} "
        f"device(s), using {torch.cuda.get_device_name(0)}")
    m = import_port()
    assert not [k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "amv_tpu")]
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 2. build ---------------------------------------------------
    t0 = time.perf_counter()
    ptxas = ptxas_start(m)
    m._build.library()
    m.native.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{' '.join(m._build.NVCC_FLAGS)}; host C library with gcc)")
    ptxas_log(m, ptxas)
    t_sass = m.tools_t.sass_counts(m._build, ("transcode_blocks_kernel",))
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
        .split()[0])

    # ---- 3. corpus --------------------------------------------------
    t0 = time.perf_counter()
    pics = pictures(m, N_FRAMES, H, W, seed=0)
    pays = c_encode(m, pics)
    second = m.ref_adpcm.encode(m.fixtures.audiogen(1.0, RATE, seed=0),
                                round(RATE / FPS), RATE)
    audio = second * (N_FRAMES // FPS)
    data = m.riff.mux(pays, audio, width=W, height=H, fps=FPS,
                      sample_rate=RATE)
    pcm = m.fixtures.audiogen(N_FRAMES / FPS, RATE, seed=0)
    sizes = sorted(len(p) for p in pays)
    log(f"corpus: {N_FRAMES} frames {W}x{H} qscale {QSCALE}, payload bytes "
        f"min {sizes[0]} median {sizes[len(sizes) // 2]} max {sizes[-1]}; "
        f"{len(audio)} audio chunks; {len(data)} bytes; {len(pcm)} PCM "
        f"samples for the encode; {time.perf_counter() - t0:.1f} s")

    # ---- 4. kernels against their plain versions ---------------------
    # At the main paths' shapes; the outputs of each kernel's last timed
    # call are held against its plain version's, which runs once without a
    # warm-up (the plain decoder alone takes 15-20 s).
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    nb = n_mcu * 6
    qmat = m.amv_video.encoder_qmat(QSCALE)
    rows_all, lens_all = m.native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    rows_a = torch.from_numpy(rows_all[order]).to(dev)
    lens_a = torch.from_numpy(lens_all[order]).to(dev)
    kern, errs = {}, {}

    def tokens(levels):
        """Huffman tokens of zigzag levels: nonzero ACs, DCs and EOBs."""
        return int((levels[..., 1:] != 0).sum()) + 2 * levels[..., 0].numel()

    def check(key, kernel, plain, shape, nbytes, ops):
        """Time kernel and plain, hold their outputs equal, and record the
        bound; nbytes and ops are numbers or functions of the output."""
        kt, got = cuda_ms(kernel, 10)
        pt, want = cuda_ms(plain, 1, warmup=False)
        errs[key] = max_abs_err(zip(got, want))
        assert errs[key] == 0, f"{key}: kernel differs from plain by {errs[key]}"
        nbytes, ops = (v(got) if callable(v) else v for v in (nbytes, ops))
        bms, by = bound(nbytes, ops)
        kern[key] = {"ms": kt, "plain_ms": pt, "bound_ms": bms,
                     "bound_by": by}
        log(f"{key} at {shape}: bit-exact vs plain (max_abs_err 0); kernel "
            f"{kt:.3f} ms, plain {pt:.3f} ms (median, CUDA events); bound "
            f"{bms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} G int ops)")
        return got

    def extra(key, pairs, what):
        errs[key] = max_abs_err(pairs)
        assert errs[key] == 0, f"{key}: kernel differs by {errs[key]}"
        log(f"{key}: bit-exact vs plain on {what}")

    lv_a, ok_a = check(
        "D", lambda: m.D.decode_scans(rows_a, lens_a, nb),
        lambda: m.D.decode_scans_plain(rows_a, lens_a, nb),
        f"rows {tuple(rows_a.shape)}",
        int(lens_a.sum()) + 8 * N_FRAMES + N_FRAMES * nb * 128 + N_FRAMES,
        lambda got: OPS_TOKEN * tokens(got[0]))
    assert ok_a.all()

    def log_rounds(key, rounds):
        rounds = rounds.float()
        kern[key]["rounds"] = {"mean": float(rounds.mean()),
                               "max": int(rounds.max())}
        log(f"{key} sync rounds after the speculation, per frame: mean "
            f"{float(rounds.mean()):.2f}, max {int(rounds.max())} "
            f"({int((rounds == 0).sum())} of {N_FRAMES} frames in step at "
            "once)")

    log_rounds("D", m.D.LAST_ROUNDS)
    dc_a = m.amv_video.resolve_dc(
        lv_a.reshape(N_FRAMES, n_mcu, 6, 64)).reshape(-1)
    lvf = lv_a.reshape(-1, 64)
    n_blk = lvf.shape[0]
    geom = m.T._geometry((W, H), n_blk)
    check("T", lambda: (m.T.transcode_blocks(lvf, dc_a, qmat, (W, H)),),
          lambda: m.T.transcode_blocks_plain(lvf, dc_a, qmat, geom, False)[:1],
          f"{n_blk} blocks", n_blk * (128 + 4 + 128),
          n_blk * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    lv2_a, _ = check(
        "T pixel entry",
        lambda: m.T.transcode_blocks_pix(lvf, dc_a, qmat, (W, H)),
        lambda: m.T.transcode_blocks_plain(lvf, dc_a, qmat, geom, True),
        f"{n_blk} blocks", n_blk * (128 + 4 + 128 + 64),
        n_blk * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    lv2_a = lv2_a.reshape(lv_a.shape)
    wb = m.P.word_budget(rows_a)
    # E as the path runs it (pack_levels): the count entry, then the pack
    # at the longest frame's words
    (bits_c,) = check(
        "E count", lambda: (m.E.count_bits(lv2_a),),
        lambda: (m.E.count_bits_plain(lv2_a),), f"levels {tuple(lv2_a.shape)}",
        n_blk * 128 + 4 * N_FRAMES, OPS_TOKEN * tokens(lv2_a))
    w_used = (int(bits_c.max()) + 31) // 32
    words_e, bits_e, ok_e = check(
        "E", lambda: m.E.encode_levels(lv2_a, w_used),
        lambda: m.E.encode_levels_plain(lv2_a, w_used),
        f"levels {tuple(lv2_a.shape)}, w_out {w_used}",
        n_blk * 128 + N_FRAMES * (4 * w_used + 5), OPS_TOKEN * tokens(lv2_a))
    assert ok_e.all() and torch.equal(bits_e, bits_c)
    (pix_i,) = check(
        "I", lambda: (m.idct.idct_blocks(lvf, dc_a),),
        lambda: (m.idct.idct_blocks_plain(lvf, dc_a),),
        f"{n_blk} blocks", n_blk * (128 + 4 + 64),
        n_blk * (OPS_DEQUANT + OPS_IDCT))
    # I's raw entry (idct_put_soa's contract) on the corpus's own
    # dequantized blocks
    deq = m.idct.dequantize(lvf, dc_a).to(torch.int16)
    check("I idct_put", lambda: (m.idct.idct_put(deq.view(-1, 8, 8)),),
          lambda: (m.idct.idct_put_plain(deq).view(-1, 8, 8),),
          f"{n_blk} dequantized blocks", n_blk * (128 + 64),
          n_blk * OPS_IDCT)
    # T's dequantized entry (transcode_soa's contract) on the same blocks
    check("T deq entry", lambda: m.T.transcode_deq(deq, qmat),
          lambda: m.T.transcode_deq_plain(deq, qmat),
          f"{n_blk} dequantized blocks", n_blk * (128 + 64 + 128),
          n_blk * (OPS_IDCT + OPS_FDCT))
    # T's wrap (transcode_zz_wrap's contract): the first N_CHECK frames'
    # blocks WRAP times over, each output block with its base block's DC;
    # the plain version runs in slices of whole MCUs
    base = lvf[:N_CHECK * nb]
    n_wrap = base.shape[0] * WRAP
    widx = m.T.wrap_index(base.shape[0], WRAP, dev)
    dc_wrap = dc_a[:base.shape[0]][widx]
    step = 6 << 18

    def wrap_plain():
        outs = [m.T.transcode_blocks_plain(base[widx[a:a + step]],
                                           dc_wrap[a:a + step], qmat)
                for a in range(0, n_wrap, step)]
        return tuple(torch.cat(o) for o in zip(*outs))

    check("T wrap", lambda: m.T.transcode_blocks_pix(base, dc_wrap, qmat,
                                                     repeat=WRAP),
          wrap_plain, f"repeat={WRAP} over {base.shape[0]} blocks, {n_wrap} "
          "blocks out", base.shape[0] * 128 + n_wrap * (4 + 128 + 64),
          n_wrap * (OPS_DEQUANT + OPS_IDCT + OPS_FDCT))
    del widx, dc_wrap
    # kernel T's static SASS count a block, and for each entry a static-count
    # estimate of its issue time at its own blocks (an upper bound on the
    # issue of its instructions: the count holds both sides of each branch)
    t_entries = {"zigzag": ("T", n_blk),
                 "zigzag pix": ("T pixel entry", n_blk),
                 "deq pix": ("T deq entry", n_blk),
                 "wrap pix": ("T wrap", n_wrap)}
    sass_t = {}
    for fn, (cnt, ops) in sorted(t_sass.items()):
        entry = m.tools_t.t_instance(fn)
        sass_t[entry] = cnt
        key, blocks = t_entries[entry]
        log(f"T SASS {entry}: {cnt} instructions a block (static); "
            f"static-count issue estimate at its {blocks} blocks "
            f"<= {m.tools_t.issue_ms(cnt, blocks, max_mhz):.4f} ms "
            f"({max_mhz:.0f} MHz) beside its byte bound "
            f"{kern[key]['bound_ms']:.4f} ms and its time "
            f"{kern[key]['ms']:.4f} ms; commonest "
            + ", ".join(f"{o} {c}" for o, c in ops))
    # R and X: the record decode of the transcode's scans in a budget no
    # frame overflows (a block owns at most 64 records), then R + X against
    # kernel D's levels
    t_rec = 64 * nb
    recs_a, st_a = check(
        "R", lambda: m.R.decode_records(rows_a, lens_a, nb, t_rec),
        lambda: m.R.decode_records_plain(rows_a, lens_a, nb, t_rec),
        f"rows {tuple(rows_a.shape)}, {m.R.record_rows(t_rec)} records a "
        "frame", lambda got: int(lens_a.sum()) + 8 * N_FRAMES +
        4 * got[0].numel() + 8 * N_FRAMES,
        lambda got: OPS_TOKEN * int(got[1][:, 1].sum()))
    assert (st_a[:, 0] == nb).all() and recs_a.is_contiguous()
    log_rounds("R", m.R.LAST_ROUNDS)
    cnt_a = st_a[:, 1].contiguous()
    n_dec = int(cnt_a.sum())
    (lv_x,) = check(
        "X", lambda: (m.R.expand_records(recs_a, cnt_a, nb),),
        lambda: (m.R.expand_records_plain(recs_a, cnt_a, nb),),
        f"records {tuple(recs_a.shape)}, {n_dec} used",
        4 * n_dec + 4 * N_FRAMES + N_FRAMES * nb * 128, OPS_SCATTER * n_dec)
    extra("R+X", [(lv_x, lv_a)], f"{N_FRAMES} frames: kernel D's levels "
          f"({int(st_a[:, 1].sum())} records, at most "
          f"{int(st_a[:, 1].max())} a frame)")
    del recs_a, lv_x
    # P on the record encoder's records of the re-encode levels, and its
    # words against kernel E's
    recs_p, tot_p, _, ok_p = m.R.tokenize_levels(lv2_a, t_rec)
    assert ok_p.all()
    n_rec = int(tot_p.sum())
    words_p, bits_p = check(
        "P", lambda: m.RP.pack_records(recs_p, tot_p, wb),
        lambda: m.RP.pack_records_plain(recs_p, tot_p, wb),
        f"records {tuple(recs_p.shape)}, w_out {wb}",
        lambda got: 4 * n_rec + 4 * N_FRAMES + N_FRAMES * (
            4 * ((int(got[1].max()) + 31) // 32) + 4), OPS_RECORD * n_rec)
    assert not words_p[:, w_used:].any()
    extra("P vs E", [(words_p[:, :w_used], words_e), (bits_p, bits_e)],
          f"{N_FRAMES} frames ({n_rec} records): kernel E's words and bits")
    del lv2_a, words_e, pix_i, deq, words_p
    ysrc = [torch.from_numpy(p).to(dev) for p in pics]
    blocks = m.amv_video.extract_blocks(*ysrc, (W + 15) // 16,
                                        (H + 15) // 16).reshape(-1, 64)
    check("F", lambda: (m.fdct.fdct_quant_blocks(blocks, qmat),),
          lambda: (m.fdct.fdct_quantize_plain(blocks, qmat)[
              :, torch.as_tensor(m.jpeg_tables.ZIGZAG,
                                 device=dev).long()],),
          f"{blocks.shape[0]} extracted blocks", blocks.shape[0] * (64 + 128),
          blocks.shape[0] * OPS_FDCT)
    check("F raster", lambda: (m.fdct.fdct_quantize(blocks.view(-1, 8, 8),
                                                    qmat),),
          lambda: (m.fdct.fdct_quantize_plain(blocks, qmat),),
          f"{blocks.shape[0]} extracted blocks (fdct_quantize's contract)",
          blocks.shape[0] * (64 + 128), blocks.shape[0] * OPS_FDCT)
    # U: the decode path's entry on the corpus levels and DC, un-sorting the
    # length-sorted batch as decode_frames does (8 bytes of dst a frame);
    # its contract entry on the same levels in raster order
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    plane_bytes = N_FRAMES * W * H * 3 // 2
    coded_bytes = N_FRAMES * n_mcu * 384             # 256 Y + 64 Cb + 64 Cr
    order_t = torch.from_numpy(order).to(dev)
    check("U", lambda: m.U.decode_planes(lvf, dc_a, W, H, dst=order_t),
          lambda: m.U.decode_planes_plain(lvf, dc_a, W, H, order_t),
          f"{n_blk} blocks -> {N_FRAMES} display frames {W}x{H}",
          n_blk * (128 + 4) + 8 * N_FRAMES + plane_bytes,
          n_blk * (OPS_DEQUANT + OPS_IDCT))
    zz = torch.as_tensor(m.jpeg_tables.ZIGZAG, device=dev).long()
    lv_ras = torch.empty_like(lvf)
    lv_ras[:, zz] = lvf
    lv_ras = lv_ras.view(N_FRAMES, n_mcu, 6, 64)
    dc4 = dc_a.view(N_FRAMES, n_mcu, 6)
    check("U coded", lambda: m.U.decode_fused(lv_ras, dc4, mb_w, mb_h),
          lambda: m.U.decode_fused_plain(lv_ras, dc4, mb_w, mb_h),
          f"{n_blk} raster blocks -> coded planes (decode_fused's contract)",
          n_blk * (128 + 4) + coded_bytes, n_blk * (OPS_DEQUANT + OPS_IDCT))
    del lv_ras
    # V: the encode path's entry on the raw corpus pictures with each
    # quantizer; its contract entry on their coded (flipped, padded) planes
    check("V", lambda: (m.V.encode_planes(*ysrc, QSCALE),),
          lambda: (m.V.encode_planes_plain(*ysrc, qmat),),
          f"{N_FRAMES} display frames {W}x{H} -> {n_blk} blocks, ffmpeg",
          plane_bytes + n_blk * 128, n_blk * OPS_FDCT)
    check("V q60", lambda: (m.V.encode_planes(*ysrc, QSCALE, "q60"),),
          lambda: (m.V.encode_planes_plain(*ysrc, qmat, "q60"),),
          f"{N_FRAMES} display frames {W}x{H} -> {n_blk} blocks, q60",
          plane_bytes + n_blk * 128, n_blk * OPS_FDCT_Q60)
    coded = [p.contiguous() for p in m.U.coded_planes(
        blocks.view(N_FRAMES, n_mcu, 6, 8, 8), mb_w, mb_h)]
    check("V coded", lambda: (m.V.encode_fused(*coded, mb_w, mb_h, QSCALE),),
          lambda: (m.V.encode_fused_plain(*coded, mb_w, mb_h, qmat),),
          f"coded planes of {N_FRAMES} frames (encode_fused's contract)",
          coded_bytes + n_blk * 128, n_blk * OPS_FDCT)
    pay_np, pred_np, sidx_np, alens = m.amv_audio.chunk_arrays(audio)
    pay_t, pred_t, sidx_t = (torch.from_numpy(a).to(dev)
                             for a in (pay_np, pred_np, sidx_np))
    c_a, nby = pay_t.shape
    check("A", lambda: (m.adpcm.decode_chunks(pay_t, pred_t, sidx_t),),
          lambda: (m.adpcm.decode_chunks_plain(pay_t, pred_t, sidx_t),),
          f"{c_a} chunks x {nby} bytes", c_a * (nby + 8 + 4 * nby),
          c_a * 2 * nby * OPS_EXPAND)
    wrap_samples = c_a * WRAP * 2 * nby
    check("A wrap", lambda: (m.adpcm.decode_chunks(pay_t, pred_t, sidx_t,
                                                   repeat=WRAP),),
          lambda: (m.adpcm.decode_chunks_plain(pay_t, pred_t, sidx_t,
                                               repeat=WRAP),),
          f"repeat={WRAP}, {wrap_samples} samples",
          c_a * (nby + 8) + 2 * wrap_samples, wrap_samples * OPS_EXPAND)
    log(f"A wrap: {wrap_samples / kern['A wrap']['ms'] / 1e3:.1f} "
        "Msamples/s (median, CUDA events)")
    frame_size = m.encode.av_rescale_near(RATE, 1, FPS)
    ns, starts, padded, reset = m.amv_audio.stream_layout(pcm, frame_size,
                                                          RATE)
    x_q = torch.from_numpy(padded[None]).to(dev)
    r_q = torch.from_numpy(reset[None]).to(dev)
    s_q = torch.zeros(1, dtype=torch.int32, device=dev)
    n_q = padded.shape[0]
    check("Q", lambda: m.adpcm.encode_streams(x_q, r_q, s_q),
          lambda: m.adpcm.encode_streams_plain(x_q, r_q, s_q),
          f"1 stream x {n_q} samples, {len(ns)} chunks",
          2 * n_q + n_q + 4 + n_q, n_q * OPS_COMPRESS)
    check("Q wrap", lambda: m.adpcm.encode_streams(x_q, r_q, s_q,
                                                   repeat=Q_WRAP),
          lambda: m.adpcm.encode_streams_plain(x_q, r_q, s_q, repeat=Q_WRAP),
          f"repeat={Q_WRAP}, {Q_WRAP * n_q} samples",
          2 * n_q + n_q + 4 + Q_WRAP * n_q, Q_WRAP * n_q * OPS_COMPRESS)
    # Q's passes on the stream, and one chunk alone (one segment: the
    # latency of one serial walk, which sets Q's floor, not its bytes)
    n1 = 2 * ns[0]
    x1, r1 = x_q[:, :n1], r_q[:, :n1]
    kern["Q"]["passes_ms"] = q_passes(
        lambda: m.adpcm.encode_streams(x_q, r_q, s_q))
    kern["Q"]["one_chunk_ms"] = cuda_ms(
        lambda: m.adpcm.encode_streams(x1, r1, s_q), 10)[0]
    one = q_passes(lambda: m.adpcm.encode_streams(x1, r1, s_q))
    log("Q passes at 1 stream x {} samples (device ms a call, "
        "torch.profiler): {}; one chunk of {} samples alone {:.4f} ms "
        "(passes {}) beside the stream's byte bound {:.4f} ms".format(
            n_q, ", ".join(f"{k} {v:.4f}" for k, v in
                           kern["Q"]["passes_ms"].items()), n1,
            kern["Q"]["one_chunk_ms"], ", ".join(
                f"{k} {v:.4f}" for k, v in one.items()),
            kern["Q"]["bound_ms"]))
    log(f"V at {N_FRAMES} frames {W}x{H}: ffmpeg {kern['V']['ms']:.3f} ms, "
        f"q60 {kern['V q60']['ms']:.3f} ms, contract entry "
        f"{kern['V coded']['ms']:.3f} ms (median, CUDA events)")

    # extra cases on N_CHECK corpus frames: malformed scans for D, T without
    # edge replication, E with a word budget every frame overflows, I on
    # DC-only blocks, F at qscale 1
    rng = np.random.default_rng(1)
    rows, lens = m.native.unescape_frames(pays[:N_CHECK])
    bad = rows[:8].copy()
    bad_lens = lens[:8].copy()
    bad[0] = rng.integers(0, 256, bad.shape[1])            # random bytes
    bad[1, 100:108] = 0xFF                                 # invalid code
    bad_lens[2] //= 3                                      # truncated
    bad_lens[3] = 0                                        # empty
    bad[4, 7::97] = rng.integers(0, 256, len(bad[4, 7::97]))
    rows_t = torch.from_numpy(np.concatenate([rows, bad])).to(dev)
    lens_t = torch.from_numpy(np.concatenate([lens, bad_lens])).to(dev)
    lv_k, ok_k = m.D.decode_scans(rows_t, lens_t, nb)
    lv_p, ok_p = m.D.decode_scans_plain(rows_t, lens_t, nb)
    extra("D extra", [(lv_k, lv_p), (ok_k, ok_p)],
          f"{N_CHECK} frames + 8 malformed (ok {ok_k[N_CHECK:].tolist()})")
    assert ok_k[:N_CHECK].all() and not ok_k[N_CHECK + 1], ok_k[N_CHECK:]
    for name, r_c, l_c, b_c in d_cases(m, rows[:N_PAD], lens[:N_PAD], nb,
                                        rng):
        rt_c = torch.from_numpy(r_c).to(dev)
        lt_c = torch.from_numpy(l_c).to(dev)
        kw = {} if b_c is None else {"budget": b_c.to(dev)}
        got = m.D.decode_scans(rt_c, lt_c, nb, **kw)
        extra(f"D {name}", zip(got, m.D.decode_scans_plain(rt_c, lt_c, nb,
                                                           **kw)),
              f"{N_PAD} corpus scans, {name} (ok {int(got[1].sum())} of "
              f"{N_PAD}; sync rounds max {int(m.D.LAST_ROUNDS.max())})")
        if name.startswith("fail") or name == "budget":
            assert not got[1][::2].any() and got[1][1::2].all(), name
    t_def = m.R.default_t_max(nb, rows_t.shape[1])
    rec_k = m.R.decode_records(rows_t, lens_t, nb, t_def)
    rec_p = m.R.decode_records_plain(rows_t, lens_t, nb, t_def)
    extra("R extra", zip(rec_k, rec_p),
          f"{N_CHECK} frames + 8 malformed in JAX's default budget of "
          f"{t_def} records ({int((rec_k[1][:, 0] < nb).sum())} frames not "
          "done)")
    extra("X extra", [(m.R.expand_records(rec_k[0], rec_k[1][:, 1]
                                          .contiguous(), nb),
                       m.R.expand_records_plain(rec_p[0], rec_p[1][:, 1], nb))],
          "those records")
    extra("P extra", zip(m.RP.pack_records(recs_p[:N_CHECK],
                                           tot_p[:N_CHECK], 16),
                         m.RP.pack_records_plain(recs_p[:N_CHECK],
                                                 tot_p[:N_CHECK], 16)),
          f"{N_CHECK} frames at w_out 16 (every frame overflows)")
    del rec_k, rec_p, recs_p

    lv = lv_k[:N_CHECK].reshape(-1, 64)
    dc = m.amv_video.resolve_dc(
        lv_k[:N_CHECK].reshape(N_CHECK, n_mcu, 6, 64)).reshape(-1)
    want_lv, want_pix = m.T.transcode_blocks_plain(
        lv, dc, qmat, m.T._geometry(None, lv.shape[0]))
    got_lv, got_pix = m.T.transcode_blocks_pix(lv, dc, qmat, None)
    got_lv2 = m.T.transcode_blocks(lv, dc, qmat, None)
    extra("T extra", [(got_lv, want_lv), (got_pix, want_pix),
                      (got_lv2, want_lv)],
          f"{lv.shape[0]} blocks, both entries, without edge replication")

    lv2 = m.T.transcode_blocks(lv, dc, qmat, (W, H)).reshape(N_CHECK, nb, 64)
    got = m.E.encode_levels(lv2, 16)
    extra("E extra", zip(got, m.E.encode_levels_plain(lv2, 16)),
          f"{N_CHECK} frames at w_out 16 (every frame overflows, ok = 0)")
    assert not got[2].any(), "a 16-word budget must overflow"
    for target in (0, 1):
        lv_f, bits_f = e_fit(m, lv2[:8], target)
        pairs = []
        for w_out in (bits_f // 32, bits_f // 32 + 1):
            got = m.E.encode_levels(lv_f, w_out)
            pairs += zip(got, m.E.encode_levels_plain(lv_f, w_out))
            assert bool(got[2][0]) == (target == 0 or w_out > bits_f // 32)
        extra("E fit", pairs, f"a frame of {bits_f} bits at w_out "
              f"{bits_f // 32} and {bits_f // 32 + 1}")
    got = m.E.encode_levels(lv2[:N_PAD], 30000)
    extra("E unstaged", zip(got, m.E.encode_levels_plain(lv2[:N_PAD],
                                                         30000)),
          f"{N_PAD} frames at w_out 30,000 (120 KB: words ORed in device "
          "memory)")

    lv_dc = lv.clone()
    lv_dc[:, 1:] = 0
    extra("I extra", [(m.idct.idct_blocks(lv_dc, dc),
                       m.idct.idct_blocks_plain(lv_dc, dc)),
                      (m.idct.idct_put(lv.reshape(-1, 8, 8)),
                       m.idct.idct_put_plain(lv).reshape(-1, 8, 8))],
          f"{lv.shape[0]} DC-only blocks, and the raw idct_put entry")
    q1 = m.amv_video.encoder_qmat(1)
    fb = blocks[:N_CHECK * nb]
    extra("F extra", [(m.fdct.fdct_quantize(fb.reshape(-1, 8, 8), q1),
                       m.fdct.fdct_quantize_plain(fb, q1))],
          f"{fb.shape[0]} blocks at qscale 1 (wrapping products), raster "
          "entry")
    del blocks, fb
    fp = [p[:N_CHECK] for p in ysrc]
    extra("V extra", [(m.V.encode_planes(*fp, 1), m.V.encode_planes_plain(
        *fp, q1)), (m.V.encode_fused(*(c[:N_CHECK] for c in coded), mb_w,
                                     mb_h, 1),
                     m.V.encode_fused_plain(*(c[:N_CHECK] for c in coded),
                                            mb_w, mb_h, q1))],
          f"{N_CHECK} frames at qscale 1, both entries")
    del coded, fp
    flat = []
    for val in (0, 255, 128, 13):
        fl = [torch.full((16, hh, ww), v, dtype=torch.uint8, device=dev)
              for (hh, ww), v in (((H, W), val), ((H // 2, W // 2), 255 - val),
                                  ((H // 2, W // 2), val))]
        flat.append((m.V.encode_planes(*fl, QSCALE, "q60"),
                     m.V.encode_planes_plain(*fl, qmat, "q60")))
    extra("V q60 flat", flat, "16 flat frames at each of luma 0, 255, 128 "
          "and 13 under q60 (the DC chain at the clip rails)")
    for sw, sh in ((W_PAD, H), (ODD_W, ODD_H)):
        smw, smh = (sw + 15) // 16, (sh + 15) // 16
        n_s = N_PAD * smw * smh * 6
        lv_s = torch.from_numpy(rand_levels(rng, n_s)).to(dev)
        dc_s = torch.from_numpy(rng.integers(-40000, 40000, n_s)
                                .astype(np.int32)).to(dev)
        perm = torch.from_numpy(rng.permutation(N_PAD)).to(dev)
        pairs = list(zip(m.U.decode_planes(lv_s, dc_s, sw, sh, dst=perm),
                         m.U.decode_planes_plain(lv_s, dc_s, sw, sh, perm)))
        lv4, dc3 = lv_s.view(N_PAD, -1, 6, 64), dc_s.view(N_PAD, -1, 6)
        pairs += list(zip(m.U.decode_fused(lv4, dc3, smw, smh),
                          m.U.decode_fused_plain(lv4, dc3, smw, smh)))
        extra(f"U {sw}x{sh}", pairs, f"{N_PAD} frames of random levels, "
              "both entries")
        if m.T.takes_size((sw, sh)):
            geom_s = m.T._geometry((sw, sh), n_s)
            want = m.T.transcode_blocks_plain(lv_s, dc_s, qmat, geom_s)
            extra(f"T {sw}x{sh}", list(zip(
                m.T.transcode_blocks_pix(lv_s, dc_s, qmat, (sw, sh)), want))
                + [(m.T.transcode_blocks(lv_s, dc_s, qmat, (sw, sh)),
                    want[0])], f"{N_PAD} frames of random levels, both "
                  "entries (pad columns and rows)")
        ps = [torch.from_numpy(p).to(dev)
              for p in pictures(m, N_PAD, sh, sw, seed=sw)]
        cs = [p.contiguous() for p in m.U.coded_planes(m.V.extract_blocks(
            *ps, smw, smh), smw, smh)]
        extra(f"V {sw}x{sh}", [
            (m.V.encode_planes(*ps, QSCALE), m.V.encode_planes_plain(
                *ps, qmat)),
            (m.V.encode_planes(*ps, QSCALE, "q60"),
             m.V.encode_planes_plain(*ps, qmat, "q60")),
            (m.V.encode_fused(*cs, smw, smh, QSCALE),
             m.V.encode_fused_plain(*cs, smw, smh, qmat))],
            f"{N_PAD} pictures, both quantizers and the contract entry")
    lv_e = [torch.cat([k for k, _ in flat])]
    for sw, sh in ((320, 240), (ODD_W, ODD_H)):
        lv_e.append(m.V.encode_planes(*(torch.from_numpy(p).to(dev) for p in
                                        pictures(m, N_PAD, sh, sw, seed=sh)),
                                      QSCALE))
    pairs = []
    for lv_s in lv_e:
        bits_s = m.E.count_bits(lv_s)
        w_s = (int(bits_s.max()) + 31) // 32
        pairs += [(bits_s, m.E.count_bits_plain(lv_s))]
        pairs += zip(m.E.encode_levels(lv_s, w_s),
                     m.E.encode_levels_plain(lv_s, w_s))
    extra("E sizes", pairs, "the q60 flat frames, 320x240 and "
          f"{ODD_W}x{ODD_H} pictures, count and pack at the exact budget")
    del flat, lv_s, dc_s, lv4, dc3, ps, cs, lv_e
    stress = []
    for byte, sidx in ((0x77, sidx_t), (0xFF, torch.full_like(sidx_t, 88)),
                       (0x88, sidx_t)):
        p_s = torch.full_like(pay_t, byte)
        stress.append((m.adpcm.decode_chunks(p_s, pred_t, sidx),
                       m.adpcm.decode_chunks_plain(p_s, pred_t, sidx)))
    extra("A extra", stress, f"{c_a} chunks of all 0x77, of all 0xFF at "
          "step index 88, and of all 0x88 (clamp stress)")
    n10 = 2 * sum(ns[:160])                    # the first 10 s of chunks
    x10, r10 = x_q[:, :n10], r_q[:, :n10].clone()
    r10[:, 0] = False
    pairs = list(zip(m.adpcm.encode_streams(x10, r10, s_q),
                     m.adpcm.encode_streams_plain(x10, r10, s_q)))
    s88 = torch.full_like(s_q, 88)
    pairs += list(zip(m.adpcm.encode_streams(x10, r_q[:, :n10], s88),
                      m.adpcm.encode_streams_plain(x10, r_q[:, :n10], s88)))
    n2 = 2 * sum(ns[:32])                      # 2 s as one segment
    r2 = torch.zeros_like(r_q[:, :n2])
    r2[:, 0] = True
    pairs += list(zip(m.adpcm.encode_streams(x_q[:, :n2], r2, s_q),
                      m.adpcm.encode_streams_plain(x_q[:, :n2], r2, s_q)))
    extra("Q extra", pairs, f"{n10} samples with no reset at sample 0, and "
          f"from step index 88; {n2} samples as one segment")
    del lv_a, lvf, dc_a, ok_a, ysrc, x_q, r_q, stress, pairs
    torch.cuda.empty_cache()
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5. the transcode through the CLI -------------------------
        want = c_transcode(m, pays, W, H)
        src, dst = os.path.join(tmp, "in.amv"), os.path.join(tmp, "out.amv")
        with open(src, "wb") as f:
            f.write(data)
        m.P.transcode_bytes(data, qscale=QSCALE, device="cuda")   # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall, walls = timed_cli(m, ["-i", src, "-f", "amv", dst,
                                    "--device", "cuda"])
        paths["transcode"] = launches(m)
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())
        assert out.video_chunks == want, "video differs from the C reference"
        ff_bytes = {"encode": sum(map(len, pays)),
                    "transcode": sum(map(len, want))}
        assert out.audio_chunks == audio, "audio did not pass through"
        assert all(paths["transcode"][k] > 0 for k in "DTE"), paths
        log(f"transcode: cli.main x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s"
            f" = {N_FRAMES / wall:.1f} frames/s; byte-identical to the C "
            f"reference, audio passed through; launches {paths['transcode']}")
        split = {}
        s = staged(split, "demux", lambda: m.riff.demux(data))
        rows_s, lens_s = staged(split, "unescape", lambda: (
            m.native.unescape_frames(s.video_chunks)))
        order = staged(split, "sort", lambda: np.argsort(
            np.array([len(p) for p in s.video_chunks]), kind="stable"))
        r_t, l_t = staged(split, "to_device", lambda: (
            torch.from_numpy(rows_s[order]).to(dev),
            torch.from_numpy(lens_s[order]).to(dev)))
        words, bits, ok = staged(split, "device_chain", lambda: (
            m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE, (W, H))))
        inv = np.argsort(order)
        w_np, b_np = staged(split, "to_host", lambda: (
            words.cpu().numpy()[inv], bits.cpu().numpy()[inv]))
        vch = staged(split, "escape", lambda: m.native.escape_frames(
            w_np, b_np))
        staged(split, "mux", lambda: m.riff.mux(
            vch, s.audio_chunks, width=W, height=H, fps=FPS,
            sample_rate=RATE))
        assert vch == want
        log_split("transcode", split,
                  f"; words copied to the host {tuple(words.shape)}")

        # ---- 5b. the record decode, and the transcode's encoders -------
        torch.cuda.synchronize()
        reset_launches(m)
        lv_r, ok_r = m.R.decode_scans_async(r_t, l_t, nb, t_rec)
        torch.cuda.synchronize()
        paths["record decode"] = launches(m)
        lv_d, _ = m.D.decode_scans(r_t, l_t, nb)
        assert ok_r.all() and torch.equal(lv_r, lv_d)
        assert all(paths["record decode"][k] > 0 for k in "RX"), paths
        lv_def, ok_def = m.R.decode_scans_async(r_t, l_t, nb)
        good = ok_def.bool()
        assert torch.equal(lv_def[good], lv_d[good])
        log(f"record decode: decode_scans_async over {N_FRAMES} frames in a "
            f"budget of {t_rec} records a frame: levels equal to kernel D's;"
            f" in JAX's default budget ({m.R.default_t_max(nb, r_t.shape[1])}"
            f") {int((~good).sum())} frames run out (ok 0) and the rest "
            f"equal D's; launches {paths['record decode']}")
        del lv_r, lv_d, lv_def
        chain = {enc: [] for enc in m.P.ENCODERS}
        for enc in m.P.ENCODERS:                 # counted, and the warm-up
            reset_launches(m)
            words, bits, ok = m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE,
                                                     (W, H), enc=enc)
            torch.cuda.synchronize()
            paths[f"transcode {enc}"] = launches(m)
            assert ok.all()
            assert m.native.escape_frames(words.cpu().numpy()[inv],
                                          bits.cpu().numpy()[inv]) == want, \
                f"enc={enc}: bytes differ from the C reference"
        for _ in range(3):                   # interleaved passes
            for enc in m.P.ENCODERS:
                t0 = time.perf_counter()
                m.P.transcode_complete(r_t, l_t, n_mcu, QSCALE, (W, H),
                                       enc=enc)
                torch.cuda.synchronize()
                chain[enc].append(time.perf_counter() - t0)
        for enc in m.P.ENCODERS[1:]:
            got = paths[f"transcode {enc}"]
            assert got["E"] == 0 and got["D"] > 0 and got["T"] > 0, (enc, got)
            assert (got["P"] > 0) == (enc != "parallel"), (enc, got)
        log("transcode device chain by entropy encoder (transcode_complete, "
            f"{N_FRAMES} frames, median of 3 interleaved passes, host clock "
            "after a synchronize): " + ", ".join(
                f"{enc} {statistics.median(chain[enc]) * 1e3:.1f} ms" for enc
                in m.P.ENCODERS) + "; every encoder's bytes equal the C "
            "reference; launches " + "; ".join(
                f"{enc} {paths[f'transcode {enc}']}" for enc in m.P.ENCODERS))
        # the encoders alone on the chain's re-encode levels, and the torch
        # stages of the record routes (median of 3, CUDA events)
        lv_c, _ = m.D.decode_scans(r_t, l_t, nb)
        dc_c = m.amv_video.resolve_dc(lv_c.reshape(-1, n_mcu, 6, 64))
        lv2_c = m.T.transcode_blocks(lv_c.reshape(-1, 64), dc_c.reshape(-1),
                                     qmat, (W, H)).reshape(lv_c.shape)
        wb_c = m.P.word_budget(r_t)
        stage = {f"encode_route {enc}": cuda_ms(
            lambda: m.P.encode_route(lv2_c, wb_c, enc), 3)[0]
            for enc in m.P.ENCODERS}
        stage["tokenize_levels"] = cuda_ms(
            lambda: m.R.tokenize_levels(lv2_c, t_rec), 3)[0]
        stage["rechunk_records"] = cuda_ms(
            lambda: m.EP.rechunk_records(lv2_c, None), 3)[0]
        def slot_pass():
            for a, b in m.EP.frame_chunks(N_FRAMES, nb):
                m.EP.slot_records(lv2_c[a:b])

        stage["slot_records"] = cuda_ms(slot_pass, 3)[0]
        log("encoders alone on the re-encode levels (median of 3, CUDA "
            "events): " + ", ".join(f"{k} {v:.2f} ms"
                                    for k, v in stage.items()))
        del lv_c, dc_c, lv2_c
        del want, words, r_t, l_t

        # ---- 6. the decode through the CLI ----------------------------
        yuv, wavp = os.path.join(tmp, "out.yuv"), os.path.join(tmp, "out.wav")
        m.decode.decode_bytes(data, device="cuda")                  # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall_v, walls_v = timed_cli(m, ["-i", src, yuv, "--device", "cuda"])
        paths["decode video"] = launches(m)
        reset_launches(m)
        wall_a, walls_a = timed_cli(m, ["-i", src, wavp, "--device", "cuda"])
        paths["decode audio"] = launches(m)
        assert paths["decode video"]["D"] > 0 and \
            paths["decode video"]["U"] > 0 and \
            paths["decode video"]["I"] == 0, paths
        assert paths["decode audio"]["A"] > 0, paths
        fbytes = W * H * 3 // 2
        raw = np.fromfile(yuv, np.uint8).reshape(N_FRAMES, fbytes)
        c_decode_matches(m, pays, W, H,
                         raw[:, :W * H].reshape(-1, H, W),
                         raw[:, W * H:W * H * 5 // 4].reshape(-1, H // 2, W // 2),
                         raw[:, W * H * 5 // 4:].reshape(-1, H // 2, W // 2))
        got_pcm, rate = m.wav.read_pcm(wavp)
        assert rate == RATE
        pos = 0
        for i in range(len(audio)):
            ref = m.native.ref_adpcm_decode(bytes(pay_np[i, :alens[i]]),
                                            int(pred_np[i]), int(sidx_np[i]))
            assert np.array_equal(got_pcm[pos:pos + len(ref)], ref), i
            pos += len(ref)
        assert pos == len(got_pcm)
        log(f"decode video: cli.main -> .yuv x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls_v)} s, median "
            f"{wall_v:.3f} s = {N_FRAMES / wall_v:.1f} frames/s; every frame "
            f"byte-identical to the C decoder; launches "
            f"{paths['decode video']}")
        log(f"decode audio: cli.main -> .wav x3, {len(got_pcm)} samples in "
            f"{', '.join(f'{t:.3f}' for t in walls_a)} s, median "
            f"{wall_a:.3f} s = {len(got_pcm) / wall_a / 1e6:.2f} Msamples/s; "
            f"identical to the C ADPCM decoder chunk by chunk; launches "
            f"{paths['decode audio']}")
        split = {}
        s = staged(split, "demux", lambda: m.riff.demux(data))
        rows_s, lens_s = staged(split, "unescape", lambda: (
            m.native.unescape_frames(s.video_chunks)))
        order = staged(split, "sort", lambda: np.argsort(
            np.array([len(p) for p in s.video_chunks]), kind="stable"))
        r_t, l_t = staged(split, "to_device", lambda: (
            torch.from_numpy(rows_s[order]).to(dev),
            torch.from_numpy(lens_s[order]).to(dev)))

        def decode_chain():
            lv, _ = m.D.decode_scans(r_t, l_t, nb)
            dc = m.amv_video.resolve_dc(lv.reshape(N_FRAMES, n_mcu, 6, 64))
            return m.U.decode_planes(lv.reshape(-1, 64), dc.reshape(-1), W, H,
                                     dst=torch.from_numpy(order).to(dev))

        planes = staged(split, "device_chain", decode_chain)
        staged(split, "to_host", lambda: [p.cpu().numpy() for p in planes])
        arrs = staged(split, "audio_headers",
                      lambda: m.amv_audio.chunk_arrays(s.audio_chunks))
        ta = staged(split, "audio_to_device", lambda: [
            torch.from_numpy(a).to(dev) for a in arrs[:3]])
        pcm_t = staged(split, "device_A", lambda: m.adpcm.decode_chunks(*ta))
        staged(split, "audio_to_host", lambda: pcm_t.cpu().numpy())
        log_split("decode", split)
        # the transform before this slice (kernel I, the un-sort gather and
        # the assembly copies) against kernel U, alone and in the chain
        lv_c, _ = m.D.decode_scans(r_t, l_t, nb)
        lv_c = lv_c.reshape(-1, 64)
        dc_c = m.amv_video.resolve_dc(
            lv_c.view(N_FRAMES, n_mcu, 6, 64)).reshape(-1)
        inv_t = torch.from_numpy(np.argsort(order)).to(dev)
        ord_t = torch.from_numpy(order).to(dev)

        def transform_i():
            pix = m.idct.idct_blocks(lv_c, dc_c)
            return m.amv_video.assemble_planes(
                pix.reshape(N_FRAMES, n_mcu, 6, 8, 8)[inv_t], mb_w, mb_h, W, H)

        def chain_i():
            lv, _ = m.D.decode_scans(r_t, l_t, nb)
            dc = m.amv_video.resolve_dc(lv.reshape(N_FRAMES, n_mcu, 6, 64))
            pix = m.idct.idct_blocks(lv.reshape(-1, 64), dc.reshape(-1))
            return m.amv_video.assemble_planes(
                pix.reshape(N_FRAMES, n_mcu, 6, 8, 8)[inv_t], mb_w, mb_h, W, H)

        assert all(torch.equal(a, b) for a, b in zip(transform_i(), planes))
        cmp = interleaved({
            "I + assembly": transform_i,
            "U": lambda: m.U.decode_planes(lv_c, dc_c, W, H, dst=ord_t),
            "chain D, I": chain_i, "chain D, U": decode_chain})
        log("decode transform, before (I, un-sort gather, assembly) and "
            "after (U), interleaved, median of 4 (CUDA events, ms): " +
            ", ".join(f"{k} {v:.3f}" for k, v in cmp.items()))
        src_y = raw[:, :W * H].reshape(-1, H, W).copy()
        del planes, pcm_t, r_t, l_t, raw, lv_c, dc_c

        # ---- 7. the encode through the CLI ----------------------------
        yin, win = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "in.wav")
        np.concatenate([p.reshape(N_FRAMES, -1) for p in pics],
                       axis=1).tofile(yin)
        m.wav.write_pcm(win, pcm, RATE)
        m.encode.encode_to_bytes(*(p[:16] for p in pics), pcm[:RATE],
                                 device="cuda")                    # warm-up
        torch.cuda.synchronize()
        reset_launches(m)
        wall_e, walls_e = timed_cli(m, [
            "-i", yin, "-i", win, "-f", "amv", "-s", f"{W}x{H}", "-r",
            str(FPS), "-ar", str(RATE), dst, "--device", "cuda"])
        paths["encode"] = launches(m)
        assert all(paths["encode"][k] > 0 for k in "VEQ") and \
            paths["encode"]["F"] == 0, paths
        with open(dst, "rb") as f:
            out = m.riff.demux(f.read())
        assert out.video_chunks == pays, "video differs from the C encoder"
        t0 = time.perf_counter()
        want_audio = m.ref_adpcm.encode(pcm, frame_size, RATE)
        t_oracle = time.perf_counter() - t0
        assert out.audio_chunks == want_audio, "audio differs from the oracle"
        log(f"encode: cli.main from .yuv + .wav x3, {N_FRAMES} frames + "
            f"{len(pcm)} samples in {', '.join(f'{t:.3f}' for t in walls_e)}"
            f" s, median {wall_e:.3f} s = {N_FRAMES / wall_e:.1f} frames/s; "
            f"video byte-identical to the C encoder, {len(want_audio)} audio "
            f"chunks to the Python ADPCM oracle (which took {t_oracle:.1f} "
            f"s); launches {paths['encode']}")
        split = {}
        planes = staged(split, "to_device", lambda: [
            torch.from_numpy(p).to(dev) for p in pics])

        def encode_chain():
            return m.amv_video.pack_levels(
                m.V.encode_planes(*planes, QSCALE))

        words, bits = staged(split, "device_chain", encode_chain)
        w_np, b_np = staged(split, "to_host", lambda: (
            words.cpu().numpy(), bits.cpu().numpy()))
        vch = staged(split, "escape", lambda: m.native.escape_frames(
            w_np, b_np))
        lay = staged(split, "audio_layout", lambda: (
            m.amv_audio.stream_layout(pcm, frame_size, RATE)))
        tq = staged(split, "audio_to_device", lambda: [
            torch.from_numpy(a[None]).to(dev) for a in lay[2:]])
        bq = staged(split, "device_Q", lambda: m.adpcm.encode_streams(
            *tq, s_q))
        staged(split, "audio_to_host", lambda: [t.cpu().numpy() for t in bq])
        staged(split, "mux", lambda: m.riff.mux(
            vch, want_audio, width=W, height=H, fps=FPS, sample_rate=RATE))
        assert vch == pays
        t_audio = sum(v for k, v in split.items() if "audio" in k or
                      k == "device_Q")
        log_split("encode", split,
                  f"; words copied to the host {tuple(words.shape)}; audio "
                  f"stages {len(pcm) / t_audio / 1e6:.2f} Msamples/s")

        # the transform before this slice (extraction copies and kernel F)
        # against kernel V, alone and in the chain
        def transform_f():
            blk = m.amv_video.extract_blocks(*planes, mb_w, mb_h)
            return m.fdct.fdct_quant_blocks(blk.reshape(-1, 64), qmat)

        def chain_f():
            return m.amv_video.pack_levels(
                transform_f().reshape(N_FRAMES, nb, 64))

        assert torch.equal(transform_f().view(N_FRAMES, nb, 64),
                           m.V.encode_planes(*planes, QSCALE))
        cmp = interleaved({
            "extraction + F": transform_f,
            "V": lambda: m.V.encode_planes(*planes, QSCALE),
            "chain F, E": chain_f, "chain V, E": encode_chain})
        log("encode transform, before (extraction, F) and after (V), "
            "interleaved, median of 4 (CUDA events, ms): " +
            ", ".join(f"{k} {v:.3f}" for k, v in cmp.items()))
        z = [np.zeros((0, H, W), np.uint8)] + 2 * [np.zeros(
            (0, H // 2, W // 2), np.uint8)]
        for quant in m.V.QUANTS:
            got = m.encode.encode_to_bytes(*z, np.zeros(0, np.int16),
                                           quant=quant, device="cuda")
            torch.cuda.synchronize()
            assert got == m.encode.encode_to_bytes(
                *z, np.zeros(0, np.int16), quant=quant, device="cpu")
        log(f"zero-frame encode on the card ({len(got)} bytes, ffmpeg and "
            "q60): equal to the CPU route")
        del planes, words, tq, bq

        # ---- 8. q60 through the CLI -------------------------------------
        q60e = os.path.join(tmp, "q60.amv")
        q60t = os.path.join(tmp, "q60t.amv")
        enc_argv = ["-i", yin, "-i", win, "-f", "amv", "-s", f"{W}x{H}", "-r",
                    str(FPS), "-ar", str(RATE), "-amv_quant", "q60", q60e,
                    "--device", "cuda"]
        tr_argv = ["-i", src, "-f", "amv", "-amv_quant", "q60", q60t,
                   "--device", "cuda"]
        m.cli.main(enc_argv)                                        # warm-up
        m.cli.main(tr_argv)
        torch.cuda.synchronize()
        reset_launches(m)
        wall_qe, walls_qe = timed_cli(m, enc_argv)
        paths["encode q60"] = launches(m)
        reset_launches(m)
        wall_qt, walls_qt = timed_cli(m, tr_argv)
        paths["transcode q60"] = launches(m)
        assert all(paths["encode q60"][k] > 0 for k in "VEQ") and \
            paths["encode q60"]["F"] == 0, paths
        assert all(paths["transcode q60"][k] > 0 for k in "DUVE") and \
            paths["transcode q60"]["T"] == 0, paths
        with open(q60e, "rb") as f:
            qe = m.riff.demux(f.read())
        with open(q60t, "rb") as f:
            qt = m.riff.demux(f.read())
        assert qe.audio_chunks == want_audio and qt.audio_chunks == audio
        db = {}
        for what, got, ref in (("encode", qe, pics[0]),
                               ("transcode", qt, src_y)):
            dec = m.decode.decode_bytes(m.riff.mux(
                got.video_chunks, [], width=W, height=H, fps=FPS),
                device="cuda")
            c_decode_matches(m, got.video_chunks, W, H, dec.y, dec.cb, dec.cr)
            db[what] = psnr(ref, dec.y)
            assert db[what] >= 30.0, (what, db[what])
        assert qe.video_chunks[:N_CPU] == m.amv_video.encode_frames(
            *(p[:N_CPU] for p in pics), quant="q60", device="cpu"), \
            "q60 encode differs from the CPU route"
        cpu_t = m.riff.demux(m.P.transcode_bytes(m.riff.mux(
            pays[:N_CPU], [], width=W, height=H, fps=FPS), quant="q60",
            device="cpu")).video_chunks
        assert qt.video_chunks[:N_CPU] == cpu_t, \
            "q60 transcode differs from the CPU route"
        log(f"q60 encode: cli.main x3, {N_FRAMES} frames + {len(pcm)} samples"
            f" in {', '.join(f'{t:.3f}' for t in walls_qe)} s, median "
            f"{wall_qe:.3f} s = {N_FRAMES / wall_qe:.1f} frames/s; launches "
            f"{paths['encode q60']}")
        log(f"q60 transcode: cli.main x3, {N_FRAMES} frames in "
            f"{', '.join(f'{t:.3f}' for t in walls_qt)} s, median "
            f"{wall_qt:.3f} s = {N_FRAMES / wall_qt:.1f} frames/s; launches "
            f"{paths['transcode q60']}")
        log(f"q60: every payload decodes through the C decoder to the port's "
            f"planes; Y round trip {db['encode']:.2f} dB (encode, against the "
            f"pictures), {db['transcode']:.2f} dB (transcode, against the "
            f"source decode); the first {N_CPU} frames' bytes equal the "
            "port's CPU route; video bytes " + ", ".join(
                f"{k} {sum(map(len, q.video_chunks))} (ffmpeg qscale "
                f"{QSCALE}: {ff_bytes[k]})" for k, q in
                (("encode", qe), ("transcode", qt))))
        del qe, qt, src_y
    log(f"phases 5-8 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 9. width padding and an odd size ---------------------------
    pics_p = pictures(m, N_PAD, H, W_PAD, seed=3)
    pays_p = c_encode(m, pics_p)
    data_p = m.riff.mux(pays_p, [], width=W_PAD, height=H, fps=FPS)
    got = m.riff.demux(m.P.transcode_bytes(data_p, qscale=QSCALE,
                                           device="cuda")).video_chunks
    want_p = c_transcode(m, pays_p, W_PAD, H)
    assert got == want_p, f"{W_PAD}x{H} transcode"
    check_routes(m, pays_p, W_PAD, H, want_p)
    dec = m.decode.decode_bytes(data_p, device="cuda")
    c_decode_matches(m, pays_p, W_PAD, H, dec.y, dec.cb, dec.cr)
    assert m.amv_video.encode_frames(*pics_p, QSCALE, device="cuda") == \
        pays_p, f"{W_PAD}x{H} encode"
    log(f"{W_PAD}x{H}: {N_PAD} frames through the transcode (each entropy "
        "encoder), the decode and the encode, byte-identical to C")
    pics_o = pictures(m, N_PAD, ODD_H, ODD_W, seed=4)
    pays_o = c_encode(m, pics_o)
    data_o = m.riff.mux(pays_o, [], width=ODD_W, height=ODD_H, fps=FPS)
    reset_launches(m)
    got = m.riff.demux(m.P.transcode_bytes(data_o, qscale=QSCALE,
                                           device="cuda")).video_chunks
    odd = launches(m)
    assert all(odd[k] > 0 for k in "DUVE") and odd["T"] == 0, odd
    want_o = c_transcode(m, pays_o, ODD_W, ODD_H)
    assert got == want_o, f"{ODD_W}x{ODD_H} transcode"
    check_routes(m, pays_o, ODD_W, ODD_H, want_o)
    dec = m.decode.decode_bytes(data_o, device="cuda")
    c_decode_matches(m, pays_o, ODD_W, ODD_H, dec.y, dec.cb, dec.cr)
    assert m.amv_video.encode_frames(*pics_o, QSCALE, device="cuda") == \
        pays_o, f"{ODD_W}x{ODD_H} encode"
    assert m.P.transcode_bytes(data_o, quant="q60", device="cuda") == \
        m.P.transcode_bytes(data_o, quant="q60", device="cpu")
    assert m.amv_video.encode_frames(*pics_o, quant="q60", device="cuda") == \
        m.amv_video.encode_frames(*pics_o, quant="q60", device="cpu")
    log(f"{ODD_W}x{ODD_H}: {N_PAD} frames through the two-stage transcode "
        f"(each entropy encoder; launches {odd}), the decode and the "
        "encode, byte-identical to C; the q60 transcode and encode equal "
        "to the port's CPU route")

    # ---- 10. big frames ---------------------------------------------
    big = c_encode(m, pictures(m, 256, 240, 320, seed=2))
    big_data = m.riff.mux(big, [], width=320, height=240, fps=FPS)
    got = m.riff.demux(m.P.transcode_bytes(big_data, qscale=QSCALE,
                                           device="cuda")).video_chunks
    want_big = c_transcode(m, big, 320, 240)
    assert got == want_big, "320x240 differs"
    check_routes(m, big, 320, 240, want_big)
    log(f"320x240: 256 frames (payloads up to {max(len(p) for p in big)} "
        "bytes) byte-identical to the C reference, with each entropy "
        "encoder")
    log(f"total {time.perf_counter() - t_start:.1f} s after the imports")

    kernels = []
    for key, name, path, src, replaces in (
            ("D", "entropy_decode", "transcode", "entropy_decode.cu",
             "entropy_async_pallas.py:829"),
            ("T", "transcode", "transcode", "transcode.cu",
             "transcode_layout_pallas.py:207"),
            ("E", "entropy_encode", "transcode", "entropy_encode.cu",
             "entropy_encode_async_pallas.py:940"),
            ("I", "idct", "decode video", "idct.cu",
             "transcode_layout_pallas.py:136"),
            ("F", "fdct_quant", "encode", "fdct.cu",
             "transcode_layout_pallas.py:187"),
            ("A", "adpcm_decode", "decode audio", "adpcm_decode.cu",
             "adpcm_pallas.py:86"),
            ("Q", "adpcm_encode", "encode", "adpcm_encode.cu",
             "adpcm_encode_pallas.py:89"),
            ("R", "decode_records", "record decode", "entropy_decode.cu",
             "entropy_async_pallas.py:357"),
            ("X", "expand_records", "record decode", "record_expand.cu",
             "entropy_async_pallas.py:435"),
            ("P", "pack_records", "transcode record", "record_pack.cu",
             "entropy_encode_async_pallas.py:407"),
            ("U", "decode_fused", "decode video", "decode_fused.cu",
             "decode_fused_pallas.py:111"),
            ("V", "encode_fused", "encode", "encode_fused.cu",
             "encode_fused_pallas.py:67")):
        err = max(v for k, v in errs.items() if k.split()[0] == key)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"amv_tpu_torch/csrc/{src}",
            "replaces": f"amv_tpu/kernels/{replaces}",
            "launches": paths[path][key], "max_abs_err": err,
            "ms": kern[key]["ms"], "plain_ms": kern[key]["plain_ms"],
            "bound_ms": kern[key]["bound_ms"],
            "bound_by": kern[key]["bound_by"], "library_ms": None,
            **({"passes_ms": kern[key]["passes_ms"],
                "one_chunk_ms": kern[key]["one_chunk_ms"]} if key == "Q"
               else {"q60_ms": kern["V q60"]["ms"]} if key == "V"
               else {"pix_ms": kern["T pixel entry"]["ms"],
                     "deq_ms": kern["T deq entry"]["ms"],
                     "wrap_ms": kern["T wrap"]["ms"],
                     "sass_a_block": sass_t}
               if key == "T"
               else {"wrap_ms": kern["A wrap"]["ms"]} if key == "A"
               else {"raster_ms": kern["F raster"]["ms"]} if key == "F"
               else {"rounds": kern[key]["rounds"]} if key in ("D", "R")
               else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
