#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (amv_tpu_torch) on one NVIDIA GPU and check
its main path, the complete AMV->AMV transcode, end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
 1. the card: nvidia-smi name and power limit, torch.cuda required;
 2. build the three CUDA kernels from amv_tpu_torch/csrc (nvcc, sm_90a);
 3. a 160x120 corpus at the reference's canonical shape (16 fps, 22,050 Hz
    ADPCM audio): 4,800 frames (5 minutes) of seeded videogen/rotozoom
    pictures with noise, each C-encoded at qscale 2, muxed into an .amv;
 4. each kernel against its plain torch version on the card, bit-exact,
    at the main path's shapes (the whole corpus batch), with each one's
    median time (CUDA events) beside the plain version's; then extra
    cases on 512 corpus frames: malformed scans (decode), no edge
    replication (transcode), an overflowing word budget (encode);
 5. the main path through the user's entry point, amv_tpu_torch.cli.main:
    video byte-identical to the C reference transcode, audio passed
    through, every kernel launched, no host fallback; frames/s and the
    split between the device chain and the host stages;
 6. 256 frames at 320x240 through transcode_bytes, byte-identical to the
    C reference.
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

import numpy as np

N_FRAMES, W, H, FPS, RATE, QSCALE = 4800, 160, 120, 16, 22050, 2
N_CHECK = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(n, h, w, seed):
    """C-encoded payloads of n seeded frames: videogen and rotozoom
    pictures, interleaved in runs of 16, with +-3 luma noise."""
    from amv_tpu.native import entropy_native as native
    from amv_tpu.verify import fixtures
    rng = np.random.default_rng(seed)
    half = n // 2
    vg = fixtures.videogen(half, h, w, seed=seed)
    rz = fixtures.rotozoom(n - half, h, w)
    pays = []
    for i in range(n):
        src, k = (vg, i // 32 * 16 + i % 16) if (i // 16) % 2 == 0 else \
            (rz, i // 32 * 16 + i % 16)
        y = np.clip(src[0][k].astype(np.int16) +
                    rng.integers(-3, 4, src[0][k].shape), 0, 255)
        pays.append(native.ref_encode_frame(y.astype(np.uint8), src[1][k],
                                            src[2][k], QSCALE))
    return pays


def c_reference(pays, w, h):
    from amv_tpu.native import entropy_native as native
    return [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), QSCALE)
            for p in pays]


def cuda_ms(fn, reps):
    """(median milliseconds of fn() on the current stream (CUDA events)
    after one warm-up call, the last call's result)."""
    import torch
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

    from amv_tpu.containers import riff
    from amv_tpu.native import entropy_native as native
    from amv_tpu.verify import fixtures, ref_adpcm
    from amv_tpu_torch import cli
    from amv_tpu_torch.codecs.amv_video import encoder_qmat
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.kernels import entropy_decode as D
    from amv_tpu_torch.kernels import entropy_encode as E
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.pipeline import transcode as P
    assert "jax" not in sys.modules
    dev = torch.device("cuda")

    # ---- 2. build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # ---- 3. corpus --------------------------------------------------
    t0 = time.perf_counter()
    pays = corpus(N_FRAMES, H, W, seed=0)
    second = ref_adpcm.encode(fixtures.audiogen(1.0, RATE, seed=0),
                              round(RATE / FPS), RATE)
    audio = second * (N_FRAMES // FPS)
    data = riff.mux(pays, audio, width=W, height=H, fps=FPS,
                    sample_rate=RATE)
    sizes = sorted(len(p) for p in pays)
    log(f"corpus: {N_FRAMES} frames {W}x{H} qscale {QSCALE}, payload bytes "
        f"min {sizes[0]} median {sizes[len(sizes) // 2]} max {sizes[-1]}; "
        f"{len(audio)} audio chunks; {len(data)} bytes; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 4. kernels against their plain versions ---------------------
    # At the main path's shapes (the whole corpus, length-sorted, as
    # transcode_bytes hands it to transcode_complete): the outputs of each
    # kernel's last timed call are held against its plain version's.
    n_mcu = ((W + 15) // 16) * ((H + 15) // 16)
    nb = n_mcu * 6
    qmat = encoder_qmat(QSCALE)
    rows_all, lens_all = native.unescape_frames(pays)
    order = np.argsort([len(p) for p in pays], kind="stable")
    rows_a = torch.from_numpy(rows_all[order]).to(dev)
    lens_a = torch.from_numpy(lens_all[order]).to(dev)
    times, errs = {}, {}

    def check(key, kernel, plain, shape):
        kt, got = cuda_ms(kernel, 10)
        pt, want = cuda_ms(plain, 2)
        times[key], errs[key] = (kt, pt), max_abs_err(zip(got, want))
        assert errs[key] == 0, f"{key}: kernel differs from plain by {errs[key]}"
        log(f"{key} at {shape}: bit-exact vs plain (max_abs_err 0); kernel "
            f"{kt:.3f} ms, plain {pt:.3f} ms (median, CUDA events)")
        return got

    lv_a, ok_a = check(
        "D", lambda: D.decode_scans(rows_a, lens_a, nb),
        lambda: D.decode_scans_plain(rows_a, lens_a, nb),
        f"rows {tuple(rows_a.shape)}")
    assert ok_a.all()
    dc_a = P.resolve_dc(lv_a.reshape(N_FRAMES, n_mcu, 6, 64)).reshape(-1)
    lvf = lv_a.reshape(-1, 64)
    geom = T._geometry((W, H), lvf.shape[0])
    check("T", lambda: (T.transcode_blocks(lvf, dc_a, qmat, (W, H)),),
          lambda: T.transcode_blocks_plain(lvf, dc_a, qmat, geom, False)[:1],
          f"{lvf.shape[0]} blocks")
    lv2_a, _ = check(
        "T pixel entry", lambda: T.transcode_blocks_pix(lvf, dc_a, qmat, (W, H)),
        lambda: T.transcode_blocks_plain(lvf, dc_a, qmat, geom, True),
        f"{lvf.shape[0]} blocks")
    lv2_a = lv2_a.reshape(lv_a.shape)
    wb = P.word_budget(rows_a)
    _, _, ok_e = check("E", lambda: E.encode_levels(lv2_a, wb),
                       lambda: E.encode_levels_plain(lv2_a, wb),
                       f"levels {tuple(lv2_a.shape)}, w_out {wb}")
    assert ok_e.all()
    del lv_a, lv2_a, lvf, dc_a, ok_a, ok_e
    torch.cuda.empty_cache()

    # extra cases on N_CHECK corpus frames: malformed scans for D, T without
    # edge replication, E with a word budget every frame overflows
    rng = np.random.default_rng(1)
    rows, lens = native.unescape_frames(pays[:N_CHECK])
    bad = rows[:8].copy()
    bad_lens = lens[:8].copy()
    bad[0] = rng.integers(0, 256, bad.shape[1])            # random bytes
    bad[1, 100:108] = 0xFF                                 # invalid code
    bad_lens[2] //= 3                                      # truncated
    bad_lens[3] = 0                                        # empty
    bad[4, 7::97] = rng.integers(0, 256, len(bad[4, 7::97]))
    rows_t = torch.from_numpy(np.concatenate([rows, bad])).to(dev)
    lens_t = torch.from_numpy(np.concatenate([lens, bad_lens])).to(dev)
    lv_k, ok_k = D.decode_scans(rows_t, lens_t, nb)
    lv_p, ok_p = D.decode_scans_plain(rows_t, lens_t, nb)
    torch.cuda.synchronize()
    errs["D extra"] = max_abs_err([(lv_k, lv_p), (ok_k, ok_p)])
    assert errs["D extra"] == 0, f"decode kernel differs by {errs['D extra']}"
    assert ok_k[:N_CHECK].all() and not ok_k[N_CHECK + 1], ok_k[N_CHECK:]
    log(f"D extra: bit-exact vs plain on {N_CHECK} frames + 8 malformed "
        f"(ok {ok_k[N_CHECK:].tolist()})")

    lv = lv_k[:N_CHECK].reshape(-1, 64)
    dc = P.resolve_dc(lv_k[:N_CHECK].reshape(N_CHECK, n_mcu, 6, 64))
    dc = dc.reshape(-1)
    want_lv, want_pix = T.transcode_blocks_plain(lv, dc, qmat,
                                                 T._geometry(None, lv.shape[0]))
    got_lv, got_pix = T.transcode_blocks_pix(lv, dc, qmat, None)
    got_lv2 = T.transcode_blocks(lv, dc, qmat, None)
    torch.cuda.synchronize()
    errs["T extra"] = max_abs_err([(got_lv, want_lv), (got_pix, want_pix),
                                   (got_lv2, want_lv)])
    assert errs["T extra"] == 0, f"transcode kernel differs by {errs['T extra']}"
    log(f"T extra: bit-exact vs plain on {lv.shape[0]} blocks, both entries, "
        "without edge replication (size=None)")

    lv2 = T.transcode_blocks(lv, dc, qmat, (W, H)).reshape(N_CHECK, nb, 64)
    got = E.encode_levels(lv2, 16)
    want = E.encode_levels_plain(lv2, 16)
    torch.cuda.synchronize()
    errs["E extra"] = max_abs_err(zip(got, want))
    assert errs["E extra"] == 0, f"encode kernel differs by {errs['E extra']}"
    assert not got[2].any(), "a 16-word budget must overflow"
    log(f"E extra: bit-exact vs plain on {N_CHECK} frames at w_out 16 "
        "(every frame overflows, ok = 0)")

    # ---- 5. the main path through the CLI ----------------------------
    want = c_reference(pays, W, H)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.amv"), os.path.join(tmp, "out.amv")
        with open(src, "wb") as f:
            f.write(data)
        P.transcode_bytes(data, qscale=QSCALE, device="cuda")    # warm-up
        torch.cuda.synchronize()
        D.LAUNCHES = T.LAUNCHES = E.LAUNCHES = 0
        P.HOST_FALLBACKS = 0
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            rc = cli.main(["-i", src, "-f", "amv", dst, "--device", "cuda"])
            walls.append(time.perf_counter() - t0)
            assert rc == 0
        launches = {"D": D.LAUNCHES, "T": T.LAUNCHES, "E": E.LAUNCHES}
        fallbacks = P.HOST_FALLBACKS
        with open(dst, "rb") as f:
            out = riff.demux(f.read())
    assert out.video_chunks == want, "video differs from the C reference"
    assert out.audio_chunks == audio, "audio did not pass through"
    assert all(v > 0 for v in launches.values()), launches
    assert fallbacks == 0, fallbacks
    wall = statistics.median(walls)
    log(f"main path: cli.main x3, {N_FRAMES} frames in "
        f"{', '.join(f'{t:.3f}' for t in walls)} s, median {wall:.3f} s = "
        f"{N_FRAMES / wall:.1f} frames/s; byte-identical to the C "
        f"reference, audio passed through; launches {launches}, host "
        f"fallbacks {fallbacks}")

    # the same stages one by one: host C/Python stages vs the device chain
    split = {}

    def stage(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t
        return r

    s = stage("demux", lambda: riff.demux(data))
    rows_s, lens_s = stage("unescape", lambda: native.unescape_frames(
        s.video_chunks))
    order = stage("sort", lambda: np.argsort(
        np.array([len(p) for p in s.video_chunks]), kind="stable"))
    r_t, l_t = stage("to_device", lambda: (
        torch.from_numpy(rows_s[order]).to(dev),
        torch.from_numpy(lens_s[order]).to(dev)))
    words, bits, ok = stage("device_chain", lambda: P.transcode_complete(
        r_t, l_t, n_mcu, QSCALE, (W, H)))
    inv = np.argsort(order)
    w_np, b_np = stage("to_host", lambda: (words.cpu().numpy()[inv],
                                           bits.cpu().numpy()[inv]))
    vch = stage("escape", lambda: native.escape_frames(w_np, b_np))
    stage("mux", lambda: riff.mux(vch, s.audio_chunks, width=W, height=H,
                                  fps=FPS, sample_rate=RATE))
    assert vch == want
    total = sum(split.values())
    log("split (s): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; device chain {split['device_chain'] / total:.1%} of {total:.3f}"
        f"; words copied to the host {tuple(words.shape)}")

    # ---- 6. big frames ----------------------------------------------
    big = corpus(256, 240, 320, seed=2)
    big_data = riff.mux(big, [], width=320, height=240, fps=FPS)
    got = riff.demux(P.transcode_bytes(big_data, qscale=QSCALE,
                                       device="cuda")).video_chunks
    assert got == c_reference(big, 320, 240), "320x240 differs"
    log(f"320x240: 256 frames (payloads up to {max(len(p) for p in big)} "
        "bytes) byte-identical to the C reference")

    kernels = []
    for key, name, src, replaces in (
            ("D", "entropy_decode", "amv_tpu_torch/csrc/entropy_decode.cu",
             "amv_tpu/kernels/entropy_async_pallas.py:829"),
            ("T", "transcode", "amv_tpu_torch/csrc/transcode.cu",
             "amv_tpu/kernels/transcode_layout_pallas.py:207"),
            ("E", "entropy_encode", "amv_tpu_torch/csrc/entropy_encode.cu",
             "amv_tpu/kernels/entropy_encode_async_pallas.py:940")):
        err = max(v for k, v in errs.items() if k.split()[0] == key)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": times[key][0],
                        "plain_ms": times[key][1]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
