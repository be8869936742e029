"""One memo at a time: `cli.main(["-i", rec.act, out.wav])` in a closed
loop with one client, as a user decoding recordings one by one.

`recordings` distinct ACT files whose lengths are spread log-uniformly
over [seconds_min, seconds_max] (the same lengths for every seed, in a
seeded order of short-long pairs), written once at set-up under a temporary directory and
cycled through.  Each call overwrites one output WAV; the first call on
each recording, and `extra_checks` more calls drawn from the seed, write
to a file of their own, which is read back once the window has closed
and compared with the frozen C decoder over the same demuxed frames.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import corpus
from ..reference import g729 as ref
from . import balanced_order, clock


class Driver:
    def __init__(self, cfg: dict, params: dict, seed: int, spans,
                 device="cuda"):
        self.cfg, self.p, self.seed, self.span = cfg, params, seed, spans
        self.device = device
        self.calls = []         # (recording, start, end, kept path or None)
        self.t0 = self.t1 = 0.0
        self.dir = None

    def setup(self):
        self.make_inputs()
        from amv_tpu_torch import cli
        self.main = cli.main
        # warm up: the longest recording, then the shortest
        for i in (int(np.argmax(self.lengths)), int(np.argmin(self.lengths))):
            self._call(i, os.path.join(self.dir, "out.wav"))

    def make_inputs(self):
        p, rate = self.p, self.cfg["sample_rate"]
        k = p["recordings"]
        lo, hi = math.log(p["seconds_min"]), math.log(p["seconds_max"])
        fps = rate // 80
        rng = np.random.default_rng(self.seed)
        lengths = [int(round(math.exp(lo + (i + 0.5) * (hi - lo) / k) * fps))
                   for i in range(k)]
        self.lengths = [lengths[i] for i in balanced_order(k, rng)]
        frames = corpus.g729_frames(max(self.lengths), k, self.seed,
                                    self.device).cpu().numpy()
        frames = corpus.g729_defined(frames, self.seed, self.device,
                                     self.lengths)
        self.dir = tempfile.mkdtemp(prefix="portbench-act-")
        self.paths, self.n_frames = [], []
        for i, n in enumerate(self.lengths):
            data = ref.act_mux(frames[:n, i], rate)
            path = os.path.join(self.dir, f"rec{i:03d}.act")
            with open(path, "wb") as f:
                f.write(data)
            self.paths.append(path)
            self.n_frames.append(len(ref.act_demux(data)))
        self.extra = set(rng.choice(10 * k, p["extra_checks"],
                                    replace=False).tolist())

    def _call(self, i: int, out: str):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = self.main(["-i", self.paths[i], "--device", self.device,
                            out])
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc} on {self.paths[i]}")

    def window(self, seconds: float):
        k, seen = len(self.paths), set()
        out = os.path.join(self.dir, "out.wav")
        self.t0 = clock()
        j = 0
        while True:
            i = j % k
            keep = None
            if i not in seen or j in self.extra:
                keep = os.path.join(self.dir, f"kept{j:05d}.wav")
                seen.add(i)
            a = clock()
            with self.span("cli_main"):
                self._call(i, keep or out)
            b = clock()
            self.calls.append((i, a, b, keep))
            j += 1
            if b - self.t0 >= seconds:
                break
        self.t1 = self.calls[-1][2]

    def control_window(self):
        """The control in the program's place: every recording once, its
        WAV written from the reference's PCM carried in 8 bits."""
        rate = self.cfg["sample_rate"]
        pcms = ref.decode_many(self._frames(range(len(self.paths))))
        self.calls = []
        for i, pcm in enumerate(pcms):
            path = os.path.join(self.dir, f"control{i:03d}.wav")
            data = ref.control(pcm).astype("<i2").tobytes()
            head = (b"RIFF" + (36 + len(data)).to_bytes(4, "little") +
                    b"WAVEfmt " + (16).to_bytes(4, "little") +
                    np.array([1, 1], "<u2").tobytes() +
                    np.array([rate, 2 * rate], "<u4").tobytes() +
                    np.array([2, 16], "<u2").tobytes() + b"data" +
                    len(data).to_bytes(4, "little"))
            with open(path, "wb") as f:
                f.write(head + data)
            self.calls.append((i, 0.0, 0.0, path))

    def _frames(self, recs):
        out = []
        for i in recs:
            with open(self.paths[i], "rb") as f:
                out.append(ref.act_demux(f.read()))
        return out

    def result(self) -> dict:
        lat = np.array([b - a for _, a, b, _ in self.calls]) * 1e3
        frames = sum(self.n_frames[i] for i, *_ in self.calls)
        return {"attempted": len(self.calls), "failed": 0,
                "requests_s": (lat / 1e3).tolist(),
                "e2e": {"act_decode_frames_per_s":
                        frames / (self.t1 - self.t0),
                        "act_file_p95_ms": float(np.percentile(lat, 95))},
                "work": {"frames": frames}}

    def release(self):
        self.main = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        kept = [(i, path) for i, _, _, path in self.calls if path]
        recs = sorted({i for i, _ in kept})
        want = dict(zip(recs, ref.decode_many(self._frames(recs))))
        bad = 0
        for i, path in kept:
            with open(path, "rb") as f:
                data = f.read()
            try:
                pcm = ref.wav_pcm(data, self.cfg["sample_rate"])
            except ValueError:
                bad += 1
                continue
            bad += not np.array_equal(pcm, want[i])
        return [("bad_files", bad, 0)]

    def close(self):
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
