"""Films re-quantized for a player: whole .amv files, one after another,
through the port's transcode entry `pipeline.transcode.transcode_bytes`
(bytes in, bytes out: what `cli.main -i in.amv -f amv out.amv` runs,
without the disk).

The library is `films` distinct files whose lengths are spread evenly
over [frames_min, frames_max] (the same lengths for every seed, in a
seeded order of short-long pairs), each tiled from `pictures` distinct C-encoded pictures from
a seeded start, with IMA-ADPCM audio chunks beside its frames.  Every
output file is compared byte for byte with the reference's: each video
frame decoded and re-encoded at the config's qscale by the frozen C codec,
every audio chunk passed through, muxed as FFmpeg's AMV muxer writes.
"""

from __future__ import annotations

import numpy as np

from .. import corpus
from ..reference import amv as ref
from . import balanced_order, clock


class Driver:
    def __init__(self, cfg: dict, params: dict, seed: int, spans,
                 device="cuda"):
        self.cfg, self.p, self.seed, self.span = cfg, params, seed, spans
        self.device = device
        self.w, self.h = cfg["width"], cfg["height"]
        self.q, self.fps = cfg["qscale"], cfg["fps"]
        self.rate = cfg["sample_rate"]
        self.outputs = []           # (film index, output bytes)
        self.times = []             # (start, end) of each file
        self.t0 = self.t1 = 0.0

    # -- inputs ---------------------------------------------------------
    def setup(self):
        self.make_inputs()
        from amv_tpu_torch.pipeline.transcode import transcode_bytes
        self.entry = transcode_bytes
        # warm up: the shortest film runs the served route on every
        # picture, so it allocates what every later film does
        warm = min(range(len(self.films)),
                   key=lambda i: self.films[i]["frames"])
        self._run(self.files[warm])

    def make_inputs(self):
        p, rng = self.p, np.random.default_rng(self.seed)
        n_pics = p["pictures"]
        pics = corpus.pictures(n_pics, self.h, self.w, self.seed)
        self.payloads = ref.encode_pictures(*pics, self.q)
        chunk_samples = self.rate // self.fps
        self.audio = corpus.adpcm_chunks(p["audio_chunks"], chunk_samples,
                                         self.seed + 1)
        k = p["films"]
        lo, hi = p["frames_min"], p["frames_max"]
        lengths = [int(round(lo + (i + 0.5) * (hi - lo) / k))
                   for i in range(k)]
        self.films = []
        for n in (lengths[i] for i in balanced_order(k, rng)):
            v0 = int(rng.integers(n_pics))
            a0 = int(rng.integers(len(self.audio)))
            self.films.append({"frames": n, "v0": v0, "a0": a0})
        self.files = [self._mux(f, self.payloads, self.audio)
                      for f in self.films]

    def _mux(self, film, video_frames, audio_chunks) -> bytes:
        n, nv, na = film["frames"], len(video_frames), len(audio_chunks)
        video = [video_frames[(film["v0"] + i) % nv] for i in range(n)]
        audio = [audio_chunks[(film["a0"] + i) % na] for i in range(n)]
        return ref.mux(video, audio, width=self.w, height=self.h,
                       fps=self.fps, sample_rate=self.rate)

    def _run(self, data: bytes) -> bytes:
        return self.entry(data, qscale=self.q, device=self.device)

    # -- the window -----------------------------------------------------
    def window(self, seconds: float):
        k = len(self.files)
        self.t0 = clock()
        i = 0
        while True:
            a = clock()
            with self.span("transcode_bytes"):
                out = self._run(self.files[i % k])
            b = clock()
            self.outputs.append((i % k, out))
            self.times.append((a, b))
            i += 1
            if b - self.t0 >= seconds:
                break
        self.t1 = self.times[-1][1]

    def control_window(self):
        """The control in the program's place: each film once, transcoded
        by the reference with its decoded pixels carried in 7 bits."""
        ctl = ref.transcode_frames(self.payloads, self.w, self.h, self.q,
                                   drop_bits=1)
        self.outputs = [(i, self._mux(f, ctl, self.audio))
                        for i, f in enumerate(self.films)]

    def result(self) -> dict:
        films = [i for i, _ in self.outputs]
        frames = sum(self.films[i]["frames"] for i in films)
        return {"attempted": len(films), "failed": 0,
                "requests_s": [b - a for a, b in self.times],
                "e2e": {"amv_frames_per_s": frames / (self.t1 - self.t0)},
                "work": {"frames": frames,
                         "chain_bytes": self.chain_bytes(films)}}

    def reference(self) -> list:
        """The reference's transcode of every distinct picture (once)."""
        if getattr(self, "_ref", None) is None:
            self._ref = ref.transcode_frames(self.payloads, self.w, self.h,
                                             self.q)
        return self._ref

    def chain_bytes(self, films) -> float:
        """The transcode chain's contract bytes over these films: each
        frame's unescaped scan read once and its re-encoded scan written
        once (the reference's frame less its markers and stuffing)."""
        if getattr(self, "_per_pic", None) is None:
            self._per_pic = np.array(
                [ref.scan_bytes(a) + ref.scan_bytes(b)
                 for a, b in zip(self.payloads, self.reference())],
                np.float64)
        per_pic = self._per_pic
        cum = np.concatenate([[0.0], np.cumsum(np.tile(per_pic, 2))])
        n_pics = len(per_pic)
        total = 0.0
        for i in films:
            f = self.films[i]
            whole, rest = divmod(f["frames"], n_pics)
            total += whole * cum[n_pics] + cum[f["v0"] + rest] - cum[f["v0"]]
        return total

    def release(self):
        self.entry = None
        import torch
        torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------
    def check(self) -> list:
        want = {}
        bad = 0
        for i, out in self.outputs:
            if i not in want:
                want[i] = self._mux(self.films[i], self.reference(),
                                     self.audio)
            bad += out != want[i]
        return [("bad_files", bad, 0)]
