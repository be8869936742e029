"""A dictaphone archive decoded in bulk: `streams` ACT recordings of
`frames` G.729A frames each, every pass demuxed file by file
(`containers.act.demux`), stacked stream-major into [B, T, 10] (one
contiguous copy a file), uploaded (`pipeline.upload`, pinned), handed to
`codecs.g729a.decode_streams` as its [T, B, 10] view (kernel G, all
frames in one launch) and its PCM copied back to the host (`.cpu()`).

The recordings are seeded random G.729 frames with valid pitch parity,
made on the device (`corpus.g729_frames`), each one the reference decodes
without an undefined step (`corpus.g729_defined`), muxed into ACT files
by the reference's muxer.  The same archive is decoded pass after pass.  Checked:
`check_streams` recordings drawn from the seed, their PCM from the last
pass and one more drawn from each pass, each against the frozen C
decoder over the same demuxed frames (the writer's zero padding decodes
as erasures in both).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import corpus
from ..reference import g729 as ref
from . import clock


class Driver:
    def __init__(self, cfg: dict, params: dict, seed: int, spans,
                 device="cuda"):
        self.cfg, self.p, self.seed, self.span = cfg, params, seed, spans
        self.device = device
        self.kept = []          # (stream, PCM int16) as the program gave it
        self.passes = 0
        self.t0 = self.t1 = 0.0

    def setup(self):
        self.make_inputs()
        from amv_tpu_torch.codecs import g729a
        from amv_tpu_torch.containers import act
        from amv_tpu_torch.pipeline import upload
        self.demux, self.upload = act.demux, upload
        self.decode = g729a.decode_streams
        self._pass()                  # warm up on the window's shapes

    def make_inputs(self):
        p = self.p
        b, t = p["streams"], p["frames"]
        frames = corpus.g729_frames(t, b, self.seed, self.device).cpu()
        frames = corpus.g729_defined(frames.numpy(), self.seed, self.device)
        self.files = [ref.act_mux(frames[:, i], self.cfg["sample_rate"])
                      for i in range(b)]
        rng = np.random.default_rng(self.seed)
        self.sample = rng.choice(b, min(b, p["check_streams"]),
                                 replace=False)
        self.rng = rng

    def _pass(self):
        with self.span("demux"):
            frames = np.stack([self.demux(f)[0] for f in self.files])
        with self.span("upload"):
            dev = self.upload(frames, torch.device(self.device))
        with self.span("decode_streams"):
            # [B, T, 10] as uploaded, handed over as the [T, B, 10] view
            pcm = self.decode(dev.transpose(0, 1))
        with self.span("copy_back"):
            host = pcm.cpu()
        self.frames_a_pass = frames.shape[0] * frames.shape[1]
        return host

    def window(self, seconds: float):
        self.t0 = clock()
        self.pass_s = []
        while True:
            a = clock()
            host = self._pass()
            self.pass_s.append(clock() - a)
            self.passes += 1
            s = int(self.rng.integers(len(self.files)))
            self.kept.append((s, host[s].numpy().copy()))
            if clock() - self.t0 >= seconds:
                break
        self.t1 = clock()
        self.kept += [(int(s), host[s].numpy().copy()) for s in self.sample]

    def control_window(self):
        """The control in the program's place: the sampled recordings
        decoded by the reference, carried in 8 bits."""
        self.kept = [(int(s), ref.control(pcm)) for s, pcm in zip(
            self.sample, ref.decode_many(self._frames(self.sample)))]

    def _frames(self, streams):
        return [ref.act_demux(self.files[s]) for s in streams]

    def result(self) -> dict:
        frames = self.passes * self.frames_a_pass
        return {"attempted": self.passes, "failed": 0,
                "requests_s": self.pass_s,
                "e2e": {"act_decode_frames_per_s":
                        frames / (self.t1 - self.t0)},
                "work": {"frames": frames}}

    def release(self):
        self.decode = self.upload = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        streams = sorted({s for s, _ in self.kept})
        want = dict(zip(streams, ref.decode_many(self._frames(streams))))
        bad = sum(not np.array_equal(pcm, want[s]) for s, pcm in self.kept)
        return [("bad_streams", bad, 0)]
