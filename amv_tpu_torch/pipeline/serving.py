"""Streamed AMV transcode serving on CUDA streams: the port of
`amv_tpu/pipeline/serving.py:AsyncTranscoder`.

A stream of '00dc' payloads goes to the card in batches of `batch_frames`
frames with up to `depth` batches in flight, each on a CUDA stream and
pinned host buffers of its own (a ring of `depth` slots), in three
stages:

* `issue`: the C unescape writes the batch's scans into the slot's pinned
  buffer, a non-blocking upload, the device chain up to kernel E's bit
  count (`pipeline.transcode.transcode_scans`: kernels D, T or U -> V;
  then `count_bits`), and non-blocking copies of the bits and the `ok`
  flags into pinned memory.  The host waits on nothing.
* `pack`: once the next batch has been issued, the host reads this
  batch's bits (their copy has long finished), raises on a frame kernel D
  rejected, launches kernel E's pack at the exact word budget
  (`amv_video.used_words`, so no words truncate and no unused ones cross)
  and copies the words into the slot's pinned buffer.
* `drain`: waits for that copy alone; the C escape then writes the frames
  back to back into one buffer (`native.escape_packed`).

So batch k+1's unescape and upload, and the escape of batch k-depth+1,
overlap batch k's device work and copies.  Reference semantics
unchanged: mjpegdec.c:376-430 decode, mjpegenc.c:379-450 encode.

Left out of the JAX class: its TPU parameters (`sb`, `interpret`,
`win_fetch`, `win_emit`, `w_out` and the segmentation), the pad frames of
the last batch (nothing compiles per shape here), the within-batch length
sort (kernel D takes its frames longest first itself) and the host
fallback (kernel E never overflows here; a frame D rejects raises, as
the JAX fallback's host decoder raises on it).

`mesh=` (`parallel.sharding.make_mesh`; the JAX class's `mesh`,
`amv_tpu/pipeline/serving.py:71`) serves each batch across the mesh: its
frames split into mesh.size contiguous shards, dp-major, each position
with its own ring of `depth` slots (stream and pinned buffers) on its
device.  `issue` unescapes each shard into its slot and launches its
chain on its device; `pack` packs each shard at its own exact budget;
`drain` escapes the shards in order into one buffer.  Frames are
independent bitstreams, so no collective.  `batch_frames` must divide by
mesh.size (a shorter last batch splits as evenly as it can).
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .. import native
from ..codecs.amv_video import QUANTS, used_words
from ..codecs.jpeg_tables import device_table
from ..kernels.entropy_encode import count_bits, encode_levels
from ..kernels._build import on_stream
from ..utils.profiling import count, span
from . import resolve_device
from .transcode import transcode_scans


class _Slot:
    """One in-flight batch's CUDA stream (None on the CPU) and host
    buffers (pinned for a CUDA device), reused only once the batch that
    last held them was drained."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.busy = False
        self._bufs: dict = {}

    def host(self, name: str, numel: int, dtype) -> torch.Tensor:
        """Host buffer `name`'s first numel elements, grown on demand."""
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel + numel // 4, dtype=dtype,
                              pin_memory=self.stream is not None)
            self._bufs[name] = buf
        return buf[:numel]

    def event(self):
        """An event recorded on the slot's stream (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


class _Shard:
    """A batch's frames on one device between the stages: its slot, its
    first frame's index in the stream, the re-quantized levels on the
    device until the pack, the pinned bits and ok flags, the pinned words
    once packed, the events of those copies, and the span that issued it
    (the parent of its drain's)."""

    def __init__(self, slot, base, lv2, bits, ok, counted):
        self.slot, self.base, self.lv2 = slot, base, lv2
        self.bits, self.ok, self.counted = bits, ok, counted
        self.words = self.packed = self.issued = None


class AsyncTranscoder:
    """Order-preserving AMV scan transcoder over batches on CUDA streams.

    Parameters
    ----------
    n_mcu : MCUs per frame (frame geometry is fixed per instance).
    qscale : re-encode quantizer scale (reference default 2), or a
        qmat_key; unused for quant="q60".
    batch_frames : frames per device batch.
    depth : batches in flight; the host blocks on the oldest beyond it.
    w_bytes : bound on a batch's unescaped row width.  None = set from
        the first batch (or, via `transcode`, from the whole input); a
        later batch with longer scans then raises -- pass an explicit
        bound for open-ended streams.
    size : (width, height) of the frames, which the edge replication of
        pictures that are not whole MCUs and the two-stage route need;
        None = whole MCUs (the JAX class's assumption).
    quant : "ffmpeg" (the reference encoder's quantizer) or "q60".
    device : a torch device; "cuda" unless the caller asks for the CPU or
        gives a mesh.
    mesh : a `parallel.sharding.Mesh`: each batch's frames over its
        positions (not with `device`); batch_frames must divide by
        mesh.size.
    """

    def __init__(self, n_mcu: int, qscale=2, batch_frames: int = 4096,
                 depth: int = 4, w_bytes: int | None = None, *, size=None,
                 quant: str = "ffmpeg", device=None, mesh=None):
        if quant not in QUANTS:
            raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
        if batch_frames < 1:
            raise ValueError(f"batch_frames must be positive, got "
                             f"{batch_frames}")
        if size is None and quant == "q60":
            raise ValueError("quant='q60' needs the picture size")
        if size is not None and n_mcu != ((size[0] + 15) // 16) * (
                (size[1] + 15) // 16):
            raise ValueError(f"{n_mcu} MCUs do not make a {size[0]}x"
                             f"{size[1]} picture")
        if device is not None and mesh is not None:
            raise ValueError("device and mesh are exclusive: a mesh names "
                             "its own devices")
        if mesh is not None and batch_frames % mesh.size:
            raise ValueError(f"batch_frames={batch_frames} must divide by "
                             f"mesh.size={mesh.size}")
        self.n_mcu, self.qscale = n_mcu, qscale
        self.batch_frames, self.depth = batch_frames, max(1, depth)
        self.w_bytes, self.size, self.quant = w_bytes, size, quant
        self.mesh = mesh
        # the mesh positions' devices (one without a mesh), and a ring of
        # `depth` slots on each
        self.devices = (list(mesh.flat) if mesh is not None else
                        [resolve_device("cuda" if device is None
                                        else device)])
        self.device = self.devices[0]
        self._rings = [[_Slot(d) for _ in range(self.depth)]
                       for d in self.devices]
        self._next = 0           # the slot of the next batch
        self._base = 0           # the stream index of its first frame
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                # the kernels' tables, uploaded once on the default stream
                # before any batch's stream reads them
                for name in ("DEC_FAST", "ENC_TABLES"):
                    device_table(name, dev)
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def issue(self, payloads) -> list[_Shard]:
        """Stage 1: unescape into pinned memory, upload and enqueue the
        device chain up to kernel E's count on the batch's own stream (on
        a mesh, each shard on its position's) -> the batch: its shards, one
        a mesh position (one on a single device).  Raises ValueError when
        the batch's rows are wider than w_bytes."""
        slots = [ring[self._next] for ring in self._rings]
        if any(slot.busy for slot in slots):
            raise RuntimeError(f"more than depth={self.depth} batches in "
                               "flight: drain one first")
        n, parts = len(payloads), len(self.devices)
        cuts = [n * i // parts for i in range(parts + 1)]
        with span("serve.issue") as issued:
            # every shard unescaped and its width checked before any launch
            staged = [(slot, dev, self._unescape(slot, payloads[a:b]),
                       self._base + a)
                      for slot, dev, a, b in zip(slots, self.devices, cuts,
                                                 cuts[1:]) if b > a]
            shards = [self._launch(slot, dev, rows, lens, base)
                      for slot, dev, (rows, lens), base in staged]
        for shard in shards:
            shard.issued = issued
        for slot in slots:
            slot.busy = True
        self._next = (self._next + 1) % self.depth
        self._base += n
        count("serve.frames", n)
        return shards

    def _unescape(self, slot: _Slot, payloads):
        """A shard's scans unescaped into its slot's pinned rows -> (rows
        uint8 [n, stride], lens int64 [n]), both pinned; ValueError when
        they are wider than w_bytes."""
        n, stride = len(payloads), native.row_stride(payloads)
        rows = slot.host("rows", n * stride, torch.uint8)
        lens = slot.host("lens", n, torch.int64)
        with span("native.unescape"):
            _, lens_np = native.unescape_into(payloads, rows.numpy(),
                                              lens.numpy())
        width = (int(lens_np.max()) + 3) & ~3
        if self.w_bytes is None:
            self.w_bytes = width
        if width > self.w_bytes:
            raise ValueError(
                f"batch scan width {width} exceeds the row width "
                f"{self.w_bytes}; construct AsyncTranscoder with a w_bytes "
                "bound for this stream")
        return rows.view(n, stride), lens

    def _launch(self, slot: _Slot, dev, rows, lens, base) -> _Shard:
        """A shard's upload, device chain up to E's count and the copies
        of its bits and ok flags, on its slot's stream."""
        with on_stream(dev, slot.stream):
            scans = rows.to(dev, non_blocking=True)
            lv2, ok = transcode_scans(
                scans, lens.to(dev, non_blocking=True), self.n_mcu,
                self.qscale, self.size, self.quant)
            n = len(lens)
            bits = slot.host("bits", n, torch.int32)
            bits.copy_(count_bits(lv2), non_blocking=True)
            ok_h = slot.host("ok", n, torch.uint8)
            ok_h.copy_(ok, non_blocking=True)
            return _Shard(slot, base, lv2, bits, ok_h, slot.event())

    def pack(self, batch: list[_Shard]) -> None:
        """Stage 2: read the batch's bits and ok flags, raise ValueError
        naming (by stream index) the frames kernel D rejected, and enqueue
        kernel E's pack at each shard's exact budget and the words' copy
        to pinned memory.  Does nothing for a batch already packed."""
        if all(shard.words is not None for shard in batch):
            return
        with span("serve.pack"):
            counted = [s.counted for s in batch if s.counted is not None]
            if counted:
                with span("serve.wait_count"):
                    for event in counted:
                        event.synchronize()
            bad = [i + shard.base for shard in batch
                   for i in np.flatnonzero(shard.ok.numpy() == 0).tolist()]
            if bad:
                for shard in batch:
                    shard.slot.busy = False
                raise ValueError(f"malformed scan in frame(s) {bad} of the "
                                 "stream: the Huffman decoder rejected them")
            for shard in batch:
                if shard.words is not None:
                    continue
                n, w_used = len(shard.ok), used_words(shard.bits.numpy())
                with on_stream(shard.lv2.device, shard.slot.stream):
                    words, _, _ = encode_levels(shard.lv2, w_used)
                    shard.lv2 = None
                    shard.words = shard.slot.host(
                        "words", n * w_used, torch.int32).view(n, w_used)
                    shard.words.copy_(words, non_blocking=True)
                    shard.packed = shard.slot.event()

    def drain(self, batch: list[_Shard]):
        """Stage 3: wait for the batch's words and escape them -> (buf
        uint8, offsets int64 [n], lens int64 [n]) as `native.escape_packed`
        gives them (a mesh's shards in order, in one buffer); the batch's
        slots are free again."""
        self.pack(batch)
        outs = []
        with span("serve.drain", parent=batch[0].issued):
            for shard in batch:
                if shard.packed is not None:
                    with span("serve.wait_packed"):
                        shard.packed.synchronize()
                with span("native.escape"):
                    outs.append(native.escape_packed(shard.words.numpy(),
                                                     shard.bits.numpy()))
                shard.slot.busy = False
        if len(outs) == 1:
            return outs[0]
        starts = np.cumsum([0] + [len(o[0]) for o in outs[:-1]])
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] + k for o, k in zip(outs, starts)]),
                np.concatenate([o[2] for o in outs]))

    # ------------------------------------------------------------------
    def batches(self, payload_iter):
        """Yield each batch's re-encoded payloads, packed as `drain`
        returns them, in input order; `depth` batches stay in flight.
        One worker thread drains (the C escape releases the interpreter
        lock) while this one unescapes and issues the next batch."""
        it = iter(payload_iter)
        self._base = 0
        pending = None                  # issued, not yet packed
        drains = collections.deque()    # packed, being drained in order
        with ThreadPoolExecutor(1) as worker:
            try:
                while chunk := list(itertools.islice(it, self.batch_frames)):
                    # the next slot is free once depth - 1 batches remain
                    while len(drains) + (pending is not None) >= self.depth:
                        if not drains:
                            self.pack(pending)
                            drains.append(worker.submit(self.drain, pending))
                            pending = None
                        else:
                            with span("serve.wait_slot"):
                                out = drains.popleft().result()
                            yield out
                    batch = self.issue(chunk)
                    if pending is not None:
                        self.pack(pending)
                        drains.append(worker.submit(self.drain, pending))
                    pending = batch
                if pending is not None:
                    self.pack(pending)
                    drains.append(worker.submit(self.drain, pending))
                    pending = None
                while drains:
                    with span("serve.wait_slot"):
                        out = drains.popleft().result()
                    yield out
            finally:
                # after an error or an early close: the batches left in
                # flight still copy into their slots' buffers, so wait for
                # them
                for fut in drains:
                    fut.cancel()
                wait(drains)
                for slot in (s for ring in self._rings for s in ring):
                    if slot.busy and slot.stream is not None:
                        slot.stream.synchronize()
                    slot.busy = False

    def stream(self, payload_iter):
        """Yield re-encoded payloads (bytes) in input order; `depth`
        batches of `batch_frames` frames stay in flight ahead of the
        oldest one being collected."""
        for buf, offsets, lens in self.batches(payload_iter):
            for o, n in zip(offsets.tolist(), lens.tolist()):
                yield buf[o:o + n].tobytes()

    def transcode(self, payloads) -> list[bytes]:
        """Transcode a known-size payload list (row width bounded up
        front from the longest payload, so no batch trips the guard)."""
        payloads = list(payloads)
        if not payloads:
            return []
        if self.w_bytes is None:
            # escaped length bounds unescaped length (native stride rule)
            self.w_bytes = native.row_stride(payloads)
        return list(self.stream(payloads))
