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
the JAX fallback's host decoder raises on it).  `mesh` waits for serving
across several GPUs.
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


class _Batch:
    """A batch between its stages: its slot, its first frame's index in
    the stream, the re-quantized levels on the device until the pack, the
    pinned bits and ok flags, the pinned words once packed, and the
    events of those copies."""

    def __init__(self, slot, base, lv2, bits, ok, counted):
        self.slot, self.base, self.lv2 = slot, base, lv2
        self.bits, self.ok, self.counted = bits, ok, counted
        self.words = self.packed = None


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
    device : a torch device; "cuda" unless the caller asks for the CPU.
    """

    def __init__(self, n_mcu: int, qscale=2, batch_frames: int = 4096,
                 depth: int = 4, w_bytes: int | None = None, *, size=None,
                 quant: str = "ffmpeg", device="cuda"):
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
        self.n_mcu, self.qscale = n_mcu, qscale
        self.batch_frames, self.depth = batch_frames, max(1, depth)
        self.w_bytes, self.size, self.quant = w_bytes, size, quant
        self.device = resolve_device(device)
        self._slots = [_Slot(self.device) for _ in range(self.depth)]
        self._next = 0           # the slot of the next batch
        self._base = 0           # the stream index of its first frame
        if self.device.type == "cuda":
            # the kernels' tables, uploaded once on the default stream
            # before any batch's stream reads them
            for name in ("DEC_FAST", "ENC_TABLES"):
                device_table(name, self.device)
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def issue(self, payloads) -> _Batch:
        """Stage 1: unescape into pinned memory, upload and enqueue the
        device chain up to kernel E's count on the batch's own stream.
        Raises ValueError when the batch's rows are wider than w_bytes."""
        slot = self._slots[self._next]
        if slot.busy:
            raise RuntimeError(f"more than depth={self.depth} batches in "
                               "flight: drain one first")
        n, stride = len(payloads), native.row_stride(payloads)
        rows = slot.host("rows", n * stride, torch.uint8)
        lens = slot.host("lens", n, torch.int64)
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
        with torch.cuda.stream(slot.stream):
            scans = rows.view(n, stride).to(self.device, non_blocking=True)
            lv2, ok = transcode_scans(
                scans, lens.to(self.device, non_blocking=True), self.n_mcu,
                self.qscale, self.size, self.quant)
            bits = slot.host("bits", n, torch.int32)
            bits.copy_(count_bits(lv2), non_blocking=True)
            ok_h = slot.host("ok", n, torch.uint8)
            ok_h.copy_(ok, non_blocking=True)
            batch = _Batch(slot, self._base, lv2, bits, ok_h, slot.event())
        slot.busy = True
        self._next = (self._next + 1) % self.depth
        self._base += n
        return batch

    def pack(self, batch: _Batch) -> None:
        """Stage 2: read the batch's bits and ok flags, raise ValueError
        naming (by stream index) the frames kernel D rejected, and enqueue
        kernel E's pack at the exact budget and the words' copy to pinned
        memory.  Does nothing for a batch already packed."""
        if batch.words is not None:
            return
        if batch.counted is not None:
            batch.counted.synchronize()
        ok = batch.ok.numpy()
        if not ok.all():
            batch.slot.busy = False
            bad = (np.flatnonzero(ok == 0) + batch.base).tolist()
            raise ValueError(f"malformed scan in frame(s) {bad} of the "
                             "stream: the Huffman decoder rejected them")
        n, w_used = len(ok), used_words(batch.bits.numpy())
        with torch.cuda.stream(batch.slot.stream):
            words, _, _ = encode_levels(batch.lv2, w_used)
            batch.lv2 = None
            batch.words = batch.slot.host("words", n * w_used,
                                          torch.int32).view(n, w_used)
            batch.words.copy_(words, non_blocking=True)
            batch.packed = batch.slot.event()

    def drain(self, batch: _Batch):
        """Stage 3: wait for the batch's words and escape them -> (buf
        uint8, offsets int64 [n], lens int64 [n]) as `native.escape_packed`
        gives them; the batch's slot is free again."""
        self.pack(batch)
        if batch.packed is not None:
            batch.packed.synchronize()
        out = native.escape_packed(batch.words.numpy(), batch.bits.numpy())
        batch.slot.busy = False
        return out

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
                            yield drains.popleft().result()
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
                    yield drains.popleft().result()
            finally:
                # after an error or an early close: the batches left in
                # flight still copy into their slots' buffers, so wait for
                # them
                for fut in drains:
                    fut.cancel()
                wait(drains)
                for slot in self._slots:
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
