"""Multi-GPU sharding for the AMV codec pipeline: the counterpart of
`amv_tpu/parallel/sharding.py`.

The codec has no state across frames or audio chunks (video frames are
independent intra pictures; each audio chunk or speech stream carries its
own codec state), so it scales as data parallelism over a 2D ("dp",
"sp") mesh of devices:

* `map_shards` cuts each argument along its batch axis into `mesh.size`
  contiguous shards, dp-major (JAX's `P(("dp", "sp"))`), moves each shard
  to its device (non-blocking, from pinned memory when it comes from the
  host) and runs the port's single-device function on it there, under
  `torch.cuda.device(d)` and the mesh position's own CUDA stream, so that
  shards on different cards, or on one card's different streams, run at
  once; `gather` concatenates the per-shard outputs on one device;
* the 14 `sharded_*` functions keep the JAX names and map to the port's
  functions (each shard launches the same kernels the single-device call
  does).

The one collective: `sharded_decode_step` puts frames on dp and MCUs on
sp, and the DC prediction's running sum crosses the sp shards of a frame.
Each shard's per-frame, per-component DC total is carried to the
following shards in sp order (a few int32 a frame) before the transform;
nothing else moves between devices until the gather.  JAX leaves that
chain to XLA's sharded cumsum (`sharding.py:9-11`).

Devices: `make_mesh()` takes every CUDA device and raises without one (it
never falls back to the CPU).  A device list may repeat a device, a
virtual mesh like the JAX package's virtual CPU mesh: each position then
has a stream of its own on that card.  The tests pass `["cpu"] * 8`.

Left out of the JAX functions: their TPU parameters (`interpret`,
`win_fetch`, `win_emit`, `segs`, `sb`, `w_out`, `hbm_decode`), as
`pipeline/serving.py` left them out: a thread block per frame has no lane
tiles, windows or word budget to size.  `jax.jit`'s compiled callable
becomes a plain function that shards, runs and gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import amv_video
from ..codecs.amv_video import _check_geometry
from ..codecs.jpeg_tables import QDC_CHROMA, QDC_LUMA
from ..kernels import adpcm as KA
from ..kernels._build import device_key, on_stream
from ..kernels.decode_fused import assemble_planes
from ..kernels.entropy_decode import decode_scans
from ..kernels.idct import idct_blocks
from ..pipeline import resolve_device, upload


class Mesh:
    """A (dp, sp) grid of torch devices, `axis_names == ("dp", "sp")`;
    `devices` is the numpy object array of them (JAX's `Mesh.devices`),
    `flat` the positions in dp-major order, `stream(p)` position p's CUDA
    stream (None on the CPU)."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.flat = list(devices.reshape(-1))
        self._streams: dict = {}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def stream(self, pos: int):
        dev = self.flat[pos]
        if dev.type != "cuda":
            return None
        if pos not in self._streams:
            self._streams[pos] = torch.cuda.Stream(dev)
        return self._streams[pos]


def make_mesh(devices=None, dp: int | None = None,
              sp: int | None = None) -> Mesh:
    """A ("dp", "sp") mesh over `devices` (torch devices or names; None =
    every CUDA device, and a RuntimeError where there is none).  As in JAX,
    sp = 2 when the count is even and above 1, and dp = n // sp, unless
    both are given."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError("make_mesh: no CUDA device is available to "
                               "torch (pass devices= for another mesh)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [device_key(resolve_device(d)) for d in devices]
    n = len(devices)
    if dp is None or sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sp
    if dp < 1 or sp < 1 or dp * sp > n:
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} devices, "
                         f"got {n}")
    grid = np.empty(dp * sp, dtype=object)
    grid[:] = devices[:dp * sp]
    return Mesh(grid.reshape(dp, sp))


# ------------------------------------------------------------ the helper

def _split(x, axis: int, n: int, mesh: Mesh, what: str):
    """x cut into n contiguous pieces along axis (x a tensor, an array or
    a dict of them)."""
    if isinstance(x, dict):
        parts = {k: _split(v, axis, n, mesh, f"{what}[{k!r}]")
                 for k, v in x.items()}
        return [{k: parts[k][i] for k in x} for i in range(n)]
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"{what}: batch axis {axis} of size {size} does "
                         f"not divide by mesh.size={mesh.size} "
                         f"(mesh {mesh.shape})")
    k = size // n
    idx = [slice(None)] * axis
    return [x[tuple(idx + [slice(i * k, (i + 1) * k)])] for i in range(n)]


def _place(x, dev: torch.device):
    """x on dev (inside dev's shard stream): a host array or CPU tensor
    bound for a card goes through pinned memory, non-blocking."""
    if isinstance(x, dict):
        return {k: _place(v, dev) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return upload(np.ascontiguousarray(x), dev)
    if isinstance(x, torch.Tensor):
        if dev.type == "cuda" and x.device.type == "cpu" and \
                not x.is_pinned():
            return upload(x.contiguous().numpy(), dev)
        return x.to(dev, non_blocking=True).contiguous()
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _start(mesh: Mesh, pos: int) -> None:
    """Position pos's stream waits for the work its device's current stream
    holds (the inputs the caller made there)."""
    s = mesh.stream(pos)
    if s is not None:
        s.wait_stream(torch.cuda.current_stream(mesh.flat[pos]))


def _finish(mesh: Mesh, positions) -> None:
    """Each device's current stream waits for the shard streams that ran
    there, so that the caller's later work sees their outputs."""
    for pos in positions:
        s = mesh.stream(pos)
        if s is not None:
            torch.cuda.current_stream(mesh.flat[pos]).wait_stream(s)


def map_shards(mesh: Mesh, fn, args, axes) -> list:
    """fn(*shard_args) on each mesh position, in dp-major order: args[i]
    cut into mesh.size contiguous shards along axes[i] (None: the whole
    argument, on every position), each shard moved to its device and run
    there on the position's own stream.  Returns the per-shard outputs in
    order, ready for the caller's streams.  A batch axis that does not
    divide by mesh.size raises ValueError naming it."""
    n = mesh.size
    cut = [(_split(a, ax, n, mesh, f"argument {i}") if ax is not None
            else [a] * n) for i, (a, ax) in enumerate(zip(args, axes))]
    outs = []
    for pos in range(n):
        _start(mesh, pos)
        dev, stream = mesh.flat[pos], mesh.stream(pos)
        with on_stream(dev, stream):
            shard = [_place(c[pos], dev) for c in cut]
            if stream is not None:
                for t in _tensors(shard):
                    t.record_stream(stream)
            outs.append(fn(*shard))
    _finish(mesh, range(n))
    return outs


def gather(shards, device=None, axis: int = 0):
    """Per-shard outputs (tensors, or tuples or dicts of them, alike) ->
    their concatenation along axis on `device` (default: the first
    shard's)."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: gather([s[k] for s in shards], device, axis)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(gather([s[i] for s in shards], device, axis)
                           for i in range(len(first)))
    dev = first.device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in shards], dim=axis)


def _pad_words(shards, i: int = 0):
    """Shards whose output i is words [F_k, w_k] trimmed to their own
    longest frame, padded with zero words to the widest, as one
    single-device call trims them to the longest frame of all."""
    w = max(s[i].shape[1] for s in shards)
    return [tuple(torch.nn.functional.pad(x, (0, w - x.shape[1]))
                  if j == i else x for j, x in enumerate(s)) for s in shards]


# ------------------------------------------------------------ video

def _dc_partial(lv: torch.Tensor):
    """A shard's DC chain alone: levels [F, m, 6, 64] (slot 0 the DC
    difference) -> (dequantized running sums int32 [F, m, 6] from 0,
    their per-frame totals int32 [F, 3]: Y, Cb, Cr), `resolve_dc`'s sums
    without the 1,024 and the earlier shards."""
    f, m = lv.shape[:2]
    d = lv[..., 0].to(torch.int32)
    dy = torch.cumsum(d[:, :, :4].reshape(f, m * 4) * QDC_LUMA, dim=1,
                      dtype=torch.int32).reshape(f, m, 4)
    dcb = torch.cumsum(d[:, :, 4] * QDC_CHROMA, dim=1, dtype=torch.int32)
    dcr = torch.cumsum(d[:, :, 5] * QDC_CHROMA, dim=1, dtype=torch.int32)
    part = torch.cat([dy, dcb[..., None], dcr[..., None]], dim=2)
    return part, torch.stack([dy[:, -1, 3], dcb[:, -1], dcr[:, -1]], 1)


def _move(t: torch.Tensor, mesh: Mesh, src: int, dst: int) -> torch.Tensor:
    """t, made on position src's stream, for use on position dst's: the
    dst stream waits for src's, and t crosses to dst's device if it
    lives elsewhere."""
    s_src, s_dst = mesh.stream(src), mesh.stream(dst)
    dev = mesh.flat[dst]
    if s_dst is None:
        return t.to(dev)
    if s_src is not None:
        s_dst.wait_stream(s_src)
    if t.device == dev:
        t.record_stream(s_dst)
        return t
    with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
        return t.to(dev, non_blocking=True)


_COMPONENT = [0, 0, 0, 0, 1, 2]     # a block slot's DC component


def sharded_decode_step(mesh: Mesh, mb_w: int, mb_h: int, width: int,
                        height: int):
    """`codecs.amv_video.decode_transform` with frames on dp and MCUs on
    sp: levels int16 [F, n_mcu, 6, 64] (zigzag, slot 0 the DC difference;
    F divisible by dp and n_mcu by sp) -> (y, cb, cr) display planes on
    the mesh's first device (where every sharded_* gathers).

    Each shard resolves its DC chain from 0 and its per-frame totals; the
    totals travel along the sp row (the one collective); each shard then
    adds the carry and runs kernel I (dequant + IDCT) on its blocks; the
    sp shards' pixel blocks are gathered on the row's first device, which
    assembles, flips and crops its frames' planes."""
    dp, sp = mesh.devices.shape

    def fn(levels_zz):
        f, m = levels_zz.shape[:2]
        _check_geometry(m, mb_w, mb_h, width, height)
        if f % dp or m % sp:
            raise ValueError(f"{f} frames of {m} MCUs do not divide by the "
                             f"mesh {mesh.shape} (frames on dp, MCUs on "
                             f"sp; mesh.size={mesh.size})")
        fd, ms = f // dp, m // sp
        shard = {}
        for i in range(dp):
            for j in range(sp):
                pos = i * sp + j
                _start(mesh, pos)
                with on_stream(mesh.flat[pos], mesh.stream(pos)):
                    lv = _place(levels_zz[i * fd:(i + 1) * fd,
                                          j * ms:(j + 1) * ms],
                                mesh.flat[pos])
                    shard[pos] = (lv, *_dc_partial(lv))
        planes = []
        for i in range(dp):
            row, carry = i * sp, None
            pix = []
            for j in range(sp):
                pos = row + j
                lv, part, tot = shard[pos]
                with on_stream(mesh.flat[pos], mesh.stream(pos)):
                    if carry is not None:
                        carry = _move(carry, mesh, pos - 1, pos)
                        part = part + carry[:, _COMPONENT][:, None, :]
                        tot = tot + carry
                    carry = tot
                    px = idct_blocks(lv.reshape(-1, 64),
                                     (part + 1024).reshape(-1))
                pix.append(_move(px.view(fd, ms, 6, 8, 8), mesh, pos, row))
            with on_stream(mesh.flat[row], mesh.stream(row)):
                planes.append(assemble_planes(torch.cat(pix, 1), mb_w, mb_h,
                                              width, height))
        _finish(mesh, range(mesh.size))
        return gather(planes, mesh.flat[0])

    return fn


def sharded_encode_step(mesh: Mesh, mb_w: int, mb_h: int, qscale=2,
                        quant: str = "ffmpeg"):
    """`codecs.amv_video.encode_transform` (kernel V) with frames over the
    mesh: (y, cb, cr) display planes -> levels int16 [F, n_mcu, 6, 64]."""
    def fn(y, cb, cr):
        outs = map_shards(mesh, lambda a, b, c: amv_video.encode_transform(
            a, b, c, mb_w, mb_h, qscale, quant), (y, cb, cr), (0, 0, 0))
        return gather(outs, mesh.flat[0])
    return fn


def sharded_entropy_decode(mesh: Mesh, n_mcu: int):
    """Kernel D (`kernels.entropy_decode.decode_scans`) with frames over
    the mesh: unescaped scans uint8 [F, stride], lens int64 [F] -> (levels
    int16 [F, n_mcu, 6, 64] zigzag, slot 0 the DC difference, ok uint8
    [F]).  Scans are independent bitstreams: no collective."""
    def fn(rows, lens):
        outs = map_shards(mesh, lambda r, n: decode_scans(r, n, 6 * n_mcu),
                          (rows, lens), (0, 0))
        lv, ok = gather(outs, mesh.flat[0])
        return lv.view(-1, n_mcu, 6, 64), ok
    return fn


def sharded_decode_scans(mesh: Mesh, width: int, height: int):
    """The decode chain of `codecs.amv_video.decode_frames_device` (kernel
    D, the DC prediction, kernel U) with frames over the mesh: unescaped
    scans uint8 [F, stride], lens int64 [F] -> (y, cb, cr display planes,
    ok uint8 [F]).  The JAX function returns pixel blocks for
    `assemble_planes`; kernel U assembles them in its store."""
    n_mcu = ((width + 15) // 16) * ((height + 15) // 16)

    def chain(rows, lens):
        levels, ok = decode_scans(rows, lens, 6 * n_mcu)
        dc = amv_video.resolve_dc(levels.view(-1, n_mcu, 6, 64))
        return (*amv_video.decode_planes(levels.view(-1, 64), dc.view(-1),
                                         width, height), ok)

    def fn(rows, lens):
        outs = map_shards(mesh, chain, (rows, lens), (0, 0))
        return gather(outs, mesh.flat[0])
    return fn


def sharded_encode_planes(mesh: Mesh, mb_w: int, mb_h: int, qmat_key=2,
                          quant: str = "ffmpeg"):
    """The device part of `codecs.amv_video.encode_frames` (kernel V, then
    kernel E's count and its pack at the exact budget) with frames over
    the mesh: (y, cb, cr) display planes -> (words int32 [F, w_used]
    big-endian scan words, bits int32 [F]) for `native.escape_frames`;
    w_used is the longest frame's, as one call gives it."""
    def chain(y, cb, cr):
        f = y.shape[0]
        _check_geometry(mb_w * mb_h, mb_w, mb_h, y.shape[2], y.shape[1])
        lv = amv_video.encode_planes(y, cb, cr, qmat_key, quant)
        return amv_video.pack_levels(lv.view(f, -1, 64))

    def fn(y, cb, cr):
        outs = map_shards(mesh, chain, (y, cb, cr), (0, 0, 0))
        return gather(_pad_words(outs), mesh.flat[0])
    return fn


def sharded_transcode_step(mesh: Mesh, qscale=2, size=None):
    """`pipeline.transcode.transcode_levels_fused` (kernel T's pixel
    entry) with frames over the mesh: levels int16 [F, M, 6, 64] ->
    (re-quantized levels, decoded pixels uint8 [F, M, 6, 8, 8]).  The DC
    prediction is per frame, so no collective."""
    from ..pipeline.transcode import transcode_levels_fused

    def fn(levels_zz):
        outs = map_shards(mesh, lambda lv: transcode_levels_fused(
            lv, qscale, size), (levels_zz,), (0,))
        return gather(outs, mesh.flat[0])
    return fn


def sharded_complete_transcode(mesh: Mesh, n_mcu: int, qmat_key=2,
                               size=None, enc: str = "async",
                               quant: str = "ffmpeg"):
    """`pipeline.transcode.transcode_complete` (kernels D, T or U -> V,
    then E or a record encoder) with frames over the whole mesh:
    unescaped scans uint8 [F, stride], lens int64 [F] -> (words int32
    [F, w_used], bits int32 [F], ok bool [F]); words padded to the
    longest frame of all, as one call trims them."""
    from ..pipeline.transcode import transcode_complete

    def fn(rows, lens):
        outs = map_shards(mesh, lambda r, n: transcode_complete(
            r, n, n_mcu, qmat_key, size, enc, quant), (rows, lens), (0, 0))
        return gather(_pad_words(outs), mesh.flat[0])
    return fn


def sharded_complete_transcode_async(mesh: Mesh, n_mcu: int, qmat_key=2,
                                     size=None, enc: str = "async",
                                     quant: str = "ffmpeg"):
    """`sharded_complete_transcode` returning, as JAX's async chain does,
    (words, bits, ok int32 [mesh.size]): a shard's entry is 1 when every
    frame of it decoded."""
    inner = sharded_complete_transcode(mesh, n_mcu, qmat_key, size, enc,
                                       quant)

    def fn(rows, lens):
        words, bits, ok = inner(rows, lens)
        return words, bits, ok.view(mesh.size, -1).all(1).to(torch.int32)
    return fn


# ------------------------------------------------------------ audio

def sharded_adpcm_decode(mesh: Mesh):
    """Kernel A (`kernels.adpcm.decode_chunks`) with chunks over the mesh:
    (payload uint8 [C, nbytes], pred int32 [C], sidx int32 [C]) -> pcm
    int16 [C, 2 nbytes].  Each chunk carries its own state."""
    def fn(payload, pred, sidx):
        outs = map_shards(mesh, KA.decode_chunks, (payload, pred, sidx),
                          (0, 0, 0))
        return gather(outs, mesh.flat[0])
    return fn


def sharded_adpcm_encode(mesh: Mesh):
    """Kernel Q (`kernels.adpcm.encode_streams`) with streams over the
    mesh: (samples int16 [B, n], reset bool [B, n], sidx0 int32 [B]) ->
    (nibble bytes uint8 [B, n / 2], step index before each even sample
    uint8 [B, n / 2]).  Each stream carries its own state."""
    def fn(samples, reset, sidx0):
        outs = map_shards(mesh, KA.encode_streams, (samples, reset, sidx0),
                          (0, 0, 0))
        return gather(outs, mesh.flat[0])
    return fn


def sharded_g729_decode_scan(mesh: Mesh):
    """Kernel G (`codecs.g729a.decode_frames_scan`) with streams over the
    mesh: (state dict [B, ...], parms int32 [T, B, 16]) -> (the state
    after frame T, pcm int16 [T, B, 80]); the state splits on its stream
    axis, the frames on their B axis, and each stream's T frames stay in
    one launch on its shard's card."""
    from ..codecs.g729a import decode_frames_scan

    def fn(st, parms):
        outs = map_shards(mesh, decode_frames_scan, (st, parms), (0, 1))
        dev = mesh.flat[0]
        return (gather([o[0] for o in outs], dev),
                gather([o[1] for o in outs], dev, axis=1))
    return fn


def sharded_g729_decode_chain(mesh: Mesh):
    """JAX's `_decode_chain` sharding: the port runs the same
    `decode_frames_scan` (kernel G takes all T frames in one launch), so
    this is `sharded_g729_decode_scan`."""
    return sharded_g729_decode_scan(mesh)


def sharded_g729_encode_scan(mesh: Mesh):
    """Kernel K (`codecs.g729a_encoder_batch.encode_frames_scan`) with
    streams over the mesh: (state dict [B, ...], hist float32 [B, 160],
    frames [T, B, 80]) -> (state, hist, parms int32 [T, B, 16])."""
    from ..codecs.g729a_encoder_batch import encode_frames_scan

    def fn(st, hist, frames):
        outs = map_shards(mesh, encode_frames_scan, (st, hist, frames),
                          (0, 0, 1))
        dev = mesh.flat[0]
        return (gather([o[0] for o in outs], dev),
                gather([o[1] for o in outs], dev),
                gather([o[2] for o in outs], dev, axis=1))
    return fn


def sharded_g729_encode_step(mesh: Mesh):
    """One frame of `codecs.g729a_encoder_batch.encode_frame_batch` with
    streams over the mesh: (state, hist [B, 160], samples [B, 80]) ->
    (state, hist, parm int32 [B, 16]); each shard runs
    `encode_frames_scan` on its one frame (kernel K on a card, the plain
    step on the CPU)."""
    scan = sharded_g729_encode_scan(mesh)

    def fn(st, hist, samples):
        st, hist, parms = scan(st, hist, samples[None])
        return st, hist, parms[0]
    return fn
