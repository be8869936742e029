"""amv_tpu_torch.pipeline.serving.AsyncTranscoder and the host stages it
runs (native.unescape_into, native.escape_packed) against the JAX
package, on the CPU.

Byte contract, as tests/test_serving.py holds the JAX class to it: for
any payload stream the served output equals the host re-encode
(`huffman_decode_frames` -> `transcode_levels_fused` ->
`huffman_encode_frame`) payload for payload, in input order, across
batch boundaries, a partial last batch and batches narrower than the row
width, whether the payloads come as a list (`transcode`) or as tables
into a file's bytes (`batches`).  `transcode_bytes` over
AMV_SERVE_THRESHOLD frames takes the served route and gives the
whole-file route's bytes and the JAX package's, with audio chunks or
without.  Tolerance: byte equality.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from amv_tpu.bitstream.entropy import (huffman_decode_frames,  # noqa: E402
                                       huffman_encode_frame)
from amv_tpu.native import entropy_native as jax_native  # noqa: E402
from amv_tpu.pipeline import transcode as jax_transcode  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.containers import riff  # noqa: E402
from amv_tpu_torch.pipeline import serving  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

M = 6  # 2x3 MCUs -> 32x48, tests/test_serving.py's geometry


def _payloads(F, seed=7, spread=True):
    """tests/test_serving.py's synthetic valid scans with strongly varying
    lengths."""
    rng = np.random.default_rng(seed)
    lv = np.zeros((F, M, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-30, 60, (F, M, 6))
    lv[..., 1] = rng.integers(-8, 8, (F, M, 6))
    lv[:, :, :, 9] = rng.integers(-4, 4, (F, M, 6))
    if spread:
        lv[: F // 3, 1:] = 0          # short frames
        lv[F // 3: F // 2, :, :, 20] = 25   # long frames
    return [huffman_encode_frame(lv[f]) for f in range(F)]


def _stride(payloads):
    return native.row_stride([len(p) for p in payloads])


def _want(payloads, qscale=2):
    """The JAX package's host re-encode."""
    import jax.numpy as jnp
    from amv_tpu.pipeline.transcode import transcode_levels_fused
    lv = huffman_decode_frames(payloads, M)
    lv2 = np.asarray(transcode_levels_fused(jnp.asarray(lv), qscale)[0])
    return [huffman_encode_frame(lv2[f]) for f in range(len(payloads))]


def _served(tr, pays, form):
    """The served payloads of `pays`: a list through `transcode`, or
    "tables" through `batches` over the tables `riff.walk` gives into a
    file that interleaves them with audio chunks (the row width bounded
    from the sizes, as `transcode_bytes` bounds it)."""
    if form == "list":
        return tr.transcode(pays)
    data = riff.mux(pays, [bytes(range(5 + i)) for i in range(len(pays) // 2)],
                    width=32, height=48, fps=16)
    _, v_off, v_size, _, _ = riff.walk(data)
    tr.w_bytes = native.row_stride(v_size)
    return [buf[o:o + n].tobytes() for buf, offsets, lens in
            tr.batches(data, v_off, v_size) for o, n in zip(offsets, lens)]


@pytest.mark.parametrize("form", ["list", "tables"])
def test_serving_matches_host_reencode_across_batches(form):
    # 20 frames shortest-first at batch_frames=8: two full batches and a
    # partial one; the first batch holds only short scans, so its rows are
    # narrower than the row width set from the whole input
    pays = sorted(_payloads(20), key=len)
    tr = serving.AsyncTranscoder(M, batch_frames=8, depth=2, device="cpu")
    assert _stride(pays[:8]) < _stride(pays)
    assert _served(tr, pays, form) == _want(pays)
    assert tr.w_bytes == _stride(pays)


def test_serving_lazy_width_guard():
    # w_bytes set from batch 1 rejects a later, wider batch
    pays = sorted(_payloads(16, seed=11), key=len)
    tr = serving.AsyncTranscoder(M, batch_frames=8, depth=2, device="cpu")
    with pytest.raises(ValueError, match="row width"):
        list(tr.stream(pays))
    # the slots are free again after the error: a bounded stream runs
    tr.w_bytes = _stride(pays)
    assert list(tr.stream(pays)) == _want(pays)


def test_serving_malformed_frame_names_its_stream_index():
    """A frame kernel D rejects, in the second batch, raises ValueError
    naming its index in the stream (the JAX class's host fallback raises
    there from the native decoder)."""
    pays = _payloads(12, seed=5)
    bad = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    pays[10] = bad
    with pytest.raises(ValueError):
        huffman_decode_frames([bad], M)
    tr = serving.AsyncTranscoder(M, batch_frames=4, depth=2, device="cpu")
    with pytest.raises(ValueError, match=r"frame\(s\) \[10\] of the stream"):
        tr.transcode(pays)
    # every slot is free again: the batches left in flight were waited for
    good = _payloads(12, seed=6)
    tr.w_bytes = None
    assert tr.transcode(good) == _want(good)


def test_serving_empty_stream():
    tr = serving.AsyncTranscoder(M, device="cpu")
    assert tr.transcode([]) == []
    assert list(tr.stream(iter([]))) == []


def test_serving_rejects_bad_arguments():
    with pytest.raises(ValueError, match="quant"):
        serving.AsyncTranscoder(M, quant="q50", device="cpu")
    with pytest.raises(ValueError, match="picture size"):
        serving.AsyncTranscoder(M, quant="q60", device="cpu")
    with pytest.raises(ValueError, match="MCUs"):
        serving.AsyncTranscoder(M, size=(48, 48), device="cpu")
    with pytest.raises(ValueError, match="batch_frames"):
        serving.AsyncTranscoder(M, batch_frames=0, device="cpu")


@pytest.mark.parametrize("form", ["list", "tables"])
def test_serving_mesh_matches_host_reencode(form):
    """Each batch's frames over a 2-position CPU mesh (tests/test_serving.py
    `test_serving_sharded_mesh_matches_host`), across batches with a short
    last one (20 frames at batch_frames=8: shards of 4, 4, 4, 4, 2, 2)."""
    from amv_tpu_torch.parallel.sharding import make_mesh
    pays = _payloads(20, seed=9)
    tr = serving.AsyncTranscoder(M, batch_frames=8, depth=2,
                                 mesh=make_mesh(["cpu"] * 2))
    assert tr.devices == [torch.device("cpu")] * 2
    assert _served(tr, pays, form) == _want(pays)


def test_serving_mesh_arguments():
    from amv_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match=r"mesh\.size"):
        serving.AsyncTranscoder(M, batch_frames=7, mesh=mesh)
    with pytest.raises(ValueError, match="exclusive"):
        serving.AsyncTranscoder(M, batch_frames=8, device="cpu", mesh=mesh)


def test_serving_mesh_malformed_frame_names_its_stream_index():
    """A frame kernel D rejects in the second shard of the third batch
    raises naming its index in the stream; the slots of every position are
    free again afterwards."""
    from amv_tpu_torch.parallel.sharding import make_mesh
    pays = _payloads(12, seed=5)
    pays[11] = b"\xff\xd8" + b"\xff\x00" * 40 + b"\xff\xd9"
    tr = serving.AsyncTranscoder(M, batch_frames=4, depth=2,
                                 mesh=make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match=r"frame\(s\) \[11\] of the stream"):
        tr.transcode(pays)
    good = _payloads(12, seed=6)
    tr.w_bytes = None
    assert tr.transcode(good) == _want(good)


def _clip(n, h, w, seed, n_audio=0):
    """(payloads, .amv bytes): C-encoded videogen frames with noise, and
    n_audio audio chunks of distinct lengths."""
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    cb, cr = cb[:, :h // 2, :w // 2], cr[:, :h // 2, :w // 2]
    y = np.clip(y.astype(np.int16) + rng.integers(-2, 3, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]
    audio = [rng.integers(0, 256, 30 + i, dtype=np.uint8).tobytes()
             for i in range(n_audio)]
    return pays, riff.mux(pays, audio, width=w, height=h, fps=16)


@pytest.mark.parametrize("w,h,quant,n_audio", [(48, 32, "ffmpeg", 0),
                                               (168, 120, "ffmpeg", 0),
                                               (25, 33, "ffmpeg", 0),
                                               (48, 32, "q60", 0),
                                               (48, 32, "ffmpeg", 5),
                                               (48, 32, "ffmpeg", 9)])
def test_transcode_bytes_serves_long_files(monkeypatch, w, h, quant,
                                           n_audio):
    """Over AMV_SERVE_THRESHOLD frames transcode_bytes takes the served
    route (SERVE_BATCH_FRAMES a batch, here 3, 4 in flight); its bytes
    equal the
    whole-file route's, with fewer audio chunks than frames, more, or
    none.  For quant "ffmpeg"
    they equal the C reference's and the JAX package's, except at
    168x120, where the JAX package's fused transform differs from C in
    the pad rows (ROADMAP queue 3); frames stay below the 4,096 bytes its
    CPU route truncates at.  q60 has no C oracle: the whole-file route is
    the reference.  AsyncTranscoder in batches of 3 gives the same
    payloads at every size and quantizer."""
    pays, data = _clip(7, h, w, seed=w + h, n_audio=n_audio)
    assert max(map(len, pays)) < 4096
    whole = P.transcode_bytes(data, quant=quant, device="cpu")
    made = []

    class Spy(serving.AsyncTranscoder):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append((self.batch_frames, self.depth))

    monkeypatch.setattr(serving, "AsyncTranscoder", Spy)
    monkeypatch.setattr(P, "SERVE_BATCH_FRAMES", 3)    # batches 3, 3, 1
    monkeypatch.setenv("AMV_SERVE_THRESHOLD", "6")
    assert P.transcode_bytes(data, quant=quant, device="cpu") == whole
    monkeypatch.setenv("AMV_SERVE_THRESHOLD", "7")
    assert P.transcode_bytes(data, quant=quant, device="cpu") == whole
    assert made == [(P.SERVE_BATCH_FRAMES, 4), (7, 1)]
    if quant == "ffmpeg":
        assert riff.demux(whole).video_chunks == [
            native.ref_encode_frame(*native.ref_decode_frame(p, w, h), 2)
            for p in pays]
        if (w, h) != (168, 120):
            assert whole == jax_transcode.transcode_bytes(data)
    tr = serving.AsyncTranscoder(((w + 15) // 16) * ((h + 15) // 16),
                                 batch_frames=3, depth=2, size=(w, h),
                                 quant=quant, device="cpu")
    assert tr.transcode(pays) == riff.demux(whole).video_chunks


def _scan_words(rng, f, w_out, fill):
    """Big-endian scan words int32 [f, w_out] and bits int32 [f] with the
    bits past each count zero; fill "ff" makes every byte 0xFF."""
    bits = rng.integers(0, 32 * w_out + 1, f).astype(np.int32)
    bits[rng.random(f) < 0.2] = 0
    raw = (np.full((f, 4 * w_out), 0xFF, np.uint8) if fill == "ff" else
           rng.choice(np.array([0x00, 0x12, 0xFE, 0xFF], np.uint8),
                      (f, 4 * w_out)) if fill == "mixed" else
           rng.integers(0, 256, (f, 4 * w_out), dtype=np.uint8))
    for i in range(f):
        nb = (int(bits[i]) + 7) // 8
        raw[i, nb:] = 0
        if bits[i] % 8:
            raw[i, nb - 1] &= (0xFF << (8 - int(bits[i]) % 8)) & 0xFF
    return raw.view(">u4").astype(np.uint32).view(np.int32), bits


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), f=st.integers(0, 6),
       w_out=st.integers(1, 9), fill=st.sampled_from(["ff", "mixed", "any"]))
def test_escape_packed_matches_jax_escape(seed, f, w_out, fill):
    """The packed escape (word-at-a-time, frames back to back) gives the
    JAX package's escape_frames bytes: words full of 0xFF bytes, every
    bits % 8, zero-bit frames."""
    words, bits = _scan_words(np.random.default_rng(seed), f, w_out, fill)
    buf, offsets, lens = native.escape_packed(words, bits)
    want = jax_native.escape_frames(words, bits)
    assert [buf[o:o + n].tobytes() for o, n in zip(offsets, lens)] == want
    assert native.escape_frames(words, bits) == want
    assert offsets[:1].tolist() == [0][:f]                # back to back
    assert (offsets[1:] == offsets[:-1] + lens[:-1]).all()
    assert len(buf) == sum(map(len, want))
    assert all(len(p) <= 2 * ((int(b) + 7) // 8) + 4
               for p, b in zip(want, bits))


def test_escape_packed_rejects_overflow():
    words = np.zeros((2, 2), np.int32)
    with pytest.raises(ValueError, match="escape failed"):
        native.escape_packed(words, np.array([8, 65], np.int32))
    with pytest.raises(ValueError, match="bits"):
        native.escape_packed(words, np.array([8], np.int32))


def test_unescape_into_a_used_buffer():
    """unescape_into writes the rows unescape_frames makes into the
    caller's buffers, whatever they held before."""
    pays = _payloads(9, seed=2) + [b"\xff\xd8\x12\xff\x00\x34\xff\xd9"]
    rows_w, lens_w = native.unescape_frames(pays)
    stride = _stride(pays)
    buf = np.full(len(pays) * stride + 7, 0xAB, np.uint8)
    lens_buf = np.full(len(pays) + 1, -1, np.int64)
    rows, lens = native.unescape_into(*native.tables(pays), buf, lens_buf)
    assert rows.shape == (len(pays), stride) and rows.flags.c_contiguous
    assert np.shares_memory(rows, buf) and np.shares_memory(lens, lens_buf)
    assert lens.tolist() == lens_w.tolist()
    for i, n in enumerate(lens.tolist()):
        assert rows[i, :n].tobytes() == rows_w[i, :n].tobytes()
    assert lens[-1] == 3 and rows[-1, :3].tolist() == [0x12, 0xFF, 0x34]
    with pytest.raises(ValueError, match="unescape_into"):
        native.unescape_into(*native.tables(pays), buf[:stride], lens_buf)
