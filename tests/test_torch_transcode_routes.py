"""The transcode's record routes, end to end on the CPU.

The record encoder, the rechunk encoder and the parallel encoder (kernel
P's plain version where they use it), escaped by `native.escape_frames`:
through `transcode_complete(..., enc=...)` against
`amv_tpu.pipeline.transcode.transcode_bytes` on clips under 4,096 bytes a
frame (its CPU route packs at most that, ROADMAP queue 3); and through
`encode_route` (the chain's last stage, after one decode and transform a
size) against the C reference transcode `ref_encode_frame(
*ref_decode_frame(p, w, h), qscale)` at 160x120 (half an MCU row of pad),
168x120 (half an MCU column) and 320x240, with frames over 4,096 bytes.
Tolerance: byte equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.containers import riff  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.pipeline import transcode as jax_transcode  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.kernels import entropy_encode as E  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

ROUTES = ["record", "rechunk", "parallel"]


def _payloads(n, h, w, seed=0, noise=2):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w) if seed % 2 else \
        fixtures.videogen(n, h, w, seed=seed)
    y = np.clip(y.astype(np.int16) + rng.integers(-noise, noise + 1, y.shape),
                0, 255).astype(np.uint8)
    return [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]


def _route(pays, w, h, enc):
    rows, lens = native.unescape_frames(pays)
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    words, bits, ok = P.transcode_complete(
        torch.from_numpy(rows), torch.from_numpy(lens), n_mcu, 2, (w, h),
        enc=enc)
    assert ok.all()
    return native.escape_frames(words.numpy(), bits.numpy())


# (width, height): frames, seed, luma noise
SIZES = {(160, 120): (3, 1, 6), (168, 120): (3, 2, 6), (320, 240): (1, 3, 3)}


@pytest.fixture(scope="module", params=list(SIZES),
                ids=[f"{w}x{h}" for w, h in SIZES])
def case(request):
    """(re-encode levels [F, NB, 64], word budget, C reference payloads) of
    a seeded clip of each size, decoded and transformed once."""
    w, h = request.param
    n, seed, noise = SIZES[w, h]
    pays = _payloads(n, h, w, seed=seed, noise=noise)
    assert max(len(p) for p in pays) > 4096
    rows, lens = native.unescape_frames(pays)
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    levels, _ = P.decode_scans(torch.from_numpy(rows), torch.from_numpy(lens),
                               n_mcu * 6)
    dc = P.resolve_dc(levels.reshape(n, n_mcu, 6, 64)).reshape(-1)
    lv2 = P.transcode_blocks(levels.reshape(-1, 64), dc, P.encoder_qmat(2),
                             (w, h))
    want = [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), 2)
            for p in pays]
    return lv2.reshape(levels.shape), P.word_budget(torch.from_numpy(rows)), \
        want


@pytest.mark.parametrize("enc", ROUTES)
def test_route_matches_c_reference(case, enc):
    lv2, budget, want = case
    launches = E.LAUNCHES
    words, bits = P.encode_route(lv2, budget, enc)
    assert E.LAUNCHES == launches        # kernel E stays out of the route
    assert words.shape[1] == (int(bits.max()) + 31) // 32
    assert native.escape_frames(words.numpy(), bits.numpy()) == want


@pytest.fixture(scope="module")
def small_clip():
    """(payloads, JAX transcode_bytes' video chunks) of 4 160x120 frames
    under 4,096 bytes."""
    pays = _payloads(4, 120, 160)
    assert max(len(p) for p in pays) < 4096
    data = riff.mux(pays, [], width=160, height=120, fps=16)
    want = riff.demux(jax_transcode.transcode_bytes(data, qscale=2))
    return pays, want.video_chunks


@pytest.mark.parametrize("enc", ROUTES)
def test_route_matches_jax_transcode_bytes(small_clip, enc):
    pays, want = small_clip
    assert _route(pays, 160, 120, enc) == want


def test_route_repacks_an_overflowing_word_budget():
    """A qscale-1 re-encode of blocks with one +-1023 coefficient in slot
    63 is many times its input scan: the routes pack again with the exact
    budget, as kernel E's `pack_levels` does."""
    from amv_tpu.bitstream.entropy import huffman_encode_frame
    rng = np.random.default_rng(4)
    lv = np.zeros((2, 4, 6, 64), np.int16)
    lv[..., 0] = rng.integers(60, 200, (2, 4, 6))
    lv[..., 63] = rng.choice([-1023, 1023], (2, 4, 6))
    pays = [huffman_encode_frame(lv[f]) for f in range(2)]
    rows, lens = native.unescape_frames(pays)
    want = [native.ref_encode_frame(*native.ref_decode_frame(p, 32, 32), 1)
            for p in pays]
    for enc in ROUTES:
        words, bits, _ = P.transcode_complete(
            torch.from_numpy(rows), torch.from_numpy(lens), 4, 1, (32, 32),
            enc=enc)
        assert words.shape[1] > P.word_budget(torch.from_numpy(rows))
        assert native.escape_frames(words.numpy(), bits.numpy()) == want


def test_unknown_route_raises():
    rows = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="enc must be one of"):
        P.transcode_complete(rows, torch.zeros(1, dtype=torch.int64), 1, 2,
                             enc="lockstep")
