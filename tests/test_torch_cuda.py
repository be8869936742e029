"""The port's CUDA kernels against their plain torch versions, on the card.

Every test needs an NVIDIA GPU and nvcc and skips without them.  The GPU
machine has no JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from numpy seeds; the contract is bit-exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu.containers import riff  # noqa: E402
from amv_tpu.native import entropy_native as native  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch.codecs.amv_video import encoder_qmat  # noqa: E402
from amv_tpu_torch.kernels import entropy_decode as D  # noqa: E402
from amv_tpu_torch.kernels import entropy_encode as E  # noqa: E402
from amv_tpu_torch.kernels import transcode as T  # noqa: E402
from amv_tpu_torch.pipeline import transcode as P  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _payloads(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.rotozoom(n, h, w)
    y = np.clip(y.astype(np.int16) + rng.integers(-6, 7, y.shape), 0,
                255).astype(np.uint8)
    return [native.ref_encode_frame(y[i], cb[i], cr[i], 2) for i in range(n)]


def _random_levels(rng, n_blocks, dense=0.15):
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


@pytest.mark.parametrize("qscale,size", [(1, None), (2, (160, 120)),
                                         (31, (40, 24))])
def test_transcode_kernel_matches_plain(dev, qscale, size):
    rng = np.random.default_rng(qscale)
    n_mcu = 80 if size is None else ((size[0] + 15) // 16) * \
        ((size[1] + 15) // 16)
    n = 7 * n_mcu * 6
    lv = torch.from_numpy(_random_levels(rng, n))
    dc = torch.from_numpy(rng.integers(-40000, 40000, n).astype(np.int32))
    q = encoder_qmat(qscale)
    geom = T._geometry(size, n)
    want_lv, want_pix = T.transcode_blocks_plain(lv.to(dev), dc.to(dev), q,
                                                 geom)
    got_lv, got_pix = T.transcode_blocks_pix(lv.to(dev), dc.to(dev), q, size)
    got_lv2 = T.transcode_blocks(lv.to(dev), dc.to(dev), q, size)
    torch.cuda.synchronize()
    assert torch.equal(got_lv, want_lv)
    assert torch.equal(got_pix, want_pix)
    assert torch.equal(got_lv2, want_lv)


def test_decode_kernel_matches_plain_and_c(dev):
    pays = _payloads(12, 120, 160)
    rows, lens = native.unescape_frames(pays)
    rng = np.random.default_rng(3)
    bad = rows.copy()
    bad_lens = lens.copy()
    bad[0, :] = rng.integers(0, 256, bad.shape[1])          # random bytes
    bad_lens[1] //= 3                                        # truncated
    bad[2, 40:48] = 0xFF                                     # invalid code
    for r, ln in ((rows, lens), (bad, bad_lens)):
        rt, lt = torch.from_numpy(r).to(dev), torch.from_numpy(ln).to(dev)
        got = D.decode_scans(rt, lt, 480)
        want = D.decode_scans_plain(rt, lt, 480)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert got[1].tolist()[3:] == [1] * 9
    assert got[1].tolist()[2] == 0


def test_encode_kernel_matches_plain(dev):
    rng = np.random.default_rng(5)
    lv = _random_levels(rng, 9 * 480).reshape(9, 480, 64)
    lv[:, :, 0] = rng.integers(-1023, 1024, (9, 480))
    lt = torch.from_numpy(lv).to(dev)
    for w_out in (64, 4096, 40000):
        got = E.encode_levels(lt, w_out)
        want = E.encode_levels_plain(lt, w_out)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    assert got[2].all() and not E.encode_levels(lt, 64)[2].any()


@pytest.mark.parametrize("w,h", [(160, 120), (40, 24), (36, 20)])
def test_transcode_bytes_cuda_matches_c_reference(dev, w, h):
    pays = _payloads(6, h, w, seed=1)
    data = riff.mux(pays, [], width=w, height=h, fps=16)
    launches = (D.LAUNCHES, T.LAUNCHES, E.LAUNCHES)
    out = riff.demux(P.transcode_bytes(data, qscale=2, device="cuda"))
    want = [native.ref_encode_frame(*native.ref_decode_frame(p, w, h), 2)
            for p in pays]
    assert out.video_chunks == want
    assert all(a > b for a, b in zip((D.LAUNCHES, T.LAUNCHES, E.LAUNCHES),
                                     launches))
