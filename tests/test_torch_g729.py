"""The port's G.729A decoder (amv_tpu_torch/codecs/g729a.py, the plain
version of kernel G) on the CPU against the JAX package's decoder and the
scalar oracle, bit for bit; its copies of the oracle and the tables; and
kernel G's table header.  Kernel G's source runs in
tests/test_torch_cuda_emulated.py and on the card in test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from amv_tpu.codecs import g729a as J
from amv_tpu.codecs import g729_tables as JT
from amv_tpu.verify import ref_g729 as JR
from amv_tpu_torch.codecs import g729_tables as PT
from amv_tpu_torch.codecs import g729a as G
from amv_tpu_torch.kernels import g729 as K
from amv_tpu_torch.verify import fixtures
from amv_tpu_torch.verify import ref_g729 as PR

from test_g729_tpu import _streams

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "amv_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain decoder is thousands of small torch ops a frame: one
    thread, so the suite's parallel workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle(frames: np.ndarray) -> np.ndarray:
    """Each stream of frames uint8 [T, B, 10] through the JAX package's
    scalar oracle -> int16 [B, T*80]."""
    out = []
    for b in range(frames.shape[1]):
        dec = JR.G729Decoder()
        out.append(np.concatenate([dec.decode_frame(f.tobytes())
                                   for f in frames[:, b]]))
    return np.stack(out)


def coverage(frames, monkeypatch):
    """(the plain decoder's PCM [B, T*80], the subframes whose first LP
    synthesis overflowed, the least pitch lag of any subframe)."""
    redo, lags = [0], []
    synth, ac = G.lp_synthesis_filter, G.decode_ac_vector

    def counted_synth(lp, inp, fd, clip_output):
        out = synth(lp, inp, fd, clip_output=clip_output)
        if not clip_output:
            redo[0] += int(out[2].sum())
        return out

    def counted_ac(exc, pd_int, pd_frac, off):
        lags.append(int(pd_int.min()))
        return ac(exc, pd_int, pd_frac, off)

    monkeypatch.setattr(G, "lp_synthesis_filter", counted_synth)
    monkeypatch.setattr(G, "decode_ac_vector", counted_ac)
    pcm = G.decode_streams(frames).numpy()
    monkeypatch.undo()
    return pcm, redo[0], min(lags)


def test_decode_streams_matches_jax():
    """T = 16, B = 4 with erasures, bad parity and high pitch codes at
    tests/test_g729_tpu.py's positions: the port's plain decode equals
    amv_tpu.codecs.g729a.decode_streams (JAX on the CPU) and the oracle."""
    rng = np.random.default_rng(22)
    frames = _streams(rng, T=16, B=4, erasures={(5, 0), (6, 0), (9, 2)},
                      bad_parity={(3, 1), (12, 3)},
                      high_pitch={(2, 2), (8, 1)})
    got = G.decode_streams(frames)
    assert got.dtype == torch.int16 and got.shape == (4, 16 * 80)
    np.testing.assert_array_equal(got.numpy(), J.decode_streams(frames))
    np.testing.assert_array_equal(got.numpy(), oracle(frames))


def test_minimum_pitch_delay_matches_oracle(monkeypatch):
    """Pitch codes P1 = 0 (the least delay, 19 1/3) and others below 20:
    lags under the subframe's 40 samples, where the interpolation reads
    what it wrote in the same subframe."""
    rng = np.random.default_rng(41)
    frames = fixtures.g729_frames(rng, 14, 3, low_pitch=0.6)
    # P1 = 0, with its parity P0
    fixtures.g729_set_field(frames[2, 0], 18, 8, 0)
    fixtures.g729_set_field(frames[2, 0], 26, 1, 1)
    pcm, _, least = coverage(frames, monkeypatch)
    assert least == 19
    assert J.unpack_frames(frames)[2, 0, 5] == 0
    np.testing.assert_array_equal(pcm, oracle(frames))


def test_leading_erasures_match_jax(monkeypatch):
    """Erasures before any good frame (lags 0, 1, 2, where the
    interpolation reads the buffer's zero tail; the oracle's C original
    reads past its buffer there, PARITY.md) and pitch codes below 20,
    against JAX at tests/test_g729_tpu.py's shape."""
    rng = np.random.default_rng(43)
    frames = fixtures.g729_frames(rng, 16, 4, erasure=0.05, bad_parity=0.05,
                                  low_pitch=0.3)
    frames[:3, 1] = 0
    frames[0, 3] = 0
    pcm, _, least = coverage(frames, monkeypatch)
    assert least == 0
    np.testing.assert_array_equal(pcm, J.decode_streams(frames))


def test_overflow_redo_matches_oracle(monkeypatch):
    """A stream at the largest pitch gain, whose LP synthesis overflows:
    the whole excitation buffer is scaled by 1/4 and the subframe
    synthesised again; beside it two streams of random frames."""
    rng = np.random.default_rng(1)
    frames = fixtures.g729_frames(rng, 12, 3, erasure=0.1, bad_parity=0.1,
                                  high_pitch=0.1)
    frames[0] = fixtures.g729_frames(rng, 1, 3)[0]   # no leading erasure
    fixtures.g729_loud(frames[:, 1])
    pcm, redo, _ = coverage(frames, monkeypatch)
    assert redo > 0, "no subframe took the overflow redo"
    np.testing.assert_array_equal(pcm, oracle(frames))


def test_encoded_speech_matches_oracle():
    """Frames of amv_tpu's G.729A encoder from a speech-like signal (as
    tests/test_g729_encoder.py makes it)."""
    from amv_tpu.codecs.g729a_encoder import encode_stream
    from test_g729_encoder import _speechlike
    frames = np.frombuffer(b"".join(encode_stream(_speechlike(1600))),
                           np.uint8).reshape(-1, 1, 10)
    assert len(frames) == 20
    np.testing.assert_array_equal(G.decode_streams(frames).numpy(),
                                  oracle(frames))


def test_state_windows_chain():
    """decode_frames_scan over two windows, the state carried across,
    equals one run over both (PCM and every state field)."""
    rng = np.random.default_rng(7)
    frames = fixtures.g729_frames(rng, 12, 3, erasure=0.1, bad_parity=0.1,
                                  high_pitch=0.2)
    parms = G.unpack_frames(frames)
    st0 = G.init_state(3, device="cpu")
    st_a, pcm_a = G.decode_frames_scan(st0, parms[:5])
    st_b, pcm_b = G.decode_frames_scan(st_a, parms[5:])
    st_c, pcm_c = G.decode_frames_scan(st0, parms)
    assert torch.equal(torch.cat([pcm_a, pcm_b]), pcm_c)
    for k, shape in G.STATE_FIELDS:
        assert st_b[k].shape == (3,) + shape and st_b[k].dtype == torch.int32
        assert torch.equal(st_b[k], st_c[k]), k
    # the state of init_state is JAX's
    for k, v in J.init_state(3).items():
        np.testing.assert_array_equal(st0[k].numpy(), np.asarray(v), k)


def test_unpack_frames_matches_jax():
    rng = np.random.default_rng(23)
    frames = fixtures.g729_frames(rng, 9, 7, erasure=0.2, high_pitch=0.3)
    got = G.unpack_frames(frames)
    assert got.dtype == torch.int32 and got.shape == (9, 7, 16)
    np.testing.assert_array_equal(got.numpy(), J.unpack_frames(frames))
    np.testing.assert_array_equal(
        G.unpack_frames(torch.from_numpy(frames)).numpy(), got.numpy())


def test_frame_fixture_fields():
    """fixtures.g729_frames: valid parity unless flipped, the pitch ranges
    and the shares asked for."""
    rng = np.random.default_rng(3)
    frames = fixtures.g729_frames(rng, 200, 50, erasure=0.1,
                                  bad_parity=0.1, high_pitch=0.2,
                                  low_pitch=0.2)
    p = J.unpack_frames(frames)
    live = p[..., 15] == 0
    assert 0.07 < 1 - live.mean() < 0.13
    bad = np.array([JR.parity_check(int(a), int(b)) == 0 for a, b in
                    zip(p[..., 5][live], p[..., 4][live])])
    assert 0.07 < bad.mean() < 0.13
    p1 = p[..., 5][live]
    assert 0.17 < (p1 >= 197).mean() < 0.23
    assert 0.17 < (p1 < 20).mean() < 0.23
    for (lo, n), k in zip(G.PARM_BITS, range(15)):
        assert p[..., k].max() < 1 << n


def test_oracle_copy_equals_jax_oracle():
    """verify/ref_g729.py and codecs/g729_tables.py are copies of the JAX
    package's: the same tables, the same PCM from the same frames."""
    for name in dir(JT):
        if isinstance(getattr(JT, name), np.ndarray):
            np.testing.assert_array_equal(getattr(PT, name),
                                          getattr(JT, name), name)
    rng = np.random.default_rng(9)
    frames = fixtures.g729_frames(rng, 10, 1, erasure=0.2, bad_parity=0.2)
    a, b = JR.G729Decoder(), PR.G729Decoder()
    for f in frames[:, 0]:
        assert JR.bytes2parm(f.tobytes()) == PR.bytes2parm(f.tobytes())
        np.testing.assert_array_equal(a.decode_frame(f.tobytes()),
                                      b.decode_frame(f.tobytes()))
    for p1 in range(256):
        assert PR.parity_check(p1, 0) == JR.parity_check(p1, 0)


def test_table_header_matches_tables():
    """csrc/g729_tables.cuh is kernels/g729.py:table_header() of the
    port's tables."""
    with open(os.path.join(CSRC, "g729_tables.cuh")) as f:
        assert f.read() == K.table_header()


def test_cpu_route_launches_nothing():
    """CPU tensors take the plain version; the kernel's wrapper refuses
    them."""
    l0 = K.LAUNCHES
    st = G.init_state(1, device="cpu")
    st, pcm = G.decode_frames_scan(st, torch.zeros((2, 1, 16),
                                                   dtype=torch.int32))
    assert pcm.shape == (2, 1, 80) and K.LAUNCHES == l0
    with pytest.raises(ValueError, match="CUDA"):
        K.decode_frames(st, torch.zeros((2, 1, 16), dtype=torch.int32))
    assert G.decode_streams(np.zeros((0, 2, 10), np.uint8)).shape == (2, 0)
    flat = K.flatten_state(st)
    assert flat.shape == (1, K.STATE_WORDS) == (1, 546)
    for k, v in K.unflatten_state(flat).items():
        assert torch.equal(v, st[k]), k
