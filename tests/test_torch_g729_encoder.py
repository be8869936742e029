"""The port's G.729A encoders on the CPU against the JAX package's: the host
encoder (amv_tpu_torch/codecs/g729a_encoder.py, bytes equal for every
preset), the CLI's `-f act` and `.wav -> .act` routes (files equal), and
the batched encoder (codecs/g729a_encoder_batch.py, the plain version of
kernel K) under its stated contract:

* the integer parts (the parity, the 128 code gains, the exact LSF
  rescoring, the state update) equal JAX's given equal inputs;
* its float searches, which sum in another order than XLA and take their
  cosines from a polynomial, agree with JAX's teacher-forced (each frame
  from JAX's own state) in at least 95% of frames;
* decode(encode(x)) reaches corr > 0.8 and segSNR > 4 dB (the bars of
  tests/test_g729_encoder_tpu.py), within 0.5 dB of JAX's on the same
  streams;
* its shadow state equals a decoder's of its frames, every frame.

Kernel K's source runs in tests/test_torch_cuda_emulated.py and on the card
in test_torch_cuda.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amv_tpu import cli as jcli
from amv_tpu.codecs import g729a as JG
from amv_tpu.codecs import g729a_encoder as JH
from amv_tpu.codecs import g729a_encoder_tpu as JE
from amv_tpu.containers import wav as jwav
from amv_tpu_torch import cli
from amv_tpu_torch.codecs import g729a as G
from amv_tpu_torch.codecs import g729a_encoder as H
from amv_tpu_torch.codecs import g729a_encoder_batch as E
from amv_tpu_torch.kernels import g729 as K
from amv_tpu_torch.verify import fixtures, ref_g729

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "amv_tpu_torch", "csrc")
# teacher-forced frames whose 15 parameters must all equal JAX's
AGREEMENT = 0.95
# the quality bars, and the largest segSNR shortfall against JAX's
MIN_CORR, MIN_SEGSNR, SEGSNR_SLACK = 0.8, 4.0, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain encoder is many small torch ops a frame: one thread, so
    the suite's parallel workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _state_t(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


# ------------------------------------------------------------ host encoder

@pytest.mark.parametrize("quality,n_frames", [("fast", 24), ("high", 5),
                                              ("best", 4)])
def test_encode_stream_equals_jax(quality, n_frames):
    """The host encoder's frames equal the JAX package's, bytes, for every
    preset (the last frame's lookahead runs off the stream's end)."""
    sig = fixtures.speechgen(n_frames * 80 + 40, seed=n_frames)
    got = H.encode_stream(sig, quality)
    assert len(got) == n_frames
    assert got == JH.encode_stream(sig, quality)
    np.testing.assert_array_equal(
        H.pack_parameters_batch(np.arange(15 * 4).reshape(4, 15) % 7),
        JH.pack_parameters_batch(np.arange(15 * 4).reshape(4, 15) % 7))


@pytest.mark.parametrize("rate,channels,extra", [
    (8000, 1, []), (22050, 2, []), (8000, 1, ["--max-frames", "5"]),
    (22050, 1, ["-t", "0.5"])])
def test_cli_act_equals_jax(tmp_path, rate, channels, extra):
    """cli.main -i in.wav -f act out.act (the mono mean, resampled to
    8 kHz, through the host encoder's "high" preset) writes
    amv_tpu.cli.main's file: 8 kHz mono, 22,050 Hz stereo, --max-frames,
    and -t (counted at -r's 16 frames a second for a .wav source)."""
    n = int(rate * 0.09)
    pcm = np.stack([fixtures.speechgen(n, seed=c + 1)
                    for c in range(channels)], 1)
    src = tmp_path / "in.wav"
    jwav.write_pcm(str(src), pcm if channels > 1 else pcm[:, 0], rate,
                   channels)
    mine, theirs = tmp_path / "p.act", tmp_path / "j.act"
    assert cli.main(["-i", str(src), "-f", "act", str(mine), "--device",
                     "cpu", *extra]) == 0
    assert jcli.main(["-i", str(src), "-f", "act", str(theirs),
                      *extra]) == 0
    assert mine.read_bytes() == theirs.read_bytes()


# ----------------------------------------------------------- batch encoder

def test_tables_equal_jax():
    """The candidate grid, the history windows and the gain tables are
    the JAX package's."""
    for mine, theirs in ((E.CAND_T, JE._CAND_T), (E.CAND_F, JE._CAND_F),
                         (E.CAND_IDX, JE._CAND_IDX),
                         (E.CAND_VALID1, JE._CAND_VALID1),
                         (E.UWIN, JE._UWIN), (E.GP128, JE._GP128_NP),
                         (E.CB1SUM, JE._CB1SUM_NP)):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(E.INTERP_COEF[:, :10], JE._C1_NP)
    np.testing.assert_array_equal(E.INTERP_COEF[:, 10:], JE._C2_NP)


def test_encode_table_header_matches():
    """csrc/g729_encode_tables.cuh is kernels/g729.py:
    encode_table_header(), its constants are exact, and the polynomial
    cosines of the root search are within float32 rounding of cos(k w)
    (the recurrence to cos 5w gathers a few ulps)."""
    with open(os.path.join(CSRC, "g729_encode_tables.cuh")) as f:
        text = f.read()
    assert text == K.encode_table_header()
    assert f"{float(E.PI_511).hex()}f" in text
    grid = torch.arange(E.N_GRID, dtype=torch.float32) * float(E.PI_511)
    np.testing.assert_allclose(E._cos5(grid).numpy(),
                               np.cos(grid.numpy()[:, None].astype(np.float64)
                                      * np.arange(1, 6)), atol=5e-6)


@functools.lru_cache(maxsize=1)
def _jax_run():
    """Three seeded speech streams of 24 frames through the JAX batch
    encoder frame by frame: the states and hists before each frame, its
    parameters, and the inputs."""
    b, t = 3, 24
    sig = fixtures.speech_streams(b, t * 80, 11).astype(np.float32)
    st, hist = JG.init_state(b), jnp.zeros((b, 160))
    states, hists, parms = [], [], []
    for f in range(t):
        states.append(_state_np(st))
        hists.append(np.asarray(hist))
        st, hist, p = JE.encode_frame_batch(
            st, hist, jnp.asarray(sig[:, f * 80:(f + 1) * 80]))
        parms.append(np.asarray(p))
    states.append(_state_np(st))
    hists.append(np.asarray(hist))
    return sig, states, hists, np.stack(parms)


def test_batch_parity_and_gain_codes_equal_jax():
    """The parity bit of every P1 and the 128 code gains (the decoder's
    gain arithmetic, replayed for every pair) equal the JAX package's."""
    p1 = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(
        E.parity(torch.from_numpy(p1)).numpy(),
        np.asarray(JE._parity_batch(jnp.asarray(p1))))
    _, states, _, _ = _jax_run()
    rng = np.random.default_rng(3)
    for st in states[::12]:
        b = st["exc"].shape[0]
        fc = np.zeros((b, 40), np.int32)
        for row in fc:
            row[rng.choice(40, 4, replace=False)] = rng.choice(
                [8191, -8192, 4000, -12000], 4)
        got = E.gain_codes(_state_t(st), torch.from_numpy(fc)).numpy()
        for c in range(128):
            want = JG.get_gain_code(dict(st), jnp.full(b, c // 16),
                                    jnp.full(b, c % 16), jnp.asarray(fc))
            np.testing.assert_array_equal(got[:, c], np.asarray(want))


def test_batch_lsf_quantizer_equals_jax():
    """Given JAX's own LSF and state, the LSF quantizer (its float
    pre-search, then the exact integer rescoring) chooses JAX's L0-L3."""
    sig, states, hists, _ = _jax_run()
    for f in range(0, len(states) - 1, 3):
        st = states[f]
        x = sig[:, f * 80:(f + 1) * 80] * 0.5
        buf = np.concatenate([hists[f], x], 1)[:, -240:]
        wbuf = buf * JH._WLP.astype(np.float32)
        r = np.stack([np.einsum("bn,bn->b", wbuf[:, :240 - k], wbuf[:, k:])
                      for k in range(11)], 1).astype(np.float32)
        r[:, 0] = np.maximum(r[:, 0] * np.float32(1.0001) + 10, 1e-3)
        r = r * JH._LAG_WINDOW.astype(np.float32)
        lsf = np.asarray(JE._lp_to_lsf_batch(JE._levinson_batch(
            jnp.asarray(r))))
        want = JE._quantize_lsf_batch(dict(st), jnp.asarray(lsf))
        got = E.quantize_lsf(_state_t(st), torch.from_numpy(lsf.copy()))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batch_teacher_forced_agrees_with_jax():
    """Each frame from JAX's own state and hist: the parameters equal
    JAX's in at least 95% of frames, the hist always, and wherever the
    parameters are equal the state after the frame is JAX's exactly (the
    integer state update)."""
    sig, states, hists, parms = _jax_run()
    t, b = parms.shape[:2]
    agree = 0
    for f in range(t):
        st, hist, p = E.encode_frame_batch(
            _state_t(states[f]), torch.from_numpy(hists[f].copy()),
            torch.from_numpy(sig[:, f * 80:(f + 1) * 80]))
        np.testing.assert_array_equal(hist.numpy(), hists[f + 1])
        same = (p.numpy() == parms[f]).all(1)
        agree += int(same.sum())
        for k, _ in G.STATE_FIELDS:
            np.testing.assert_array_equal(
                st[k].numpy()[same], states[f + 1][k][same],
                err_msg=f"frame {f} {k}")
    assert agree >= AGREEMENT * t * b, f"{agree} of {t * b} frames"


def _metrics(sig, frames):
    """decode(frames) against the input: (corr, segSNR) as
    tests/test_g729_encoder_tpu.py measures them."""
    dec = ref_g729.G729Decoder()
    out = np.concatenate([dec.decode_frame(f.tobytes()) for f in frames])
    a = out[400:len(sig)].astype(float)
    r = sig[400:len(sig)].astype(float)
    segs = []
    for s0 in range(0, len(a) - 160, 160):
        e = ((a[s0:s0 + 160] - r[s0:s0 + 160]) ** 2).mean()
        p = (r[s0:s0 + 160] ** 2).mean()
        if p > 1e4:
            segs.append(10 * np.log10(max(p, 1) / max(e, 1)))
    return np.corrcoef(a, r)[0, 1], float(np.mean(segs))


def test_batch_quality_against_jax():
    """decode(encode(x)) of two seeded speech streams (30 frames): corr >
    0.8, segSNR > 4 dB, and within 0.5 dB of the JAX encoder's."""
    sigs = np.stack([fixtures.speechgen(2400, seed=s) for s in (3, 7)])
    mine = E.encode_streams(torch.from_numpy(sigs)).numpy()
    theirs = JE.encode_streams_tpu(sigs)
    assert mine.shape == theirs.shape == (30, 2, 10)
    for b in range(2):
        c, snr = _metrics(sigs[b], mine[:, b])
        _, snr_j = _metrics(sigs[b], theirs[:, b])
        assert c > MIN_CORR, f"stream {b}: corr {c}"
        assert snr > MIN_SEGSNR, f"stream {b}: segSNR {snr}"
        assert snr > snr_j - SEGSNR_SLACK, f"stream {b}: {snr} vs {snr_j}"


def test_batch_shadow_state_tracks_decoder():
    """The encoder's shadow state equals, every frame, the state of the
    port's decoder (the plain version of kernel G) decoding its frames, on
    every field the encoder advances; the packed frames are
    pack_parameters_batch's."""
    b, t = 2, 12
    sig = fixtures.speech_streams(b, t * 80, 4).astype(np.float32)
    st, hist = G.init_state(b, device="cpu"), torch.zeros((b, 160))
    dst = G.init_state(b, device="cpu")
    for f in range(t):
        st, hist, p = E.encode_frame_batch(
            st, hist, torch.from_numpy(sig[:, f * 80:(f + 1) * 80]))
        packed = E.pack_frames(p)
        np.testing.assert_array_equal(
            packed.numpy(), JH.pack_parameters_batch(p.numpy()))
        dst, _ = G.decode_frame_batch(dst, G.unpack_frames(packed[None])[0])
        for k in E.TRACKED:
            np.testing.assert_array_equal(st[k].numpy(), dst[k].numpy(),
                                          err_msg=f"frame {f} {k}")


def test_encode_streams_cpu_route_launches_nothing():
    """CPU tensors take the plain version; K's wrapper refuses them; a
    stream shorter than a frame gives no frames."""
    k0 = K.ENCODE_LAUNCHES
    out = E.encode_streams(np.zeros((2, 170), np.int16))
    assert out.shape == (2, 2, 10) and out.dtype == torch.uint8
    assert K.ENCODE_LAUNCHES == k0
    assert E.encode_streams(np.zeros((3, 79), np.int16)).shape == (0, 3, 10)
    with pytest.raises(ValueError, match="CUDA"):
        K.encode_frames(G.init_state(1, device="cpu"), torch.zeros((1, 160)),
                        torch.zeros((2, 1, 80)))
