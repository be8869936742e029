"""The frozen references against their known answers at tiny sizes, and
against the program's own C and Python oracles (amv_tpu_torch/native,
verify/ref_g729.py, the containers), which the references were frozen
from."""

import hashlib

import numpy as np
import pytest

from portbench import corpus
from portbench.reference import amv, g729


def digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


@pytest.fixture(scope="module")
def pics():
    y, cb, cr = corpus.pictures(8, 120, 160, 3)
    return y, cb, cr, amv.encode_pictures(y, cb, cr, 2, threads=2)


def test_known_answers():
    y, cb, cr = corpus.pictures(8, 120, 160, 3)
    assert digest(y.tobytes() + cb.tobytes() + cr.tobytes()) == \
        "c3eb9b04d25a5713"
    pays = amv.encode_pictures(y, cb, cr, 2, threads=2)
    assert digest(b"".join(pays)) == "ec147980d7edc1d4"
    assert digest(b"".join(amv.transcode_frames(pays, 160, 120, 2,
                                                threads=2))) == \
        "306280cdc1122497"
    fr = corpus.g729_frames(50, 2, 12345, "cpu").numpy()
    assert digest(fr.tobytes()) == "8a276ecdbca8bec4"
    pcm = g729.decode(fr[:, 0])
    assert digest(pcm.tobytes()) == "bea311eb2a62623e"
    assert pcm[400:404].tolist() == [200, 472, 721, 33]


def test_amv_reference_matches_the_c_oracle(pics):
    from amv_tpu_torch import native
    y, cb, cr, pays = pics
    for i, p in enumerate(pays):
        assert p == native.ref_encode_frame(y[i], cb[i], cr[i], 2)
    got = amv.transcode_frames(pays, 160, 120, 2, threads=2)
    for p, g in zip(pays, got):
        assert g == native.ref_encode_frame(
            *native.ref_decode_frame(p, 160, 120), 2)


def test_amv_control_differs(pics):
    pays = pics[3]
    ok = amv.transcode_frames(pays, 160, 120, 2, threads=2)
    ctl = amv.transcode_frames(pays, 160, 120, 2, drop_bits=1, threads=2)
    assert all(a != b for a, b in zip(ok, ctl))


def test_amv_mux_matches_ffmpegs_layout(pics):
    from amv_tpu_torch.containers import riff
    video = pics[3][:5]
    audio = corpus.adpcm_chunks(4, 1378, 1)     # fewer: the tail drains
    for fps in (16, 12):
        assert amv.mux(video, audio, width=160, height=120, fps=fps,
                       sample_rate=22050) == \
            riff.mux(video, audio, width=160, height=120, fps=fps,
                     sample_rate=22050)


def test_scan_bytes_drops_markers_and_stuffing():
    assert amv.scan_bytes(b"\xff\xd8\x12\xff\x00\x34\xff\xd9") == 3


def test_g729_reference_matches_the_python_oracle():
    from amv_tpu_torch.verify import fixtures, ref_g729
    rng = np.random.default_rng(5)
    a = fixtures.g729_frames(rng, 40, 3, erasure=0.1, bad_parity=0.1,
                             high_pitch=0.2, low_pitch=0.1)
    loud = fixtures.g729_frames(rng, 40, 1)
    fixtures.g729_loud(loud)
    streams = [a[:, b] for b in range(3)] + [loud[:, 0]]
    for s in streams:
        s[0] = fixtures.g729_frames(rng, 1, 1)[0, 0]   # no erasure first
    for s, got in zip(streams, g729.decode_many(streams, threads=2)):
        want = ref_g729.decode_stream([bytes(f) for f in s])
        assert np.array_equal(got, want)


def test_g729_control_is_eight_bits():
    pcm = np.array([1, -1, 300, -300, 32767], np.int16)
    assert g729.control(pcm).tolist() == [0, -256, 256, -512, 32512]


def test_act_container_matches_ffmpegs():
    from amv_tpu_torch.containers import act
    for n in (0, 50, 51, 52, 600):
        f = corpus.g729_frames(n, 1, n, "cpu").numpy()[:, 0] if n else \
            np.zeros((0, 10), np.uint8)
        data = g729.act_mux(f)
        assert data == act.mux(f)
        assert np.array_equal(g729.act_demux(data), act.demux(data)[0])
        assert np.array_equal(g729.act_demux(data)[:n], f)


def test_wav_reader_refuses_other_headers():
    from amv_tpu_torch.containers import wav
    import os
    import tempfile
    pcm = np.arange(-50, 50, dtype=np.int16)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.wav")
        wav.write_pcm(p, pcm, 8000, 1)
        data = open(p, "rb").read()
    assert np.array_equal(g729.wav_pcm(data, 8000), pcm)
    with pytest.raises(ValueError):
        g729.wav_pcm(data, 16000)
    with pytest.raises(ValueError):
        g729.wav_pcm(data[:-2], 8000)
