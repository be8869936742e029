"""The port's ACT container (amv_tpu_torch/containers/act.py) and its CLI
routes (`-i rec.act out.wav|out.bit`, `-i in.wav -f act out.act`) on the
CPU against the JAX package's, byte for byte."""

import numpy as np
import pytest
import torch

from amv_tpu import cli as jcli
from amv_tpu.containers import act as JA
from amv_tpu.containers import wav as JW
from amv_tpu_torch import cli
from amv_tpu_torch.containers import act
from amv_tpu_torch.verify import fixtures


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain G.729A decoder is many small torch ops: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n: int, seed: int = 0) -> np.ndarray:
    return fixtures.g729_frames(np.random.default_rng(seed), n, 1,
                                erasure=0.05, bad_parity=0.05,
                                high_pitch=0.1)[:, 0]


@pytest.mark.parametrize("n", [0, 1, 50, 51, 52, 120])
def test_mux_equals_jax(n):
    """The file of n frames (chunks of 51, the trailer's extra zero chunk
    when they end on a chunk's end)."""
    f = _frames(n, n)
    want = JA.mux([bytes(x) for x in f])
    assert act.mux(f) == want
    assert len(want) == 512 * (2 + n // 51)


@pytest.mark.parametrize("n", [0, 1, 50, 51, 52, 120])
def test_demux_equals_jax(n):
    """Every whole chunk's frames (the padding ones read back as zero
    erasures), the rate and the duration; a partial chunk dropped."""
    data = JA.mux([bytes(x) for x in _frames(n, n)], sample_rate=8000)
    for cut in (data, data[:-100]):
        got, rate, dur = act.demux(cut)
        want, rate_j, dur_j = JA.demux(cut)
        assert got.dtype == np.uint8 and got.shape == (len(want), 10)
        assert got.tobytes() == b"".join(want)
        assert (rate, dur) == (rate_j, dur_j)
    assert not act.demux(data)[0][n:].any()


@pytest.mark.parametrize("n", [0, 1, 50, 51, 52, 120])
def test_itu_bitstream_equals_jax(n):
    f = _frames(n, 100 + n)
    assert act.to_itu_bitstream(f) == JA.to_itu_bitstream(
        [bytes(x) for x in f])


def test_probe_equals_jax():
    data = JA.mux([bytes(x) for x in _frames(3)])
    for d in (data, data[:511], b"RIFX" + data[4:],
              data[:256] + b"\x00" + data[257:], bytes(600)):
        assert act.probe(d) == JA.probe(d)
    with pytest.raises(ValueError):
        act.demux(bytes(600))


@pytest.fixture(scope="module")
def act_file(tmp_path_factory):
    """An ACT file of 60 seeded frames (with erasures, bad parity and high
    pitch codes; the first frame good), written by the JAX package."""
    f = _frames(60, 7)
    f[0] = _frames(1, 8)[0] | 1
    path = tmp_path_factory.mktemp("act") / "rec.act"
    path.write_bytes(JA.mux([bytes(x) for x in f]))
    return path


@pytest.mark.parametrize("ext,extra", [(".wav", []),
                                       (".bit", []),
                                       (".wav", ["--max-frames", "17"]),
                                       (".bit", ["-t", "0.33"])])
def test_cli_act_routes_equal_jax(act_file, tmp_path, ext, extra):
    """cli.main -i rec.act out.wav (kernel G's plain version here) and
    out.bit write amv_tpu.cli.main's bytes."""
    mine, theirs = tmp_path / f"p{ext}", tmp_path / f"j{ext}"
    assert cli.main(["-i", str(act_file), str(mine), "--device", "cpu",
                     *extra]) == 0
    assert jcli.main(["-i", str(act_file), str(theirs), *extra]) == 0
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("argv", [["-f", "act", "out.act"], ["out.act"]])
def test_cli_act_encode_refused(tmp_path, argv):
    """-f act and .wav -> .act are no longer refused: both routes write
    amv_tpu.cli.main's file (the host encoder, 8 kHz mono)."""
    src = tmp_path / "in.wav"
    JW.write_pcm(str(src), fixtures.speechgen(400, seed=5), 8000)
    mine, theirs = tmp_path / "p" / argv[-1], tmp_path / "j" / argv[-1]
    mine.parent.mkdir()
    theirs.parent.mkdir()
    assert cli.main(["-i", str(src), *argv[:-1], str(mine), "--device",
                     "cpu"]) == 0
    assert jcli.main(["-i", str(src), *argv[:-1], str(theirs)]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    assert len(act.demux(mine.read_bytes())[0]) >= 5
