"""The port's `-trellis` (the Viterbi IMA-ADPCM quantizer, kernel L's plain
version on the CPU) against the JAX package: `codecs.amv_audio.
encode_stream(trellis=True)` and `codecs.adpcm_trellis.trellis_encode_fast`
on the same seeded inputs, the chain of chunks resolved from right and
from wrong round-1 guesses, and the CLI's `-trellis` file.  Sizes are a
few short chunks (a frame size of 400 samples where the chunk size is
not the point): the JAX function costs ~80 us a sample on the CPU, and
the plain version a few dozen torch operations a sample of the longest
chunk, each round.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from amv_tpu import cli as jax_cli  # noqa: E402
from amv_tpu.codecs import adpcm_trellis as jax_trellis  # noqa: E402
from amv_tpu.codecs import amv_audio as jax_audio  # noqa: E402
from amv_tpu.verify import fixtures  # noqa: E402
from amv_tpu_torch import cli  # noqa: E402
from amv_tpu_torch.codecs import adpcm_trellis as PT  # noqa: E402
from amv_tpu_torch.codecs import amv_audio  # noqa: E402
from amv_tpu_torch.containers import wav  # noqa: E402
from amv_tpu_torch.kernels import adpcm_trellis as L  # noqa: E402
from amv_tpu_torch.verify import ref_adpcm, ref_trellis  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this file runs: the plain trellis is
    thousands of small torch operations in a row, and with the suite's
    parallel workers on the same cores, intra-op threads that wait for
    each other made them ~50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "silence":
        return np.zeros(n, np.int16)
    if kind == "square":                  # full scale: the predictor clips
        return np.where((t // 37) % 2, 32767, -32768).astype(np.int16)
    env = 0.3 + 0.7 * np.abs(np.sin(t * 0.0007))
    x = 12000 * np.sin(t * 0.031) * env + rng.normal(0, 400, n)
    return np.clip(x, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("kind,rate,frame,n,init", [
    ("sine", 22050, 1378, 6 * 1378, 0),     # 6 chunks at 22,050 / 16
    ("sine", 22050, 400, 6 * 400, 0),       # sine + noise, short chunks
    ("silence", 22050, 400, 3 * 400, 0),    # ties everywhere
    ("square", 22050, 400, 3 * 400, 0),     # the clip
    ("sine", 44100, 3675, 2 * 3675, 0),     # the 44,100 / 12 chunk size
    ("sine", 22050, 400, 2 * 400 + 133, 7),  # an odd-length tail
    ("sine", 22050, 400, 400, 88),          # the top start state
])
def test_encode_stream_trellis_matches_jax(kind, rate, frame, n, init):
    x = _signal(kind, n, seed=n)
    got = amv_audio.encode_stream(x, frame, rate, init_step_index=init,
                                  trellis=True, device="cpu")
    want = jax_audio.encode_stream(x, frame, rate, init_step_index=init,
                                   trellis=True)
    assert got == want
    assert len(got) == len(ref_adpcm.chunk_lengths(n, frame, rate))


def _layout(x, frame, rate):
    ns, starts, padded, _ = amv_audio.stream_layout(x, frame, rate)
    return (torch.from_numpy(padded), torch.from_numpy(starts),
            torch.tensor(ns, dtype=torch.int32), ns, starts, padded)


@pytest.mark.parametrize("wrong", ["plus_one", "all_88"])
def test_chain_from_wrong_guesses(wrong):
    """A forced all-wrong round-1 guess takes more rounds and gives the
    same bytes as the sequential encode."""
    x = _signal("sine", 5 * 400, seed=3)
    want = jax_audio.encode_stream(x, 400, 22050, trellis=True)
    xt, st, pairs, ns, starts, padded = _layout(x, 400, 22050)
    truth = torch.tensor([int.from_bytes(c[2:4], "little") for c in want],
                         dtype=torch.int32)
    guess = (truth + 1) % 89 if wrong == "plus_one" else \
        torch.full_like(truth, 88)
    assert bool((guess[1:] != truth[1:]).all())
    out, step, final, rounds = L.encode_chain(xt, st, pairs, 0, guess,
                                              rounds=True)
    assert torch.equal(step, truth)
    assert torch.equal(step[1:], final[:-1])
    assert rounds >= 2
    out = out.numpy()
    for k, c in enumerate(want):
        s = int(starts[k])
        assert out[s // 2: s // 2 + ns[k]].tobytes() == c[8:]
    _, _, _, r_good = L.encode_chain(xt, st, pairs, 0, truth, rounds=True)
    assert r_good == 1


@pytest.mark.parametrize("start", [0, 1, 44, 87, 88])
def test_lanes_match_the_oracles(start):
    """trellis_lanes from each start state against the JAX function and
    the port's numpy copy of it (the oracle chip_smoke.py runs), with a
    predictor that is not the first sample."""
    x = _signal("sine", 3 * 300, seed=start)
    lanes = torch.from_numpy(x.reshape(3, 300))
    lens = torch.tensor([300, 211, 2])
    nib, final = PT.trellis_lanes(lanes, lens, torch.full((3,), start),
                                  torch.tensor([-500, 0, 32767]))
    for a, pred in enumerate((-500, 0, 32767)):
        seg = x[300 * a: 300 * a + int(lens[a])]
        want = jax_trellis.trellis_encode_fast(seg, start, pred)
        assert ref_trellis.trellis_encode_fast(seg, start, pred)[1] == \
            want[1]
        assert np.array_equal(nib[a, :len(seg)].numpy(), want[0])
        assert not nib[a, len(seg):].any()
        assert int(final[a]) == want[1]


def test_trellis_chunks_plain_writes_only_its_chunks():
    """The plain kernel L entry on a subset of chunks, out of order: each
    chunk's bytes at its place, the rest of the buffer untouched."""
    x = _signal("sine", 4 * 400, seed=9)
    xt, st, pairs, ns, starts, _ = _layout(x, 400, 22050)
    pick = torch.tensor([2, 0])
    out = torch.full((xt.numel() // 2,), 0xA5, dtype=torch.uint8)
    step = torch.tensor([5, 60], dtype=torch.int32)
    final = L.trellis_chunks(xt, st[pick], pairs[pick], step,
                             xt[st[pick]].to(torch.int32), out)
    for j, k in enumerate(pick.tolist()):
        s, n = int(starts[k]), ns[k]
        nib, fin = jax_trellis.trellis_encode_fast(x[s:s + 2 * n],
                                                   int(step[j]))
        assert int(final[j]) == fin
        assert np.array_equal(out[s // 2: s // 2 + n].numpy(),
                              (nib[0::2] << 4) | nib[1::2])
    s1 = int(starts[1])
    assert bool((out[s1 // 2: s1 // 2 + ns[1]] == 0xA5).all())
    with pytest.raises(ValueError, match="out must be uint8"):
        L.trellis_chunks(xt, st, pairs, torch.zeros_like(pairs),
                         torch.zeros_like(pairs), out[:-1])
    zeros = torch.zeros_like(pairs)
    for bad in ((st + 1, pairs, zeros), (st, pairs + 1, zeros),
                (st, pairs, zeros + 89)):
        with pytest.raises(ValueError, match="within x"):
            L.trellis_chunks(xt, *bad, zeros, out)


def test_trellis_output_decodes():
    """Every trellis chunk decodes with the ADPCM oracle, and its squared
    error is no larger than the greedy encoder's."""
    x = _signal("sine", 3 * 400, seed=4)
    tre = amv_audio.encode_stream(x, 400, 22050, trellis=True, device="cpu")
    greedy = amv_audio.encode_stream(x, 400, 22050, device="cpu")
    err = []
    for chunks in (tre, greedy):
        pcm = np.concatenate([ref_adpcm.decode_chunk(c) for c in chunks])
        err.append(np.sum((pcm[:len(x)].astype(np.int64) - x) ** 2))
    assert err[0] <= err[1]


def test_cli_trellis_matches_jax(tmp_path):
    """-trellis through both CLIs from .yuv + .wav at 50 fps (chunks of
    441 samples): the same file."""
    n, w, h = 4, 48, 32
    y, cb, cr = fixtures.rotozoom(n, h, w)
    yuv = tmp_path / "in.yuv"
    np.concatenate([p.reshape(n, -1) for p in (y, cb, cr)],
                   axis=1).tofile(yuv)
    wavp = tmp_path / "in.wav"
    wav.write_pcm(str(wavp), _signal("sine", n * 441, seed=5), 22050)
    args = ["-i", str(yuv), "-i", str(wavp), "-f", "amv", "-s", f"{w}x{h}",
            "-r", "50", "-ar", "22050", "-trellis"]
    assert cli.main([*args, str(tmp_path / "port.amv"), "--device",
                     "cpu"]) == 0
    assert jax_cli.main([*args, str(tmp_path / "jax.amv")]) == 0
    assert (tmp_path / "port.amv").read_bytes() == \
        (tmp_path / "jax.amv").read_bytes()
