"""Every input the benchmark makes is fixed by its seed: the same seed
gives the same inputs, another seed other content on the same sizes."""

import numpy as np
import pytest

from portbench import corpus
from portbench import run as R
from portbench.reference import g729 as ref
from portbench.trace import Spans

from test_portbench_faults import TINY

SEEDS = (7, 2**31 + 11, 2**33 + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_pictures_follow_the_seed(seed):
    a = corpus.pictures(48, 120, 160, seed)
    b = corpus.pictures(48, 120, 160, seed)
    c = corpus.pictures(48, 120, 160, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (48, 120, 160) and a[1].shape == (48, 60, 80)


@pytest.mark.parametrize("seed", SEEDS)
def test_g729_frames_follow_the_seed_and_keep_the_parity(seed):
    a = corpus.g729_frames(30, 4, seed, "cpu").numpy()
    b = corpus.g729_frames(30, 4, seed, "cpu").numpy()
    c = corpus.g729_frames(30, 4, seed + 1, "cpu").numpy()
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    bits = np.unpackbits(a, axis=-1).astype(np.int64)
    p1 = (bits[..., 18:26] * (1 << np.arange(7, -1, -1))).sum(-1)
    assert ((p1 >= 60) & (p1 < 197)).all()
    parity = ((corpus.G729_PARITY >> (p1 >> 2)) ^ bits[..., 26]) & 1
    assert (parity == 1).all()            # every frame's parity is valid
    assert a.any(axis=-1).all()           # no erasures


def test_adpcm_chunks_follow_the_seed():
    a, b = corpus.adpcm_chunks(4, 1378, 3), corpus.adpcm_chunks(4, 1378, 3)
    assert a == b and a != corpus.adpcm_chunks(4, 1378, 4)
    assert all(len(c) == 8 + 689 for c in a)


def _inputs(cell, seed):
    spec = R.cell_spec(cell)
    spec["traffic"]["params"].update(TINY[cell])
    d = R.make_driver(spec, seed, Spans(False), device="cpu")
    d.make_inputs()
    return d


@pytest.mark.parametrize("cell", sorted(TINY))
def test_driver_inputs_follow_the_seed(cell):
    a, b, c = (_inputs(cell, s) for s in (2**31 + 3, 2**31 + 3, 12))
    try:
        if cell == "amv.films":
            assert a.files == b.files and a.files != c.files
            assert sorted(f["frames"] for f in a.films) == \
                sorted(f["frames"] for f in c.films)
        elif cell == "act.library_decode":
            assert a.files == b.files and a.files != c.files
            assert list(a.sample) == list(b.sample)
        else:
            read = lambda d: [open(p, "rb").read() for p in d.paths]
            assert read(a) == read(b) and read(a) != read(c)
            assert sorted(a.lengths) == sorted(c.lengths)
            assert a.extra == b.extra
            assert [len(ref.act_demux(x)) for x in read(a)] == a.n_frames
    finally:
        for d in (a, b, c):
            if hasattr(d, "close"):
                d.close()


@pytest.mark.parametrize("k", [1, 2, 7, 8, 64])
def test_balanced_order_pairs_short_with_long(k):
    from portbench.drivers import balanced_order
    a = balanced_order(k, np.random.default_rng(1))
    b = balanced_order(k, np.random.default_rng(1))
    assert a == b and sorted(a) == list(range(k))
    for j in range(0, k - 1, 2):
        assert a[j] + a[j + 1] == k - 1       # each pair sums the same
