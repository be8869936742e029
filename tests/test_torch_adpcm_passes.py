"""A numpy model of kernel Q's passes (amv_tpu_torch/csrc/adpcm_encode.cu),
held against the port's plain encoder, `amv_tpu`'s Pallas encoder in
interpret mode and a naive serial loop.

The model mirrors the kernel: a stream is cut into windows of L samples;
the segment of window w starts at its first even sample with a reset
(window 0 at sample 0) and runs to the next window's segment start, so a
window with no even reset has an empty segment (the identity map).
Pass 1 walks a window's segment from each of the 89 start step indices,
three to a lane of one warp, with the division-free quantizer step, and
merges equal (predictor, step index) states every 64 samples: once at
most 32 remain, each keeps one lane and a start -> lane map gives the 89
ends.  It also records every start's state at each run of T samples of
the segment (the checkpoints).  Pass 2 composes the window maps in groups
of G, walks the group maps from each stream's sidx0, then each group's
window maps from the group's start.  Pass 3 encodes each run of T samples
on its own: the first from the segment's resolved start, the others from
the checkpoint of that start.

    PYTHONPATH=. python tests/test_torch_adpcm_passes.py

prints the collapse statistics of the main path's audio (seeded audiogen,
22,050 Hz, chunks of 1,378 samples).  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels.adpcm_encode_pallas import encode_streams_pallas  # noqa: E402
from amv_tpu.verify import ref_adpcm  # noqa: E402
from amv_tpu_torch.kernels import adpcm as A  # noqa: E402
from amv_tpu_torch.verify.ref_adpcm import STEP_TABLE  # noqa: E402

STEPS = np.asarray(STEP_TABLE, np.int64)
MERGE_AT, CHECK = 32, 64       # csrc/adpcm_encode.cu: a warp, kCheck


def quantize(delta, step):
    """The kernel's division-free magnitude: min(7, 4 |delta| // step) by
    three compare-and-subtract stages."""
    q = np.abs(delta) << 2
    mag = np.zeros_like(q)
    for k in (4, 2, 1):
        ge = q >= k * step
        mag = mag + np.where(ge, k, 0)
        q = np.where(ge, q - k * step, q)
    return mag


def compress(p, s, x):
    """One adpcm_ima_compress_sample step on arrays -> (p, s, nibble)."""
    step = STEPS[s]
    delta = x - p
    mag = quantize(delta, step)
    recon = (step * (2 * mag + 1)) >> 3
    p = np.clip(np.where(delta < 0, p - recon, p + recon), -32768, 32767)
    s = np.clip(s + np.where(mag < 4, -1, 2 * mag - 6), 0, 88)
    return p, s, mag | np.where(delta < 0, 8, 0)


def window_segment(reset, w, win):
    """(start, end) of window w's segment in a stream's reset flags; empty
    (start == end) where the window holds no even reset."""
    n = len(reset)
    lo, hi = w * win, min((w + 1) * win, n)
    ev = [t for t in range(lo, hi, 2) if w == 0 and t == 0 or reset[t]]
    if not ev:
        return lo, lo
    nxt = [t for t in range(hi, n, 2) if reset[t]]
    return ev[0], nxt[0] if nxt else n


def merge(p, s):
    """The merge rule over the 89 start slots: (keep, lane_of) where keep
    lists the slots whose state is the first of its kind, lane_of[i] the
    lane of slot i's state; None while more than MERGE_AT states remain."""
    key = (p + 32768) * 128 + s
    first = {}
    rep = np.array([first.setdefault(k, i) for i, k in enumerate(key)])
    keep = np.flatnonzero(rep == np.arange(89))
    if len(keep) > MERGE_AT:
        return None
    rank = np.cumsum(rep == np.arange(89)) - 1
    return keep, rank[rep]


def pass1(x, reset, start, end, run=256, stats=None):
    """(end step index of the segment [start, end) from each start 0..88,
    {sample: (p, s) [89] of each start before it} at every run samples):
    89 states (three slots a lane) until a check finds at most MERGE_AT
    distinct, then one lane each."""
    p = np.zeros(89, np.int64)
    s = np.arange(89, dtype=np.int64)
    lane_of = np.arange(89)
    merged = False
    ckpt = {}
    for t in range(start, end):
        if (t - start) % run == 0 and t > start:
            ckpt[t] = (p[lane_of].copy(), s[lane_of].copy())
        if (t - start) % CHECK == 0 and t > start and not merged:
            m = merge(p, s)
            if m is not None:
                keep, lane_of = m
                p, s, merged = p[keep], s[keep], True
                if stats is not None:
                    stats.append((t - start, len(keep)))
        v = int(x[t])
        if reset[t]:
            p = np.full_like(p, v)
        p, s, _ = compress(p, s, v)
    if stats is not None and not merged:
        stats.append((None, len(set(zip(p.tolist(), s.tolist())))))
    return s[lane_of], ckpt


def pass2(ends, sidx0, group):
    """Window starts [W] of one stream from its window maps [W, 89]: group
    maps, the chain over the groups, then the chain inside each group."""
    n_w = len(ends)
    gmaps = []
    for g0 in range(0, n_w, group):
        s = np.arange(89)
        for w in range(g0, min(g0 + group, n_w)):
            s = ends[w][s]
        gmaps.append(s)
    s = min(max(int(sidx0), 0), 88)
    starts = np.zeros(n_w, np.int64)
    for gi, g0 in enumerate(range(0, n_w, group)):
        si = s
        for w in range(g0, min(g0 + group, n_w)):
            starts[w] = si
            si = ends[w][si]
        s = gmaps[gi][s]
    return starts


def pass3(x, reset, start, end, p, s, out, sidx_even):
    """Encode the run [start, end) from the state (p, s)."""
    for t in range(start, end, 2):
        sidx_even[t // 2] = s
        nib = []
        for u in (t, t + 1):
            if reset[u]:
                p = int(x[u])
            pa, sa, na = compress(np.array([p]), np.array([s]), int(x[u]))
            p, s = int(pa[0]), int(sa[0])
            nib.append(int(na[0]))
        out[t // 2] = (nib[0] << 4) | nib[1]


def model_encode(x, reset, sidx0, repeat=1, win=64, group=4, run=32,
                 stats=None):
    """The model's (bytes, sidx_even) for encode_streams' contract."""
    b, n = x.shape
    x = x.astype(np.int64)
    out = np.zeros((b, n // 2), np.uint8)
    sx = np.zeros((b, n // 2), np.uint8)
    n_w = -(-n // win)
    for bi in range(b):
        segs = [window_segment(reset[bi], w, win) for w in range(n_w)]
        walks = [pass1(x[bi], reset[bi], a, e, run, stats) if e > a
                 else (np.arange(89), {}) for a, e in segs]
        starts = pass2(np.array([e for e, _ in walks]), sidx0[bi], group)
        for (a, e), (_, ckpt), s in zip(segs, walks, starts):
            for t in range(a, e, run):
                p, si = (0, int(s)) if t == a else (
                    int(ckpt[t][0][s]), int(ckpt[t][1][s]))
                pass3(x[bi], reset[bi], t, min(t + run, e), p, si, out[bi],
                      sx[bi])
    return np.tile(out, (repeat, 1)), np.tile(sx, (repeat, 1))


def naive_encode(x, reset, sidx0):
    p, s, nib, before = 0, min(max(int(sidx0), 0), 88), [], []
    for t, v in enumerate(x):
        if reset[t]:
            p = int(v)
        before.append(s)
        n, p, s = ref_adpcm.compress_sample(p, s, int(v))
        nib.append(n)
    nib = np.array(nib)
    return (((nib[0::2] << 4) | nib[1::2]).astype(np.uint8),
            np.array(before[0::2], np.uint8))


def test_division_free_step_is_exact():
    """min(7, 4 |delta| // step) for every |delta| <= 65,535 and all 89
    steps."""
    d = np.arange(65536, dtype=np.int64)[:, None]
    got = quantize(d, STEPS[None, :])
    want = np.minimum(7, (d << 2) // STEPS[None, :])
    assert np.array_equal(got, want)


def _inputs(case, b=3, n=1400, seed=7):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.integers(-1500, 1500, (b, n)), axis=1).clip(
        -32768, 32767).astype(np.int16)
    x[1, ::5] = rng.choice([-32768, 32767], len(x[1, ::5]))
    reset = np.zeros((b, n), bool)
    sidx0 = np.array([0, 88, 41], np.int32)[:b]
    if case == "chunks":
        reset[:, ::138] = True
    elif case == "odd":
        reset[:, ::138] = True
        reset[0, [77, 301, 555]] = True
        reset[2, 5] = True
    elif case == "uneven":
        reset[0, ::138] = True
        reset[1, ::30] = True                      # many short segments
        reset[2, [0, 1200]] = True                 # two long ones
    elif case == "no_reset_at_0":
        reset[:, 40::138] = True
    elif case == "sidx88":
        reset[:, ::138] = True
        sidx0[:] = 88
    return x, reset, sidx0


CASES = ["chunks", "odd", "uneven", "none", "no_reset_at_0", "sidx88"]


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_and_serial_loop(case):
    x, reset, sidx0 = _inputs(case)
    got = model_encode(x, reset, sidx0)
    want = A.encode_streams_plain(*(torch.from_numpy(a) for a in
                                    (x, reset, sidx0)))
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
    for bi in range(x.shape[0]):
        nb, ns = naive_encode(x[bi], reset[bi], sidx0[bi])
        assert np.array_equal(got[0][bi], nb)
        assert np.array_equal(got[1][bi], ns)


@pytest.mark.parametrize("case", ["odd", "none"])
def test_model_matches_pallas_interpret(case):
    x, reset, sidx0 = _inputs(case, n=600)
    got = model_encode(x, reset, sidx0, repeat=3, win=96, group=2)
    want_b, want_s = encode_streams_pallas(
        jnp.asarray(np.tile(x, (3, 1))), jnp.asarray(np.tile(reset, (3, 1))),
        jnp.asarray(np.tile(sidx0, 3)), interpret=True)
    assert np.array_equal(got[0], np.asarray(want_b))
    assert np.array_equal(got[1], np.asarray(want_s))


def test_merge_rule_keeps_one_lane_per_state():
    rng = np.random.default_rng(3)
    p = rng.integers(-3, 3, 89)
    s = rng.integers(0, 5, 89)
    keep, lane_of = merge(p, s)
    assert len(keep) == len(set(zip(p.tolist(), s.tolist()))) <= MERGE_AT
    assert np.array_equal(p[keep][lane_of], p)
    assert np.array_equal(s[keep][lane_of], s)
    assert merge(np.arange(89), np.zeros(89, np.int64)) is None


@pytest.mark.parametrize("shape", [(0, 8), (2, 0)])
def test_encode_streams_empty(shape):
    x = torch.zeros(shape, dtype=torch.int16)
    got = A.encode_streams(x, x.bool(), torch.zeros(shape[0],
                                                    dtype=torch.int32),
                           repeat=2)
    for t in got:
        assert t.shape == (2 * shape[0], shape[1] // 2)
        assert t.dtype == torch.uint8


def collapse_stats(seconds=20.0):
    """Merge points and the states left on the main path's audio."""
    from amv_tpu_torch.codecs import amv_audio
    from amv_tpu_torch.verify import fixtures
    pcm = fixtures.audiogen(seconds, 22050, seed=0)
    ns, starts, padded, reset = amv_audio.stream_layout(pcm, 1378, 22050)
    stats = []
    x = padded.astype(np.int64)
    for a, e in zip(starts, list(starts[1:]) + [len(padded)]):
        pass1(x, reset, int(a), int(e), stats=stats)
    at = np.array([t for t, _ in stats if t is not None])
    left = np.array([k for _, k in stats])
    print(f"{len(stats)} segments of ~{int(np.median(np.diff(starts)))} "
          f"samples: merged to <= {MERGE_AT} states in {len(at)} (checkpoint "
          f"sample p50 {np.median(at):.0f}, p90 {np.percentile(at, 90):.0f}, "
          f"max {at.max()}); states kept at the merge mean "
          f"{left.mean():.1f}, max {left.max()}")


if __name__ == "__main__":
    collapse_stats()
