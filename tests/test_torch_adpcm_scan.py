"""A numpy model of kernel A's decomposition (amv_tpu_torch/csrc/
adpcm_decode.cu), held against the port's plain decoder and `amv_tpu`'s
associative-scan decoder `amv_tpu.kernels.adpcm.decode_nibbles`.

The model mirrors the kernel: a chunk is decoded in tiles of KTILE bytes;
in a tile of tb bytes each of the 32 lanes owns a run of ceil(tb / 32)
bytes (runs past the tile's end are empty).  A lane composes its run's
step-index maps x -> clip(x + idx(nibble), 0, 88); an exclusive warp
scan (the kernel's __shfl_up_sync rounds, Hillis-Steele) gives every lane
its starting step index; the lane then composes its run's predictor maps
x -> clip(x +- diff, -32768, 32767) from that index, a second scan gives
its starting predictor, and the lane decodes its run serially from the
two.  The whole tile's maps carry the state to the next tile.  The
header's predictor is clamped to +-2^20 first, and the maps' identity
bounds are +-2^30, as in the kernel.  Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import adpcm as KA  # noqa: E402
from amv_tpu_torch.kernels import adpcm as A  # noqa: E402
from amv_tpu_torch.verify.ref_adpcm import STEP_TABLE  # noqa: E402

STEPS = np.asarray(STEP_TABLE, np.int64)
KTILE, LANES = 1024, 32              # csrc/adpcm_decode.cu: kTile, a warp
BIG, RAIL = 1 << 30, 1 << 20         # kBig, kPredRail
P_LO, P_HI = -32768, 32767


def _then(m, d, lo, hi, on):
    """Map m = (a, lo, hi) followed by the step x -> clip(x + d, lo, hi)
    where `on`; unchanged elsewhere."""
    a, l0, h0 = m
    return (np.where(on, a + d, a), np.where(on, np.clip(l0 + d, lo, hi), l0),
            np.where(on, np.clip(h0 + d, lo, hi), h0))


def compose(f, g):
    """f, then g (amv_tpu/kernels/adpcm.py:_compose_clipped_add)."""
    return (f[0] + g[0], np.clip(f[1] + g[0], g[1], g[2]),
            np.clip(f[2] + g[0], g[1], g[2]))


def apply(m, x):
    return np.clip(x + m[0], m[1], m[2])


def warp_scan(m):
    """Maps [..., 32] (lane 0 first) -> (exclusive prefix, whole warp),
    in the kernel's rounds: lane l >= d takes compose(lane l - d, own)."""
    for d in (1, 2, 4, 8, 16):
        prev = tuple(np.concatenate([v[..., :d], v[..., :-d]], -1) for v in m)
        take = np.arange(LANES) >= d
        m = tuple(np.where(take, c, v) for c, v in zip(compose(prev, m), m))
    excl = tuple(np.concatenate([np.full_like(v[..., :1], i), v[..., :-1]], -1)
                 for v, i in zip(m, (0, -BIG, BIG)))
    return excl, tuple(v[..., -1] for v in m)


def _index_step(nib):
    d = nib & 7
    return np.where(d < 4, -1, 2 * d - 6)


def _diff(nib, s):
    diff = ((2 * (nib & 7) + 1) * STEPS[s]) >> 3
    return np.where(nib & 8, -diff, diff)


def scan_model(payload, pred, sidx, repeat=1):
    """Kernel A's tiles, lane runs, scans and replay over chunks, vectorised
    over chunks and lanes -> int16 [C * repeat, 2 * nbytes]."""
    c, nb = payload.shape
    p = np.clip(pred.astype(np.int64), -RAIL, RAIL)
    s = np.clip(sidx.astype(np.int64), 0, 88)
    out = np.zeros((c, 2 * nb), np.int64)
    for t0 in range(0, nb, KTILE):
        tb = min(KTILE, nb - t0)
        run = -(-tb // LANES)
        k0 = np.minimum(np.arange(LANES) * run, tb)
        k1 = np.minimum(k0 + run, tb)
        tile = payload[:, t0:t0 + tb].astype(np.int64)
        # nibbles [C, 32 lanes, 2 run] in walk order, and where they exist
        pos = k0[:, None] + np.arange(run)[None, :]
        on = np.repeat(pos < k1[:, None], 2, axis=1)[None]
        byte = tile[:, np.minimum(pos, tb - 1)]
        nib = np.stack([byte >> 4, byte & 15], -1).reshape(c, LANES, 2 * run)
        ident = tuple(np.full((c, LANES), v, np.int64) for v in (0, -BIG, BIG))
        ms = ident
        for i in range(2 * run):                 # walk 1: step-index maps
            ms = _then(ms, _index_step(nib[..., i]), 0, 88, on[..., i])
        excl, total = warp_scan(ms)
        s_run = apply(excl, s[:, None])
        s = apply(total, s)
        mp, ss = ident, s_run                    # walk 2: predictor maps
        for i in range(2 * run):
            mp = _then(mp, _diff(nib[..., i], ss), P_LO, P_HI, on[..., i])
            ss = np.where(on[..., i],
                          np.clip(ss + _index_step(nib[..., i]), 0, 88), ss)
        excl, total = warp_scan(mp)
        pp, ss = apply(excl, p[:, None]), s_run  # walk 3: the replay
        p = apply(total, p)
        for i in range(2 * run):
            pp = np.clip(pp + _diff(nib[..., i], ss), P_LO, P_HI)
            ss = np.clip(ss + _index_step(nib[..., i]), 0, 88)
            col = 2 * (t0 + k0) + i
            keep = on[0, :, i]
            out[:, col[keep]] = pp[:, keep]
    return np.tile(out.astype(np.int16), (repeat, 1))


def _inputs(nbytes, fill, seed):
    """Six chunks: random bytes (or all `fill`), header step indices -5,
    0, 88, 200 (clamped) and two random, predictors across the int16
    range; 0x77 starts at the top rail, 0xFF at step index 88."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (6, nbytes)).astype(np.uint8)
    pred = np.array([0, 32767, -32768, 1000, -20000, 12345], np.int32)
    sidx = np.array([-5, 0, 88, 200, 17, 60], np.int32)
    if fill is not None:
        pay[:] = fill
    if fill == 0x77:
        pred[:] = 32767
    if fill == 0xFF:
        sidx[:] = 88
    return pay, pred, sidx


@pytest.mark.parametrize("nbytes,fill,repeat", [
    (1, None, 1), (16, None, 1), (31, None, 1), (32, None, 1),
    (33, None, 3), (689, None, 1), (689, 0x77, 1), (689, 0xFF, 1),
    (689, 0x88, 1), (2100, None, 1)])
def test_scan_model_matches_plain_and_jax(nbytes, fill, repeat):
    """Runs shorter than a lane and a byte each (1-33 bytes), the file's
    689-byte chunks, the clamp rails, three tiles (2,100 bytes) and the
    wrap: the model equals the plain decoder and JAX's associative scan."""
    pay, pred, sidx = _inputs(nbytes, fill, nbytes)
    got = scan_model(pay, pred, sidx, repeat)
    want = A.decode_chunks_plain(*(torch.from_numpy(a) for a in
                                   (pay, pred, sidx)), repeat=repeat).numpy()
    np.testing.assert_array_equal(got, want)
    nib = np.stack([pay >> 4, pay & 15], -1).reshape(6, -1).astype(np.int32)
    jx = np.asarray(KA.decode_nibbles(jnp.asarray(nib), jnp.asarray(pred),
                                      jnp.asarray(np.clip(sidx, 0, 88))))
    np.testing.assert_array_equal(got, np.tile(jx, (repeat, 1)))


def test_header_predictor_clamp_changes_no_sample():
    """Predictors beyond the int16 range (the plain decoder takes any
    int32): clamping them to +-2^20 first, as the kernel does, changes no
    sample."""
    pay, _, sidx = _inputs(100, None, 7)
    pred = np.array([2 ** 31 - 1, -2 ** 31, 70000, -70000, RAIL + 1, -RAIL],
                    np.int32)
    want = A.decode_chunks_plain(*(torch.from_numpy(a) for a in
                                   (pay, pred, sidx))).numpy()
    np.testing.assert_array_equal(scan_model(pay, pred, sidx), want)


def test_compose_is_exact_and_associative():
    """Clipped-add maps compose exactly for any input, in and out of the
    bounds, and composition is associative: what lets the warp scan
    regroup the steps."""
    rng = np.random.default_rng(3)
    maps = []
    for _ in range(3):
        a = rng.integers(-70000, 70000, 2000)
        lo = rng.integers(-40000, 30000, 2000)
        maps.append((a, lo, lo + rng.integers(0, 40000, 2000)))
    f, g, h = maps
    x = rng.integers(-(1 << 21), 1 << 21, 2000)
    np.testing.assert_array_equal(apply(compose(f, g), x),
                                  apply(g, apply(f, x)))
    for u, v in zip(compose(compose(f, g), h), compose(f, compose(g, h))):
        np.testing.assert_array_equal(u, v)
