"""A pure-Python model of kernel D's speculative, self-synchronizing
decode (csrc/entropy_decode.cu), held against the port's plain decoder,
the JAX package's decoder and the malformed cases of
test_torch_entropy_decode.py.

The model runs the kernel's phases on one frame with subsequences of S
bits: (1) speculate: subsequence j decodes from bit j * S with an assumed
state and records its exit state (the first token boundary past its end),
tokens, finished blocks and first failing token; (2) sync: a walk over the
subsequences gives every entry that differs from its predecessor's exit
that exit, and those decode again, until nothing changes or the exact
prefix reaches the last block, a failure or the budget; the walk's sums are
the scan; (3) write: every subsequence up to the stopping one decodes from
its exact entry and writes its levels, and the last one goes on into the
zero fill when the data ends first.  Small S (64-256 bits) gives every
small frame many subsequences and many syncs.  Tolerance: exact equality
(integer codec, bit-exact contract).

    PYTHONPATH=. python tests/test_torch_entropy_sync.py

prints the sync distances (tokens until a decode started at a random bit
is in step with the true one) and the model's sync rounds on the seeded
160x120 and 320x240 corpora.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels.entropy_decode import decode_scans_device  # noqa: E402
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs.jpeg_tables import DEC_LUT  # noqa: E402
from amv_tpu_torch.kernels.entropy_decode import (  # noqa: E402
    decode_scans_plain, token_budget)
from amv_tpu_torch.verify import fixtures  # noqa: E402

LUT = [DEC_LUT[t].tolist() for t in range(4)]
GUESS_POS = 1        # the speculative entry: AC slot 1 of a Y block


class Scan:
    """A row's first `ln` bytes as big-endian words, zero past them."""

    def __init__(self, row, ln):
        b = bytes(row[:ln]) + bytes(-ln % 4)
        self.w = [int.from_bytes(b[i:i + 4], "big")
                  for i in range(0, len(b), 4)]

    def peek(self, bp):
        k, o = bp >> 5, bp & 31
        hi = self.w[k] if k < len(self.w) else 0
        lo = self.w[k + 1] if k + 1 < len(self.w) else 0
        return ((hi << 32 | lo) >> (32 - o)) & 0xFFFFFFFF


def step(sc, st):
    """One token of the C decoder from state (bit, zigzag pos or -1 for
    the DC, block mod 6) -> None if invalid, else (state, block done,
    slot or -1, level)."""
    bp, pos, c6 = st
    peek = sc.peek(bp)
    ent = LUT[(0 if pos < 0 else 2) + (c6 >= 4)][peek >> 16]
    ln = ent & 31
    if not ln:
        return None
    sym = ent >> 5
    nb = sym if pos < 0 else sym & 15
    lev = 0
    if nb:
        v = (peek >> (32 - ln - nb)) & ((1 << nb) - 1)
        lev = v if v >> (nb - 1) else v - (1 << nb) + 1
    bp += ln + nb
    nxt = (c6 + 1) % 6
    if pos < 0:
        return (bp, 0, c6), 0, 0, lev
    if sym == 0:
        return (bp, -1, nxt), 1, -1, 0
    if nb == 0:
        return None if sym != 0xF0 else ((bp, pos + 16, c6), 0, -1, 0)
    i = pos + (sym >> 4) + 1
    if i > 63:
        return None
    return ((bp, -1, nxt), 1, i, lev) if i == 63 else ((bp, i, c6), 0, i,
                                                        lev)


def walk(sc, st, end):
    """Decode from st while the bit position is below end -> (exit state,
    tokens, blocks finished, first failing token or -1); a failing token
    restarts the walk one bit on with the speculative guess."""
    toks = blks = 0
    ftok = -1
    while st[0] < end:
        toks += 1
        r = step(sc, st)
        if r is None:
            ftok = toks - 1 if ftok < 0 else ftok
            st = (st[0] + 1, GUESS_POS, st[2])
            continue
        st = r[0]
        blks += r[1]
    return st, toks, blks, ftok


def decode_model(row, ln, n_blocks, S, budget=None, stats=None):
    """Kernel D's phases on one frame -> (levels int16 [n_blocks, 64],
    ok); stats, a list, gets the frame's subsequences and sync rounds."""
    ln = max(0, min(int(ln), len(row)))
    sc = Scan(row, ln)
    budget = n_blocks * 65 + 4 * ln + 64 if budget is None else int(budget)
    n_sub = max(1, -(-8 * ln // S))
    # 1. speculate: E entry, W the walk from it
    E = [(0, -1, 0)] + [(j * S, GUESS_POS, 0) for j in range(1, n_sub)]
    W = [walk(sc, E[j], (j + 1) * S) for j in range(n_sub)]
    # 2. sync; the walk over the subsequences is the scan of the exact
    # prefix and the stopping test
    rounds = 0
    while True:
        tok0, blk0 = [0] * n_sub, [0] * n_sub
        t = b = 0
        stop, exact, redo = -1, True, []
        for j in range(n_sub):
            if exact:
                tok0[j], blk0[j] = t, b
                _, toks, blks, ftok = W[j]
                if ftok >= 0 or b + blks >= n_blocks or t + toks > budget:
                    stop = j
                    break
                t, b = t + toks, b + blks
            if j + 1 < n_sub and W[j][0] != E[j + 1]:
                E[j + 1] = W[j][0]
                redo.append(j + 1)
                exact = False
        if stop >= 0 or not redo:
            break
        for j in redo:                       # in parallel on the card
            W[j] = walk(sc, E[j], (j + 1) * S)
        rounds += 1
    # 3. write
    out = np.zeros((n_blocks, 64), np.int16)
    last = stop if stop >= 0 else n_sub - 1
    good = True
    for j in range(last + 1):                # in parallel on the card
        st, blk, tok = E[j], blk0[j], tok0[j]
        tail = stop < 0 and j == n_sub - 1
        while tail or st[0] < (j + 1) * S:
            if blk >= n_blocks:
                break
            tok += 1
            r = step(sc, st) if tok <= budget else None
            if r is None:
                good = False
                break
            st, done, slot, lev = r
            if slot >= 0:
                out[blk, slot] = lev
            blk += done
        if j == last:
            good = good and blk >= n_blocks
    if stats is not None:
        stats.append((n_sub, rounds))
    return out, good


def model_decode(rows, lens, n_blocks, S, budget=None):
    lv, ok = zip(*(decode_model(rows[f], lens[f], n_blocks, S,
                                None if budget is None else budget[f])
                   for f in range(len(rows))))
    return np.stack(lv), np.array(ok, np.uint8)


def corpus(n, h, w, seed=0, qscale=2):
    """n seeded pictures (videogen, +-3 luma noise), C-encoded, unescaped."""
    rng = np.random.default_rng(seed)
    y, cb, cr = fixtures.videogen(n, h, w, seed=seed)
    y = np.clip(y.astype(np.int16) + rng.integers(-3, 4, y.shape), 0,
                255).astype(np.uint8)
    pays = [native.ref_encode_frame(y[i], cb[i][:h // 2, :w // 2],
                                    cr[i][:h // 2, :w // 2], qscale)
            for i in range(n)]
    return native.unescape_frames(pays)


H, W, NB = 32, 48, 36


@pytest.fixture(scope="module")
def scans():
    return corpus(6, H, W)


def _damaged(rows, lens, case, rng, S):
    rows, lens = rows.copy(), lens.copy()
    budget = None
    for f in range(0, len(rows), 2):
        ln = int(lens[f])
        if case == "random":
            rows[f, :ln] = rng.integers(0, 256, ln)
        elif case == "bad_code":
            at = int(rng.integers(0, ln - 8))
            rows[f, at:at + 6] = 0xFF           # 16 ones: no K.3 code
        elif case == "truncated":
            lens[f] = rng.integers(0, ln)
        elif case == "empty":
            lens[f] = 0
        elif case == "sprinkled":
            rows[f, 7:ln:37] = rng.integers(0, 256, len(range(7, ln, 37)))
        elif case.startswith("cut"):
            lens[f] = ln - int(case[3:])        # decodes on into the zeros
        elif case == "fail_first":
            rows[f, 2:6] = 0xFF                 # inside subsequence 0
        elif case == "fail_last":
            at = min((-(-8 * ln // S) - 1) * S // 8 + 1, ln - 4)
            rows[f, at:at + 4] = 0xFF           # inside the last subsequence
        elif case == "budget":
            budget = token_budget(torch.from_numpy(lens), NB,
                                  rows.shape[1]).numpy()
            budget[f] = int(rng.integers(1, 200))
    return rows, lens, budget


CASES = ["clean", "random", "bad_code", "truncated", "empty", "sprinkled",
         "cut1", "cut2", "cut3", "fail_first", "fail_last", "budget"]


@pytest.mark.parametrize("S", [64, 128, 256])
@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain(scans, case, S):
    rng = np.random.default_rng(CASES.index(case) * 7 + S)
    rows, lens, budget = _damaged(*scans, case, rng, S)
    kw = {} if budget is None else {"budget": torch.from_numpy(budget)}
    want_lv, want_ok = decode_scans_plain(torch.from_numpy(rows),
                                          torch.from_numpy(lens), NB, **kw)
    lv, ok = model_decode(rows, lens, NB, S, budget)
    np.testing.assert_array_equal(ok, want_ok.numpy())
    np.testing.assert_array_equal(lv, want_lv.numpy())
    if case in ("bad_code", "fail_first", "fail_last", "budget"):
        assert not ok[0::2].all(), case
    if case == "clean":
        assert ok.all()


def test_model_matches_jax():
    rows, lens = corpus(4, 64, 64, seed=5)
    n_blocks = 16 * 6
    stats = []
    lv, ok = zip(*(decode_model(rows[f], lens[f], n_blocks, 128, stats=stats)
                   for f in range(4)))
    assert all(ok)
    dev = np.asarray(decode_scans_device(jnp.asarray(rows), 16))
    np.testing.assert_array_equal(np.stack(lv).reshape(dev.shape), dev)
    assert max(r for _, r in stats) > 0          # the frames needed syncs


def sync_distances(rows, lens, n_blocks, rng, starts=32, limit=20000):
    """Tokens until a decode started at a random bit with the speculative
    guess is in step with the true decode: (bits and zigzag position,
    all three including the block mod 6), per start; `limit` when never."""
    bit_pos, full = [], []
    for f in range(len(rows)):
        ln = int(lens[f])
        sc = Scan(rows[f], ln)
        truth, st, blk = {}, (0, -1, 0), 0
        while blk < n_blocks:
            truth[st[0]] = st
            r = step(sc, st)
            st, blk = r[0], blk + r[1]
        for b in rng.integers(8, 8 * ln - 64, starts):
            st, tok, bp_at = (int(b), GUESS_POS, 0), 0, None
            while tok < limit:
                t = truth.get(st[0])
                if bp_at is None and t is not None and t[1] == st[1]:
                    bp_at = tok
                if t == st:
                    break
                r = step(sc, st)
                st = (st[0] + 1, GUESS_POS, st[2]) if r is None else r[0]
                tok += 1
            bit_pos.append(limit if bp_at is None else bp_at)
            full.append(tok)
    return np.array(bit_pos), np.array(full)


def report():
    rng = np.random.default_rng(0)
    for (w, h), n in (((160, 120), 48), ((320, 240), 16)):
        rows, lens = corpus(n, h, w)
        nb = ((w + 15) // 16) * ((h + 15) // 16) * 6
        bp, full = sync_distances(rows, lens, nb, rng)
        q = (50, 90, 99)
        print(f"{w}x{h}, {n} frames, {len(full)} starts: tokens until in "
              "step, bits and position: p50/p90/p99 "
              f"{np.percentile(bp, q).tolist()}, with the block mod 6: "
              f"{np.percentile(full, q).tolist()} (max {full.max()}, "
              f"{int((full >= 20000).sum())} never within 20,000)")
        want = decode_scans_plain(torch.from_numpy(rows),
                                  torch.from_numpy(lens), nb)[0].numpy()
        for S in (512, 1024, 2048):
            stats = []
            for f in range(n):
                lv, ok = decode_model(rows[f], lens[f], nb, S, stats=stats)
                assert ok and np.array_equal(lv, want[f])
            sub, rounds = np.array(stats).T
            print(f"  S={S}: subsequences mean {sub.mean():.1f} max "
                  f"{sub.max()}; sync rounds mean {rounds.mean():.2f} max "
                  f"{rounds.max()}")


if __name__ == "__main__":
    report()
