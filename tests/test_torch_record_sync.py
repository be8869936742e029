"""A pure-Python model of kernel R's speculative, self-synchronizing record
decode (csrc/entropy_decode.cu, kernel D's body in its record mode), held
against the port's plain record decoder and the JAX package's.

The model runs the kernel's phases on one frame with subsequences of S
bits, under JAX's semantics (a code no table holds reads as length 16 and
the table's last symbol, a size-0 symbol writes a 0 level, a position past
63 ends the block): (1) speculate: subsequence j decodes from bit j * S
with an assumed state and records its exit state (the first token
boundary past its end), tokens and finished blocks; R's token step never
fails; (2) sync: a walk over the subsequences gives every entry that
differs from its predecessor's exit that exit, and those decode again,
until nothing changes or the exact prefix reaches the last block or the
budget of T records (which may cut inside a subsequence); the walk's sums
are the scan; (3) write: every subsequence up to the stopping one decodes
from its exact entry and stores its records at their token indices, and
the last one goes on into the zero fill when the data ends first.  Small S
(64-256 bits) gives every frame many subsequences and many syncs.
Tolerance: exact equality (integer codec, bit-exact contract).

    PYTHONPATH=. python tests/test_torch_record_sync.py

prints the model's sync rounds on the seeded 160x120 and 320x240 corpora.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from amv_tpu.kernels import entropy_async_pallas as JA  # noqa: E402
from amv_tpu.kernels.entropy_decode_pallas import scan_words_layout  # noqa: E402,E501
from amv_tpu_torch import native  # noqa: E402
from amv_tpu_torch.codecs.jpeg_tables import ENC_TABLES, RECORD_LUT  # noqa: E402,E501
from amv_tpu_torch.kernels import entropy_records as R  # noqa: E402
from amv_tpu_torch.verify import fixtures  # noqa: E402

LUT = [RECORD_LUT[t].tolist() for t in range(4)]
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
    """One token of JAX's record decode from state (bit, last zigzag slot
    or -1 for the DC, block mod 6) -> (state, block done, record)."""
    bp, pos, c6 = st
    peek = sc.peek(bp)
    dc = pos < 0
    ent = LUT[(0 if dc else 2) + (c6 >= 4)][peek >> 16]
    ln, sym = ent & 31, ent >> 5
    nb = sym if dc else sym & 15
    lev = 0
    if nb:
        v = (peek >> (32 - ln - nb)) & ((1 << nb) - 1)
        lev = v if v >> (nb - 1) else v - (1 << nb) + 1
    i = pos + (sym >> 4) + 1
    if dc:
        done, write, pos = False, True, 0
    else:
        eob, zrl = sym == 0, sym == 0xF0
        done = eob or (pos + 16 >= 63 if zrl else i >= 63)
        write = not eob and not zrl and i <= 63
        pos = -1 if done else (pos + 16 if zrl else i)
    rec = (lev << 16 | dc << 7 | write << 6 | min(i, 63)) & 0xFFFFFFFF
    rec = rec - (1 << 32) if rec >> 31 else rec
    return (bp + ln + nb, pos, (c6 + 1) % 6 if done else c6), done, rec


def walk(sc, st, end):
    """Decode from st while the bit position is below end -> (exit state,
    tokens, blocks finished)."""
    toks = blks = 0
    while st[0] < end:
        st, done, _ = step(sc, st)
        toks += 1
        blks += done
    return st, toks, blks


def records_model(row, ln, n_blocks, t_rows, S, stats=None):
    """Kernel R's phases on one frame -> (records int32 [t_rows], (blocks
    done, records)); stats, a list, gets the frame's subsequences and sync
    rounds."""
    ln = max(0, min(int(ln), len(row)))
    sc = Scan(row, ln)
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
                _, toks, blks = W[j]
                if b + blks >= n_blocks or t + toks >= t_rows:
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
    # 3. write; the records past the last stay 0 (the CTA's zero tail)
    out = np.zeros(t_rows, np.int32)
    last = stop if stop >= 0 else n_sub - 1
    for j in range(last + 1):                # in parallel on the card
        st, blk, tok = E[j], blk0[j], tok0[j]
        tail = stop < 0 and j == n_sub - 1
        while tail or st[0] < (j + 1) * S:
            if blk >= n_blocks or tok >= t_rows:
                break
            st, done, out[tok] = step(sc, st)
            tok += 1
            blk += done
        if j == last:
            status = (blk, tok)
    if stats is not None:
        stats.append((n_sub, rounds))
    return out, status


def model_records(rows, lens, n_blocks, t_rows, S, stats=None):
    recs, status = zip(*(records_model(rows[f], lens[f], n_blocks, t_rows,
                                       S, stats) for f in range(len(rows))))
    return np.stack(recs), np.array(status, np.int32)


def cut(recs, status, t):
    """The records and status of a budget of t records from those of a
    larger one: a prefix, and the blocks done are the DC records at
    indices 1..t (each follows a finished block) where the frame went on
    past t."""
    recs, status = np.asarray(recs), np.asarray(status).copy()
    over = status[:, 1] > t
    dcs = ((recs[:, 1:t + 1] >> 7) & 1).sum(axis=1)
    status[:, 0] = np.where(over, dcs, status[:, 0])
    status[:, 1] = np.minimum(status[:, 1], t)
    return recs[:, :t], status


def boundaries(row, ln, n_blocks, S):
    """The global token index at which each subsequence after the first
    starts in the exact decode (its first token boundary at or past j * S),
    for the blocks the frame has."""
    sc = Scan(row, ln)
    st, tok, blk, out = (0, -1, 0), 0, 0, []
    n_sub = max(1, -(-8 * int(ln) // S))
    for j in range(1, n_sub):
        while st[0] < j * S and blk < n_blocks:
            st, done, _ = step(sc, st)
            tok += 1
            blk += done
        if blk >= n_blocks:
            break
        out.append(tok)
    return out


def zrl_scan(n_blocks):
    """A scan no C encoder writes: every block a DC of size 0, then ZRL,
    ZRL, a 1 after 14 zeros (slot 47) and a ZRL, which JAX's record decode
    reads as ending the block at slot 63 (the C decoder fails on the token
    after it)."""
    bits = ""
    for b in range(n_blocks):
        dc, ac = (0, 2) if b % 6 < 4 else (1, 3)
        for t, sym, extra in ((dc, 0, ""), (ac, 0xF0, ""), (ac, 0xF0, ""),
                              (ac, 0xE1, "1"), (ac, 0xF0, "")):
            n = int(ENC_TABLES[1, t, sym])
            bits += format(int(ENC_TABLES[0, t, sym]), f"0{n}b") + extra
    bits += "1" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


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


def _damaged(rows, lens, case, rng):
    rows, lens = rows.copy(), lens.copy()
    for f in range(0, len(rows), 2):
        ln = int(lens[f])
        if case == "random":
            rows[f, :ln] = rng.integers(0, 256, ln)
        elif case == "bad_code":
            at = int(rng.integers(0, ln - 8))
            rows[f, at:at + 6] = 0xFF           # 16 ones: no K.3 code
        elif case == "ff_run":
            rows[f, ln // 4:] = 0xFF            # invalid codes to the end
        elif case == "truncated":
            lens[f] = rng.integers(0, ln)
        elif case == "empty":
            lens[f] = 0
        elif case == "sprinkled":
            rows[f, 7:ln:37] = rng.integers(0, 256, len(range(7, ln, 37)))
        elif case == "zrl_end":
            z = zrl_scan(NB)[:rows.shape[1]]
            rows[f, :len(z)] = np.frombuffer(z, np.uint8)
            lens[f] = len(z)
    return rows, lens


CASES = ["clean", "random", "bad_code", "ff_run", "truncated", "empty",
         "sprinkled", "zrl_end"]


@pytest.mark.parametrize("S", [64, 256, 1024])
@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain(scans, case, S):
    """Every malformed case in a budget no frame reaches (T = 64 records a
    block, 2,304) and in one that cuts most frames (T = 256)."""
    rng = np.random.default_rng(CASES.index(case) * 7 + S)
    rows, lens = _damaged(*scans, case, rng)
    for t_max in (64 * NB, 200):
        want_r, want_s = R.decode_records_plain(torch.from_numpy(rows),
                                                torch.from_numpy(lens), NB,
                                                t_max)
        recs, status = model_records(rows, lens, NB, R.record_rows(t_max), S)
        np.testing.assert_array_equal(status, want_s.numpy())
        np.testing.assert_array_equal(recs, want_r.numpy())
    if case == "clean":
        assert (status[:, 0] < NB).any()         # T = 256 cuts frames


@pytest.mark.parametrize("S", [64, 128, 512])
def test_model_budget_cuts(scans, S):
    """Budgets of T records that end on a subsequence's boundary (the T-th
    record is the last of a subsequence), one record before and one after
    it (the cut inside a subsequence), against the plain decoder's records
    cut to T."""
    rows, lens = scans
    want_r, want_s = R.decode_records_plain(torch.from_numpy(rows),
                                            torch.from_numpy(lens), NB,
                                            64 * NB)
    for f in range(len(rows)):
        for t in boundaries(rows[f], lens[f], NB, S)[::3]:
            for t_rows in (t - 1, t, t + 1):
                wr, ws = cut(want_r.numpy()[f:f + 1], want_s.numpy()[f:f + 1],
                             t_rows)
                recs, status = records_model(rows[f], lens[f], NB, t_rows, S)
                np.testing.assert_array_equal(status, ws[0])
                np.testing.assert_array_equal(recs, wr[0])


@pytest.mark.parametrize("size,S", [((160, 120), 256), ((160, 120), 1024),
                                    ((320, 240), 1024)])
def test_model_matches_plain_on_corpus(size, S):
    """C-encoded frames of the main path's size, and of 320x240, in the
    record decode's budget of 64 records a block."""
    w, h = size
    rows, lens = corpus(2 if w == 160 else 1, h, w, seed=w)
    nb = (w + 15) // 16 * ((h + 15) // 16) * 6
    want_r, want_s = R.decode_records_plain(torch.from_numpy(rows),
                                            torch.from_numpy(lens), nb,
                                            64 * nb)
    stats = []
    recs, status = model_records(rows, lens, nb, R.record_rows(64 * nb), S,
                                 stats)
    np.testing.assert_array_equal(status, want_s.numpy())
    np.testing.assert_array_equal(recs, want_r.numpy())
    assert (status[:, 0] == nb).all()
    assert max(r for _, r in stats) > 0          # the frames needed syncs


def test_model_matches_jax():
    """The model's records and status against JAX's `_decode_records` in
    interpret mode, on clean and malformed 48x32 scans."""
    rows, lens = corpus(4, H, W, seed=5)
    rng = np.random.default_rng(2)
    rows[1, :lens[1]] = rng.integers(0, 256, lens[1])
    rows[2, 20:30] = 0xFF
    rows[3, lens[3] // 3:] = 0                  # JAX reads the whole row
    lens[3] //= 3
    t_max = R.default_t_max(NB, rows.shape[1])
    recs, status = JA._decode_records(scan_words_layout(jnp.asarray(rows)),
                                      NB, t_max, interpret=True)
    t = recs.shape[1]
    want_r = np.asarray(recs).transpose(0, 2, 3, 1).reshape(-1, t)[:4]
    want_s = np.asarray(status).transpose(0, 2, 3, 1).reshape(-1, 2)[:4]
    got_r, got_s = model_records(rows, lens, NB, R.record_rows(t_max), 128)
    np.testing.assert_array_equal(got_s, want_s)
    for f, n in enumerate(want_s[:, 1]):
        np.testing.assert_array_equal(got_r[f, :n], want_r[f, :n])
        assert not got_r[f, n:].any()


def report():
    for (w, h), n in (((160, 120), 48), ((320, 240), 16)):
        rows, lens = corpus(n, h, w)
        nb = ((w + 15) // 16) * ((h + 15) // 16) * 6
        t_rows = R.record_rows(64 * nb)
        want_r, want_s = R.decode_records_plain(
            torch.from_numpy(rows), torch.from_numpy(lens), nb, 64 * nb)
        for S in (512, 1024, 2048):
            stats = []
            recs, status = model_records(rows, lens, nb, t_rows, S, stats)
            assert np.array_equal(recs, want_r.numpy())
            assert np.array_equal(status, want_s.numpy())
            sub, rounds = np.array(stats).T
            print(f"{w}x{h}, {n} frames, S={S}: subsequences mean "
                  f"{sub.mean():.1f} max {sub.max()}; sync rounds mean "
                  f"{rounds.mean():.2f} max {rounds.max()}")


if __name__ == "__main__":
    report()
