"""Viterbi IMA-ADPCM (AMV) encoder in numpy: the oracle of kernel L.

A copy of `amv_tpu/codecs/adpcm_trellis.py:trellis_encode_fast`, the
reference's `-trellis` quantizer (adpcm.c:287-443's role): a Viterbi over
the 89 step indices, keeping the least sum of squared errors and its
predictor per state and sample.  The in-edges of each state are scanned
source ascending, then nibble ascending, and each argmin takes the first
minimum.  `chip_smoke.py` holds the port's trellis against it on the card,
where the JAX package is absent.
"""

from __future__ import annotations

import numpy as np

from .ref_adpcm import INDEX_TABLE, STEP_TABLE

N_STATES = 89
INF = np.int64(1) << 60
# transitions: state s and nibble n go to NEXT[s, n] with the step
# difference SDIFF[s, n]
_STEP = STEP_TABLE.astype(np.int64)
NEXT = np.clip(np.arange(N_STATES)[:, None] + INDEX_TABLE[None, :], 0, 88)
_DIFF = ((2 * (np.arange(16) & 7)[None, :] + 1) * _STEP[:, None]) >> 3
SDIFF = np.where((np.arange(16) & 8)[None, :] != 0, -_DIFF, _DIFF)


def inverse_edges():
    """The in-edges of every state: (src int64 [89, K], nib int64 [89, K],
    valid bool [89, K]), source ascending then nibble ascending, padded
    with (0, 0, False) to the most in-edges K (48)."""
    inv = [[] for _ in range(N_STATES)]
    for s in range(N_STATES):
        for nb in range(16):
            inv[NEXT[s, nb]].append((s, nb))
    k = max(len(v) for v in inv)
    src = np.zeros((N_STATES, k), np.int64)
    nib = np.zeros((N_STATES, k), np.int64)
    valid = np.zeros((N_STATES, k), bool)
    for d, lst in enumerate(inv):
        for j, (s, nb) in enumerate(lst):
            src[d, j], nib[d, j], valid[d, j] = s, nb, True
    return src, nib, valid


def trellis_encode_fast(samples: np.ndarray, init_step_index: int = 0,
                        init_predictor: int | None = None):
    """Viterbi-encode int16 samples -> (nibbles uint8 [n], final step
    index); init_predictor defaults to samples[0] (the AMV chunk header
    carries the first sample as the seed predictor)."""
    samples = np.asarray(samples, dtype=np.int64)
    n = len(samples)
    if n == 0:
        return np.zeros(0, np.uint8), init_step_index
    pred0 = int(samples[0]) if init_predictor is None else int(init_predictor)
    inv_src, inv_nib, inv_valid = inverse_edges()
    ssd = np.full(N_STATES, INF, np.int64)
    pred = np.zeros(N_STATES, np.int64)
    ssd[init_step_index] = 0
    pred[init_step_index] = pred0
    choice = np.zeros((n, N_STATES), np.uint8)
    parent = np.zeros((n, N_STATES), np.uint8)
    sdiff = SDIFF[inv_src, inv_nib]
    rows = np.arange(N_STATES)
    for t in range(n):
        cand_pred = np.clip(pred[inv_src] + sdiff, -32768, 32767)
        err = cand_pred - samples[t]
        cand = np.where(inv_valid & (ssd[inv_src] < INF),
                        ssd[inv_src] + err * err, INF)
        k = np.argmin(cand, axis=1)
        ssd = cand[rows, k]
        pred = cand_pred[rows, k]
        choice[t] = inv_nib[rows, k]
        parent[t] = inv_src[rows, k]
    s = int(np.argmin(ssd))
    final_step = s
    nibbles = np.zeros(n, np.uint8)
    for t in range(n - 1, -1, -1):
        nibbles[t] = choice[t, s]
        s = int(parent[t, s])
    return nibbles, final_step
