"""Viterbi IMA-ADPCM (AMV) quantizer, the reference's `-trellis`, batched
over chunks as lanes: the port of `amv_tpu/codecs/adpcm_trellis.py:
trellis_encode_fast` and the plain version of kernel L
(`kernels/adpcm_trellis.py`).

Per sample, every one of the 89 step indices takes the best of its
in-edges (a source state and a nibble): the least sum of squared errors
(int64), its predictor clipped to int16, the first minimum in the in-edge
order source ascending then nibble ascending.  An unreachable source, or
a padded in-edge, gives INF = 2^60; a row of INF takes in-edge 0, as
numpy's argmin does.  The final state is the lowest index of least sum,
and the nibbles are read back from it.  A lane runs from its own start
state and predictor, so chunks run side by side; kernel L's wrapper
chains them (each chunk starts where its predecessor ended).
"""

from __future__ import annotations

import torch

from ..verify.ref_trellis import INF, SDIFF, inverse_edges

INV_SRC, INV_NIB, INV_VALID = inverse_edges()   # [89, 48] each
INV_SDIFF = SDIFF[INV_SRC, INV_NIB]


def _first_min(v: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last dimension."""
    k = torch.arange(v.shape[-1], device=v.device)
    return torch.where(v == v.min(dim=-1, keepdim=True).values, k,
                       v.shape[-1]).min(dim=-1).values


def trellis_lanes(samples: torch.Tensor, lens: torch.Tensor,
                  step0: torch.Tensor, pred0: torch.Tensor):
    """samples int16 [A, L] (lane a's first lens[a] are its own), lens
    int64 [A], step0 int [A] in 0..88, pred0 int [A] -> (nibbles uint8
    [A, L], zero past lens; final int64 [A], the end state, step0 where
    lens is 0)."""
    dev = samples.device
    a, length = samples.shape
    src = torch.as_tensor(INV_SRC, device=dev)
    nib = torch.as_tensor(INV_NIB, device=dev)
    valid = torch.as_tensor(INV_VALID, device=dev)
    sdiff = torch.as_tensor(INV_SDIFF, device=dev)
    lanes = torch.arange(a, device=dev)
    inf = int(INF)
    ssd = torch.full((a, 89), inf, dtype=torch.int64, device=dev)
    pred = torch.zeros((a, 89), dtype=torch.int64, device=dev)
    ssd[lanes, step0.long()] = 0
    pred[lanes, step0.long()] = pred0.long()
    x = samples.long()
    lens = lens.long()
    back = torch.zeros((length, a, 89), dtype=torch.uint8, device=dev)
    for t in range(length):
        cp = torch.clamp(pred[:, src] + sdiff, -32768, 32767)  # [A, 89, K]
        err = cp - x[:, t, None, None]
        s_src = ssd[:, src]
        cand = torch.where(valid & (s_src < inf), s_src + err * err, inf)
        k = _first_min(cand)                                   # [A, 89]
        live = (t < lens)[:, None]
        ssd = torch.where(live, cand.gather(2, k[..., None])[..., 0], ssd)
        pred = torch.where(live, cp.gather(2, k[..., None])[..., 0], pred)
        back[t] = k.to(torch.uint8)
    final = _first_min(ssd)
    s = final.clone()
    out = torch.zeros((a, length), dtype=torch.uint8, device=dev)
    for t in range(length - 1, -1, -1):
        k = back[t, lanes, s].long()
        live = t < lens
        out[:, t] = torch.where(live, nib[s, k], 0).to(torch.uint8)
        s = torch.where(live, src[s, k], s)
    return out, final
