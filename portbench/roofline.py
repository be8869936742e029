"""The yardstick's peaks and each kernel's work, counted from the cell's
shapes and the algorithm, whatever kernel implements it.

Peaks are NVIDIA's published figures for one H100 SXM at its full 700 W
power limit: 3.35 TB/s of HBM3 bandwidth and 67 T operations a second on
the 32-bit pipes (the data sheet's FP32 figure, which counts a fused
multiply-add as two operations).  A card set below 700 W reaches less;
`device.power_limit_w` in a run's result says which it was.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
OPS_S = 67e12

# G.729 Annex A decode, operations a 10 ms frame: each multiply and each
# add or subtract counts one (a multiply-accumulate two); compares,
# clips, shifts and table reads count nothing, so this is the least work
# the algorithm needs.  Stage by stage (ITU-T G.729 Annex A section 4;
# portbench/reference/g729_ref.c names the same steps):
G729_DECODE_FRAME_OPS = {
    "unpack": 30,                   # 15 fields
    "lsf_decode": 10 + 2 * 9 * 6 + 10 * 9,  # sums, 2 spacing passes, MA
    "lsf_to_lsp": 10 * 7,
    "lsp_to_lp": 2 * (2 * 58 + 30) + 10,    # two subframes' polynomials
    "highpass": 80 * 9,             # second order, 80 samples
}
G729_DECODE_SUBFRAME_OPS = {
    "adaptive_codebook": 40 * 20 * 2,   # 20 interpolation taps a sample
    "gain": 40 * 2 + 30,                # fixed-codebook energy, predictor
    "excitation": 40 * 4,               # gp * v + gc * c, rounded
    "lp_synthesis": 40 * 10 * 2,
    "postfilter": (2 * 10 * 2          # weighted LP coefficients
                   + 40 * 2            # energy before
                   + 40 * 10 * 2       # residual
                   + 7 * 40 * 2 + 2 * 40 * 2 + 40 * 3  # long-term search
                   + 22 * 10 * 2 + 43 * 2 + 40 * 2     # tilt
                   + 40 * 10 * 2       # synthesis
                   + 40 * 2 + 40 * 4),  # energy after, gain control
}


def g729a_decode_ops(frames: int) -> float:
    """Operations the G.729A decoder needs for `frames` frames."""
    per_frame = (sum(G729_DECODE_FRAME_OPS.values())
                 + 2 * sum(G729_DECODE_SUBFRAME_OPS.values()))
    return float(per_frame) * frames


def g729a_decode_bytes(frames: int) -> float:
    """Bytes a decoder must move: 10 bytes of frame in, 80 int16 out."""
    return float(frames) * (10 + 80 * 2)


def bound_s(ops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of operations over
    OPS_S and bytes over HBM_BYTES_S."""
    return max(ops / OPS_S, nbytes / HBM_BYTES_S)
