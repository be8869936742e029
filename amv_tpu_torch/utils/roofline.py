"""The ceilings of one NVIDIA H100 SXM and the least time a function can
take on them: the port's counterpart of `amv_tpu/utils/roofline.py`'s
ceilings (which are a TPU v5e's).

Published peaks (NVIDIA's data sheet, SXM part, dense, at the full power
limit of 700 W): 3.35 TB/s of HBM3, and 67 T/s of FP32 operations
outside the tensor cores, which counts a fused multiply-add as 2; the
port counts 32-bit integer operations at that same 67 T/s, and an
unfused FP32 instruction (kernel K builds with -fmad=false) at half of
it; and one warp-wide shared-memory load a clock an SM.  A card set below
700 W runs slower than these.  `chip_smoke.py` and the tools read them
here.

`bound_ms` is what `PERF.md`'s "bound" column holds: the larger of the
bytes a function must move (each input read once, each output written
once) over the memory rate and its operations over the rate of their
type.  The TPU module's lockstep iteration model (token statistics, VPU
instructions per iteration) has no counterpart: the port's kernels walk
their tokens a thread block per frame, not in lockstep lanes, and their
work is counted from their inputs where it is reported.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12       # bytes/s
INT_OPS_S = 67e12           # 32-bit integer operations/s
FP32_INSN_S = INT_OPS_S / 2  # unfused FP32 instructions/s
# one warp-wide 32-bit shared-memory load a clock an SM (132 SMs at their
# 1,980 MHz boost clock), in 32-bit words/s
LDS_S = 132 * 32 * 1.98e9


def bound_ms(nbytes: float, int_ops: float = 0.0, fp32_insns: float = 0.0):
    """(least milliseconds, "bytes" or "operations") for a function that
    moves nbytes and does int_ops integer operations and fp32_insns
    unfused FP32 instructions."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = int_ops / INT_OPS_S + fp32_insns / FP32_INSN_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
