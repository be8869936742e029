"""Time variants of kernel M (csrc/adpcm_ms.cu, the MS-ADPCM expand)
against the shipped source on one GPU, in one process: the rows a warp
walks (`kRows`, a lane each; the other lanes only copy and store) at 32
(shipped), 24, 16 and 8, so that 12,998 lanes run as 407, 542, 813 and
1,625 warps on the card's 528 warp schedulers; the samples stored a row
at a time, each word's shared load just before its store (M's earlier
form); the nibble's sign and adaptation factor read from a table in
shared memory; the clip's add-max as two instructions, not DPX; and
diagnostic builds, timed only, that leave out parts of a tile (the walk,
the samples' stores, the nibbles' copies, both of those) or of the
step's chain (the clip, the division, idelta's recurrence).  Each is a text edit of a
copy of the source, built by nvcc into its own library
(`trellis_variants.start_builds`) and launched through ctypes on phase
12's lanes (300 s of seeded 44,100 Hz stereo MS-ADPCM at block_align
2,048: 12,998 lanes of 2,034 samples); the variants are held bit-exact
against the package's kernel.  All are timed in turns (in order, then in
the reverse order) in bursts of `--burst` launches queued back to back
(`time_trellis.burst_ms`, with the SM clock nvidia-smi reads meanwhile):
over all lanes, and over 32 lanes (one warp at 32 rows a warp: a warp's
own time, in cycles a sample at that clock).

    PYTHONPATH=. python3 amv_tpu_torch/tools/ms_variants.py

Prints one JSON line: the card's name and power limit, and for each
build its registers (ptxas), warps, times and exactness.
"""

from __future__ import annotations

import argparse
import json
import os

SOURCE = "adpcm_ms.cu"
ROWS = "constexpr int kRows = 32;"

WALK = "        if (kRows < 32 && lane >= kRows) {"
FULL = "        if (out4 && cnt == kTile) {\n"
PART = "        } else {\n            for (int r = 0; r < rows; ++r) {"
COPY = "            __pipeline_memcpy_async(&in[r][k], w + k, 4);"
NEVER = "(n >> 40)"     # 0 at run time; the compiler cannot know it
NO_STORE = [(FULL, f"        if ({NEVER} && out4 && cnt == kTile) {{\n"),
            (PART, PART.replace("} else {", f"}} else if {NEVER} {{"))]
NO_COPY = [(COPY, f"            if {NEVER} {COPY.strip()}")]
# the nibble's sign and adaptation factor from a table in shared memory:
# e = adapt(v) << 8 | (signed v & 255)
STEP_END = "        return s1;\n    }\n};"
STEP_E = """        return s1;
    }

    __device__ __forceinline__ int step_e(int e) {
        int p = (int)((uint32_t)s1 * (uint32_t)c1 + (uint32_t)s2c2);
        p /= 256;
        const int q = (int)((uint32_t)(int)(int8_t)e * (uint32_t)idl);
        s2c2 = (int)((uint32_t)s1 * (uint32_t)c2);
        s1 = min(__viaddmax_s32(p, q, -32768), 32767);
        idl = max((int)((uint32_t)(e >> 8) * (uint32_t)idl) >> 8, 16);
        return s1;
    }
};"""
LANE = "    const int lane = threadIdx.x;\n"
TABLE = LANE + """    __shared__ int s_tab[16];
    if (lane < 16)
        s_tab[lane] = adapt(lane) << 8 | ((lane & 8 ? lane - 16 : lane) & 255);
    __syncwarp();
"""
STEPS = """                    const int lo = st.step((x[j >> 2] >> (8 * (j & 3))) & 15);
                    const int hi = st.step(
                        (x[j >> 2] >> (8 * ((j + 1) & 3))) & 15);"""
STEPS_E = """                    const int lo = st.step_e(
                        s_tab[(x[j >> 2] >> (8 * (j & 3))) & 15]);
                    const int hi = st.step_e(
                        s_tab[(x[j >> 2] >> (8 * ((j + 1) & 3))) & 15]);"""

CLIP = "        s1 = min(__viaddmax_s32(p, q, -32768), 32767);"
DIV = "        p /= 256;                 // toward zero: (p + (p >> 31 & 255)) >> 8\n"
ADAPT = "        idl = max((int)((uint32_t)adapt(v) * (uint32_t)idl) >> 8, 16);"

# name -> [(text of the source, its replacement)]
VARIANTS = {"shipped": [],
            **{f"rows_{r}": [(ROWS, f"constexpr int kRows = {r};")]
               for r in (24, 16, 8)},
            "stores_row_by_row": [(FULL, "        if (false) {\n")],
            "table": [(STEP_END, STEP_E), (LANE, TABLE), (STEPS, STEPS_E)],
            # the clip's add-max as an add and a max, not DPX
            "no_dpx": [(CLIP, "        s1 = min(max((int)((uint32_t)p + "
                              "(uint32_t)q), -32768), 32767);")]}
# timing only, not exact: parts of a tile left out
DIAGNOSTICS = {"no_walk": [(WALK, "        if (true) {")],
               "no_store": NO_STORE, "no_copy": NO_COPY,
               "walk_only": NO_STORE + NO_COPY,
               # the step's parts left out of its chain
               "no_clip": [(CLIP, "        s1 = (int)((uint32_t)p + "
                                  "(uint32_t)q);")],
               "no_div": [(DIV, "")],
               "idl_fixed": [(ADAPT, "        idl = adapt(v);")]}


def rows_a_warp(name: str) -> int:
    """kRows of a build: 32 but for the rows_* variants."""
    return int(name.rsplit("_")[-1]) if "rows_" in name else 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms-seconds", type=float, default=300.0,
                    help="44,100 Hz stereo MS-ADPCM for M")
    ap.add_argument("--burst", type=int, default=500,
                    help="launches queued back to back for each time")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from amv_tpu_torch.codecs import wav_audio
    from amv_tpu_torch.kernels import _build, adpcm
    from amv_tpu_torch.tools import time_trellis as tt
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools import trellis_variants as tv

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = os.path.join(_build.BUILD_DIR, "ms_variants")
    with open(os.path.join(tk._csrc(_build), SOURCE)) as f:
        procs = tv.start_builds(
            _build, tv.sources(f.read(), {**VARIANTS, **DIAGNOSTICS}),
            out_dir)

    dev = torch.device("cuda")
    data = tt.ms_stream(args.ms_seconds, np.random.default_rng(0))
    _, lanes = wav_audio._lanes(data, 2, tt.WAV_BLOCK, 14,
                                wav_audio._ms_lanes)
    nib, *st = [torch.from_numpy(a).to(dev) for a in lanes]
    nib = nib.to(torch.uint8).contiguous()
    st = [t.to(torch.int32).contiguous() for t in st]
    b, n = nib.shape
    ref = adpcm.decode_ms_nibbles(nib, *st)

    libs, res = {}, {}
    for name, proc in procs.items():
        libs[name], regs = tv.load(_build, name, proc, out_dir)
        rows = rows_a_warp(name)
        res[name] = {"rows_a_warp": rows, "registers": regs,
                     "warps": -(-b // rows), "all_ms": [], "lanes_32_ms": [],
                     "lanes_32_cycles_a_sample": [], "sm_clock": []}

    def launch(lib, rows, out):
        with _build.on_device(nib, out) as (_, stream):
            rc = lib.amv_ms_expand(nib.data_ptr(), rows, n,
                                   *(t.data_ptr() for t in st),
                                   out.data_ptr(), stream)
        assert rc == 0

    for name in [*libs, *reversed(libs)]:
        row, lib = res[name], libs[name]
        got = torch.empty_like(ref)
        launch(lib, b, got)
        torch.cuda.synchronize()
        row["exact"] = bool(torch.equal(got, ref)) and row.get("exact", True)
        assert row["exact"] or name in DIAGNOSTICS, f"{name} != M"
        for key, rows in (("all_ms", b), ("lanes_32_ms", 32)):
            ms, clock = tt.burst_ms(lambda: launch(lib, rows, got),
                                    args.burst, tk.smi)
            row[key].append(ms)
            row["sm_clock"].append(clock)
            if rows == 32:
                row["lanes_32_cycles_a_sample"].append(
                    ms * 1e3 * float(clock.split()[0]) / n)
    out = {"card": tk.smi("name,power.limit"), "lanes": b, "samples": n,
           "variants": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
