"""Time variants of kernel L (csrc/adpcm_trellis.cu) against the shipped
source on one GPU, in one process: each variant is a text edit of a copy
of the source, built by nvcc into its own library, launched through
ctypes on phase 13's inputs (300 s of seeded audiogen PCM at 22,050 Hz in
the encoder's 4,800 chunks of 1,378 samples, from the chain's fixed
point), held bit-exact against the package's kernel and timed by CUDA
events (median of 7 launches after one) over all chunks, over 734 of them
(the chain's third round) and over one (a warp alone: its latency).

    PYTHONPATH=. python3 amv_tpu_torch/tools/trellis_variants.py

Prints one JSON line: the card's name and power limit, its SM clock, and
for each variant its registers (ptxas), times and exactness.  The
variants record what the shipped form was measured against: its
occupancy (one warp a CTA; registers capped for 19 resident warps an SM,
so that 4,800 chunks run in two waves; the limit raised), where the step
differences live, and unrolling.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess

SOURCE = "adpcm_trellis.cu"
CHUNKS = "constexpr int kChunks = 4;"
BOUNDS = "__launch_bounds__(kThreads, kMinWarps / kChunks)"
DIFF_REGS = """    int d[3][8];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int4 da = s_diff[w][6 * lane + 2 * j];
        const int4 db = s_diff[w][6 * lane + 2 * j + 1];
        d[j][0] = da.x, d[j][1] = da.y, d[j][2] = da.z, d[j][3] = da.w;
        d[j][4] = db.x, d[j][5] = db.y, d[j][6] = db.z, d[j][7] = db.w;
    }
"""
SAMPLE_TOP = """        const int hi = 32767 - x0, nlo = x0 + 32768, dx = x0 - xc;
"""
SAMPLE_LOOP = "        for (int r = 0; r < ng; ++r) {"
DIFF_EACH_SAMPLE = """        int d[3][8];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int4 da = dl[2 * j], db = dl[2 * j + 1];
            d[j][0] = da.x, d[j][1] = da.y, d[j][2] = da.z, d[j][3] = da.w;
            d[j][4] = db.x, d[j][5] = db.y, d[j][6] = db.z, d[j][7] = db.w;
        }
"""

# name -> [(text of the source, its replacement)]
VARIANTS = {
    "shipped": [],
    "one_warp_a_cta": [(CHUNKS, "constexpr int kChunks = 1;")],
    "19_warps_an_sm": [(CHUNKS, "constexpr int kChunks = 1;"),
                       (BOUNDS, "__launch_bounds__(kThreads, 19)")],
    "more_registers": [(BOUNDS, "__launch_bounds__(kThreads, 3)")],
    "diffs_in_smem": [
        (DIFF_REGS, "    const int4 *dl = s_diff[w] + 6 * lane;\n"),
        (SAMPLE_TOP, SAMPLE_TOP + DIFF_EACH_SAMPLE)],
    "unrolled_8": [(SAMPLE_LOOP, "#pragma unroll\n        for (int r = 0; "
                                 "r < kGroup; ++r) { if (r >= ng) break;")],
}


def sources(text: str, variants=None) -> dict:
    """{variant: its source text} of `variants` ({name: [(text, its
    replacement)]}, by default this tool's); raises if an edit no longer
    applies."""
    out = {}
    for name, edits in (VARIANTS if variants is None else variants).items():
        s = text
        for old, new in edits:
            if old not in s:
                raise ValueError(f"{name}: the source no longer holds "
                                 f"{old.strip()[:60]!r}")
            s = s.replace(old, new)
        out[name] = s
    return out


def start_builds(build, texts: dict, out_dir: str) -> dict:
    """nvcc of each {name: source text} into out_dir/<name>.so, all
    started together: {name: its process}."""
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", tk._csrc(build),
             "-Xptxas", "-v", "-shared", "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def load(build, name: str, proc, out_dir: str):
    """The library a build of start_builds made, its C entries typed, and
    its kernels' registers as ptxas gives them."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}:\n{log}")
    lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    for entry, argtypes in build._SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = build._RESTYPES.get(entry,
                                                              ctypes.c_int)
    return lib, [int(r) for r in re.findall(r"Used (\d+) registers", log)]


def main() -> dict:
    import torch

    from amv_tpu_torch.codecs import amv_audio
    from amv_tpu_torch.kernels import _build, adpcm
    from amv_tpu_torch.kernels import adpcm_trellis as L
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.verify import fixtures

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    with open(os.path.join(tk._csrc(_build), SOURCE)) as f:
        procs = start_builds(_build, sources(f.read()), out_dir)

    dev = torch.device("cuda")
    pcm = fixtures.audiogen(300.0, 22050, seed=0)
    ns, starts, padded, reset = amv_audio.stream_layout(pcm, 1378, 22050)
    x = torch.from_numpy(padded).to(dev)
    st = torch.from_numpy(starts).to(dev)
    pairs = torch.tensor(ns, dtype=torch.int32, device=dev)
    pred0 = x[st].to(torch.int32)
    _, sidx = adpcm.encode_streams(
        x[None], torch.from_numpy(reset[None]).to(dev),
        torch.zeros(1, dtype=torch.int32, device=dev))
    _, step, _ = L.encode_chain(x, st, pairs, 0, sidx[0, st // 2].to(
        torch.int32))
    ref = torch.zeros(x.numel() // 2, dtype=torch.uint8, device=dev)
    fref = L.trellis_chunks(x, st, pairs, step, pred0, ref)
    len_max = 2 * max(ns)

    res = {}
    for name, proc in procs.items():
        lib, regs = load(_build, name, proc, out_dir)
        row = {"registers": regs}
        for label, n in (("all_ms", len(ns)), ("734_ms", 734),
                         ("one_ms", 1)):
            with _build.on_device(x) as (_, stream):
                back = torch.empty(lib.amv_trellis_scratch(n, len_max),
                                   dtype=torch.uint8, device=dev)
            buf = torch.zeros_like(ref)
            fin = torch.empty(n, dtype=torch.int32, device=dev)
            args = [t.data_ptr() for t in (x, st, pairs, step, pred0)] + [
                n, len_max, back.data_ptr(), buf.data_ptr(), fin.data_ptr(),
                stream]
            times = []
            for _ in range(8):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                with _build.on_device(x, buf, fin):
                    assert lib.amv_trellis(*args) == 0, name
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            row[label] = statistics.median(times[1:])
            if n == len(ns):
                row["exact"] = bool(torch.equal(buf, ref) and
                                    torch.equal(fin, fref))
        res[name] = row
    out = {"card": tk.smi("name,power.limit"), "sm_mhz": tk.smi("clocks.sm"),
           "variants": res}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
