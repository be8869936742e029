"""Time kernels T (the block transcode) and A (the IMA-ADPCM decode) of the
amv_tpu_torch package that comes first on sys.path, at the main paths'
shapes on one GPU, and report what the compiler made of them.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_transcode_kernel.py

T, on 4,800 frames of 160x120 (2,304,000 blocks): the layout entry
(`transcode_blocks`), the pixel entry (`transcode_blocks_pix`), both
with the 160x120 edge replication, the dequantized entry
(`transcode_deq`) on the same blocks dequantized, and the wrap
(`transcode_blocks_pix(repeat=64)`) over the first 512 frames' blocks,
15.7 M blocks out, as `chip_smoke.py` runs them.  The levels are seeded
sparse random ones (8% nonzero AC, DC differences of corpus size) rather
than decoded frames, so any tree of the port can run it with nothing but
its kernel.  A, on the file's audio as `chip_smoke.py` builds it (one
encoded second of seeded audiogen at 22,050 Hz repeated for 300 s: 4,800
chunks of 689 bytes) and its wrap 64 times over.

Times are the median of CUDA events over `reps` launches after a
warm-up (they hold the wrapper's host work before the launch when the
card has nothing queued), and each entry's device time per call from
torch.profiler (`_device`: its kernels' time alone).  Beside them:
`nvcc -Xptxas -v` of csrc/transcode.cu and csrc/adpcm_decode.cu
(registers, spills, shared memory), and the SASS
instructions of every kernel of the two sources in the built library
(`cuobjdump -sass`: static counts, NOPs left out, and the ten commonest
opcodes); T's static count split by the part of the transform each
instruction comes from (`nvcc -lineinfo` and `nvdisasm`'s inlined line
information: dequant, IDCT, FDCT, quantizer, edge replication, and the
rest of the kernel's body); and for each of T's entries a static-count
estimate of its issue time, its instance's instructions x the entry's
blocks / 32 over 132 SMs x 4 schedulers x the card's highest SM clock:
an upper bound on the time its instructions take to issue at one warp
instruction a clock per scheduler, since the static count holds both
sides of every branch.  Prints one JSON line: the tree, the card's name
and power limit, and the readings.  To compare two trees, run it from
each in turns (parent, change, change, parent) inside one command.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import tempfile

import numpy as np
import torch

N, NB, WRAP, N_WRAP = 4800, 480, 64, 512
SMS, SCHEDULERS = 132, 4


def cuda_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def device_ms(fn, reps):
    """Device milliseconds per call of fn: the sum of its kernels' times
    (torch.profiler), without the host work around the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _csrc(build):
    return os.path.join(os.path.dirname(os.path.abspath(build.__file__)),
                        os.pardir, "csrc")


def ptxas_start(build, names):
    """nvcc -Xptxas -v of each source in `names` under csrc/, started (the
    object goes nowhere): [(name, process)] for `ptxas_lines`."""
    return [(name, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, os.path.join(_csrc(build), name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in names]


def ptxas_lines(procs):
    """{source: ["function: ptxas line", ...]}: each entry function's
    registers, shared memory, stack and spills, as ptxas says."""
    out = {}
    for name, proc in procs:
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        out[name], fn = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("Used" in line or "spill" in line):
                out[name].append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def ptxas(build, names):
    """{source: [ptxas lines of each entry function]}."""
    return ptxas_lines(ptxas_start(build, names))


_INSN = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def sass_counts(build, keys):
    """{kernel function: (instructions, ten commonest opcodes)} of the
    built library's sm_90a code, for functions whose name holds a key."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", build.build()],
                          capture_output=True, text=True, check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in keys) else None
            continue
        m = _INSN.match(line)
        if fn and m and m.group(1) != "NOP":
            counts[fn][m.group(1).split(".")[0]] += 1
    return {f: (sum(c.values()), c.most_common(10)) for f, c in counts.items()}


def t_instance(fn: str) -> str:
    """Kernel T's entry for a (mangled) instance name of
    transcode_blocks_kernel<kMode, kPix>: "zigzag", "zigzag pix",
    "wrap pix" or "deq pix"; of an earlier tree's <kMode> alone, "zigzag",
    "wrap" or "deq"."""
    mode, pix = re.search(r"ILi(\d)E(?:Lb([01])E)?", fn).groups()
    return ("zigzag", "wrap", "deq")[int(mode)] + (" pix" if pix == "1"
                                                   else "")


def issue_ms(instructions: int, blocks: int, mhz: float) -> float:
    """Static-count estimate of kernel T's issue time: one thread a block,
    so instructions x blocks / 32 warp instructions over 132 SMs x 4
    schedulers, one a clock each, at `mhz` (an upper bound on the time
    the instructions take to issue: the static count holds both sides of
    every branch)."""
    return 1e3 * instructions * blocks / 32 / (SMS * SCHEDULERS * mhz * 1e6)


# the parts of kernel T that its instructions are attributed to: functions
# of csrc/transcode.cu and csrc/dct.cuh, and the kernel's own edge block
# (found by the text that opens it)
T_PARTS = (
    ("dequant", "transcode.cu", ("load_block",)),
    ("IDCT", "dct.cuh", ("idct_row", "idct_col", "idct_put", "clamp255")),
    ("FDCT", "dct.cuh", ("fdct_1d", "fdct")),
    ("quantizer", "dct.cuh", ("quant_dc", "quant_ac")),
    ("edge replication", "transcode.cu", ("edge_area", "if (edge) {")))


def _braced(lines, start):
    """The 1-based line range from `start` (0-based) to the line that
    closes the first brace opened on or after it."""
    depth, opened = 0, False
    for i in range(start, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        opened = opened or "{" in lines[i]
        if opened and depth <= 0:
            return range(start + 1, i + 2)
    raise ValueError(f"unclosed brace from line {start + 1}")


def t_part_lines(src):
    """[(part, file name, range of 1-based lines)] of T_PARTS in the
    sources under `src`."""
    out = []
    for part, name, keys in T_PARTS:
        lines = open(os.path.join(src, name)).read().splitlines()
        for key in keys:
            pat = (re.compile(r"__device__.*\b" + key + r"\(")
                   if key.isidentifier() else None)
            hits = [i for i, line in enumerate(lines)
                    if (pat.search(line) if pat else key in line)]
            if len(hits) != 1:
                raise ValueError(f"{key!r} in {name}: {len(hits)} matches")
            out.append((part, name, _braced(lines, hits[0])))
    return out


def sass_parts(build):
    """{T entry: {part: instructions}}: kernel T's SASS, from csrc/
    transcode.cu compiled again with -lineinfo, each instruction counted
    under the first part (T_PARTS) that its inlined source lines fall in,
    innermost first; "body" for the kernel's own lines (staging, indices,
    the pixel and level packing and stores), "no line" for instructions
    with none.  Beside them "total", to hold against `sass_counts`."""
    bindir = os.path.dirname(build._nvcc())
    parts = t_part_lines(_csrc(build))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "transcode.cubin")
        subprocess.run([build._nvcc(), *flags, "-lineinfo", "-cubin", "-o",
                        cubin, os.path.join(_csrc(build), "transcode.cu")],
                       capture_output=True, text=True, check=True)
        text = subprocess.run(
            [os.path.join(bindir, "nvdisasm"), "--print-line-info-inline",
             cubin], capture_output=True, text=True, check=True).stdout
    return attribute(text, parts)


def attribute(text, parts):
    """{T entry: Counter of part: instructions} of nvdisasm's output with
    inlined line information: the `//##` lines before an instruction name
    its source line and, one level each, the lines it was inlined at,
    innermost first; an instruction with none keeps its predecessor's."""
    counts = collections.defaultdict(collections.Counter)
    fn, part, chain = None, "no line", []
    for line in text.splitlines():
        m = re.search(r"\.text\.(\w+)", line)
        if m:
            fn = (t_instance(m.group(1))
                  if "transcode_blocks_kernel" in m.group(1) else None)
            part, chain = "no line", []
            continue
        if "//##" in line:
            chain += [(os.path.basename(f), int(n)) for f, n in
                      re.findall(r'"([^"]+)", line (\d+)', line)]
            continue
        m = _INSN.match(line)
        if fn and m and m.group(1) != "NOP":
            if chain:
                part = next((p for f, n in chain for p, pf, r in parts
                             if f == pf and n in r), "body")
                chain = []
            counts[fn][part] += 1
            counts[fn]["total"] += 1
    if not counts:
        raise RuntimeError("no kernel T instructions in nvdisasm's output")
    return {f: dict(c.most_common()) for f, c in sorted(counts.items())}


def main(reps: int = 30) -> None:
    import amv_tpu_torch
    from amv_tpu_torch.codecs import amv_audio
    from amv_tpu_torch.codecs.amv_video import encoder_qmat
    from amv_tpu_torch.kernels import _build, adpcm, idct
    from amv_tpu_torch.kernels import transcode as T
    from amv_tpu_torch.verify import fixtures, ref_adpcm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.default_rng(0)
    n = N * NB
    lv = np.where(rng.random((n, 64)) < 0.08,
                  rng.integers(-60, 61, (n, 64)), 0).astype(np.int16)
    dc = rng.integers(0, 2048, n).astype(np.int32)
    lv_t = torch.from_numpy(lv).cuda()
    dc_t = torch.from_numpy(dc).cuda()
    q = encoder_qmat(2)
    deq = idct.dequantize(lv_t, dc_t).to(torch.int16)
    base = lv_t[:N_WRAP * NB]
    dc_w = dc_t[:base.shape[0]][T.wrap_index(base.shape[0], WRAP, "cuda")]
    second = ref_adpcm.encode(fixtures.audiogen(1.0, 22050, seed=0),
                              round(22050 / 16), 22050)
    pay, pred, sidx, _ = amv_audio.chunk_arrays(second * (N // 16))
    pay, pred, sidx = (torch.from_numpy(a).cuda() for a in (pay, pred, sidx))
    entries = {
        "T": lambda: T.transcode_blocks(lv_t, dc_t, q, (160, 120)),
        "T_pix": lambda: T.transcode_blocks_pix(lv_t, dc_t, q, (160, 120)),
        "T_deq": lambda: T.transcode_deq(deq, q),
        "T_wrap": lambda: T.transcode_blocks_pix(base, dc_w, q,
                                                 repeat=WRAP),
        "A": lambda: adpcm.decode_chunks(pay, pred, sidx),
        "A_wrap": lambda: adpcm.decode_chunks(pay, pred, sidx, repeat=WRAP)}
    out = {}
    for key, fn in entries.items():
        out[key], out[key + "_all"] = cuda_ms(fn, reps)
        out[key + "_device"] = device_ms(fn, 10)
        torch.cuda.empty_cache()
    mhz = float(smi("clocks.max.sm").split()[0])
    sass = sass_counts(_build, ("transcode_blocks_kernel", "adpcm_decode"))
    # each entry at its own blocks: the wrap's output is N_WRAP frames'
    # blocks WRAP times over
    blocks = {"wrap": base.shape[0] * WRAP, "other": n}
    issue = {}
    for f, (c, _) in sass.items():
        if "transcode" in f:
            entry = t_instance(f)
            issue[entry] = issue_ms(
                c, blocks["wrap" if entry.startswith("wrap") else "other"],
                mhz)
    try:
        parts = sass_parts(_build)
    except (OSError, RuntimeError, ValueError,
            subprocess.CalledProcessError) as e:
        parts = {"error": repr(e)}
    print(json.dumps({
        "tree": os.path.dirname(os.path.dirname(
            os.path.abspath(amv_tpu_torch.__file__))),
        "card": smi("name,power.limit"), "max_sm_mhz": mhz, "blocks": n,
        "chunks": list(pay.shape), **out,
        "ptxas": ptxas(_build, ("transcode.cu", "adpcm_decode.cu")),
        "sass": sass, "T_sass_parts": parts, "T_blocks": blocks,
        "T_issue_ms_static_estimate": issue}))


if __name__ == "__main__":
    main()
