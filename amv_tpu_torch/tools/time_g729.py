"""Time kernels G and K (the G.729A decoder and encoder) and kernel M (the
MS-ADPCM expand) of the amv_tpu_torch package that comes first on
sys.path, at the main paths' shapes on one GPU:

* G (where the tree has it) on `chip_smoke.py` phase 15's batch: 1,024
  streams of 6,000 seeded frames (60 s each; 1% erasures, 1% bad parity,
  5% pitch codes >= 197), one `decode_frames_scan` launch, and one stream
  of 60,000 frames (a 10-minute file); frames/s, the real-time factor
  and the bytes bound (10 bytes in and 160 out a frame); the first 8
  frames of every stream held against the plain version on the card;
* K (where the tree has it) on seeded speech at `--k-shapes` (streams x
  frames: `chip_smoke.py` phase 16's library of 1,024 x 600, and the same
  frames over 4,096 streams), one `encode_frames_scan` launch, frames/s,
  its first frames held against the plain version; in turns with K's
  first design (`g729_encode_baseline.cu`, built into its own library:
  baseline, tree, tree, baseline), their outputs equal; the time by phase
  of both (each built again with -DK_PHASES, csrc/g729_encode_phases.cuh:
  cycles a frame a CTA between clock64() stamps); their SASS (static
  counts of instructions, shared and local loads and stores) and ptxas
  lines;
* M as `time_trellis.ms_readings` reads it: on phase 12's lanes (300 s
  of seeded 44,100 Hz stereo MS-ADPCM at block_align 2,048: 12,998 lanes
  of 2,034 samples), held against its plain version, also in a burst of
  `--burst` launches, and the whole MS-ADPCM WAVE decode.

Times: the median of CUDA events over `--reps` calls after a warm-up, the
device time a launch from `torch.profiler` (each kernel's total over the
launches it recorded), and for G the host clock around a synchronize.
`nvcc -Xptxas -v` gives each kernel's registers and
spills, and `nvdisasm` of each source built with `-lineinfo` its loops
(`line_loops`: every backward branch's body, its source lines,
instruction count, stores and carried chain) and each pipeline stage's
dependent chain a frame (`g729_floor`: the longest is G's latency floor
a frame).  Prints one JSON line: the tree, the
card's name and power limit, and the readings.

    PYTHONPATH=<tree> python3 amv_tpu_torch/tools/time_g729.py

`--only K` times K alone.  To compare two trees, run it from each in
turns (parent, change, change, parent) inside one command; its helpers
in `time_trellis.py` come from the tree on sys.path too, so a tree
before this tool's is timed by its own `time_trellis.py`.  `--device
cpu` runs the plain versions at the sizes given (the tests' rehearsal);
it measures no device time.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from amv_tpu_torch.tools import time_trellis as tt
from amv_tpu_torch.utils.roofline import bound_ms

BYTES_A_FRAME = 10 + 160


_NV_LABEL = re.compile(r"^\s*(\.L_\w+):")
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
# opcodes that write no register
_NO_DEST = ("ST", "BRA", "BAR", "WARPSYNC", "BSSY", "BSYNC", "EXIT", "RET",
            "NOP", "RED", "LDGSTS", "LDGDEPBAR", "DEPBAR", "CALL")


def _regs(text):
    return [r for r in _REG.findall(text)]


def carried_chain(body):
    """The longest run of dependent instructions through one pass of a
    loop body [(opcode, operands)], from the values it carries in (the
    registers it reads before it writes them and writes again) to their
    new values: the recurrence's latency in instructions a pass."""
    written, live_in = set(), set()
    parsed = []
    for op, args in body:
        regs = _regs(args)
        if op.startswith(_NO_DEST) or not regs:
            dst, src = [], regs
        elif op.startswith("ISETP"):
            dst, src = regs[:2], regs[2:]
        else:
            dst, src = regs[:1], regs[1:]
        src = [r for r in src if r not in dst] + [r for r in src if r in dst]
        live_in |= {r for r in src if r not in written}
        written |= set(dst)
        parsed.append((dst, src))
    depth = {r: 0 for r in live_in & written}
    carried = set(depth)
    best = 0
    for dst, src in parsed:
        d = max((depth[r] for r in src if r in depth), default=None)
        for r in dst:
            if d is None:
                depth.pop(r, None)
            else:
                depth[r] = d + 1
                if r in carried:
                    best = max(best, d + 1)
    return best


def _listing(text: str, kernel: str, source: str):
    """`kernel`'s instructions in nvdisasm --print-line-info-inline output
    of a -lineinfo build: [(opcode, operands, lines)], lines those of
    `source` its inline chain names, innermost first (an instruction with
    no line information keeps its predecessor's; one whose chain names
    only other files has none); and {label: index}."""
    body, fn, lines, chain, labels, seen = [], False, (), [], {}, False
    for raw in text.splitlines():
        m = re.search(r"\.text\.(\S+?):?$", raw.strip())
        if m and raw.strip().startswith(".text"):
            fn = kernel in m.group(1)
            continue
        if not fn:
            continue
        if "//##" in raw:
            chain += [int(n) for f, n in re.findall(
                r'"([^"]+)", line (\d+)', raw) if f.endswith(source)]
            seen = True
            continue
        m = _NV_LABEL.match(raw)
        if m:
            labels[m.group(1)] = len(body)
            continue
        m = tt.SASS_INSN.match(raw)
        if m and m.group(2) != "NOP":
            if seen:
                lines, chain, seen = tuple(chain), [], False
            body.append((m.group(2), m.group(3), lines))
    return body, labels


def line_loops(text: str, kernel: str, source: str):
    """The loops of `kernel` in nvdisasm --print-line-info-inline output of
    a -lineinfo build: for each backward branch, the source lines of
    `source` its body's instructions come from (innermost first), its
    instruction count, its stores and its carried chain."""
    body, labels = _listing(text, kernel, source)
    out = []
    for lo, hi in tt.backward_branches(body, labels):
        ins = body[lo:hi + 1]
        lines = sorted({ln[0] for _, _, ln in ins if ln})
        out.append({"lines": [lines[0], lines[-1]] if lines else None,
                    "instructions": len(ins),
                    "stores": sum(o.startswith("ST") for o, _, _ in ins),
                    "chain": carried_chain([(o, a) for o, a, _ in ins]),
                    "opcodes": collections.Counter(
                        o.split(".")[0] for o, _, _ in ins).most_common(8)})
    return out


def longest_chain(body):
    """The longest run of dependent instructions in [(opcode, operands)],
    in program order."""
    depth, best = {}, 0
    for op, args in body:
        regs = _regs(args)
        if op.startswith(_NO_DEST) or not regs:
            dst, src = [], regs
        elif op.startswith("ISETP"):
            dst, src = regs[:2], regs[2:]
        else:
            dst, src = regs[:1], regs[1:]
        d = 1 + max((depth.get(r, 0) for r in src), default=0)
        for r in dst:
            depth[r] = d
        best = max(best, d)
    return best


# kernel G's build whose chains bound one stream: the instantiation at 4
# CTAs an SM (128 registers a thread; the one at 8 serves large batches)
G_KERNEL = "g729_decode_kernelILi4E"

# Hopper's latency of a dependent integer instruction (IMAD, IADD3, LOP3,
# SHF, VIMNMX), in cycles: the floor counts each instruction on a chain
# at this much
DEP_CYCLES = 4


def _lines_between(text: str, first: str, last: str):
    """The 1-based line numbers from the line holding `first` to the next
    one holding `last`."""
    lines = text.splitlines()
    lo = next(i for i, ln in enumerate(lines) if first in ln)
    hi = next(i for i, ln in enumerate(lines) if i >= lo and last in ln)
    return range(lo + 1, hi + 2)


def _stretch_chains(insns, members, gap: int = 16):
    """The longest dependent chain through each stretch of `members`
    (indices into insns [(opcode, operands, ...)], at most `gap` apart)."""
    runs = []
    for i in members:
        if runs and i - runs[-1][-1] <= gap:
            runs[-1].append(i)
        else:
            runs.append([i])
    return [longest_chain([(o, a) for o, a, *_ in insns[r[0]:r[-1] + 1]])
            for r in runs]


STAGES = (("parameters", "// ---- parameters of frame t"),
          ("excitation", "// ---- excitation and LP synthesis of frame t"),
          ("postfilter", "// ---- the postfilter of frame t"),
          ("high-pass", "// ---- the 100 Hz high-pass of frame t"))


def g729_floor(text: str, csrc: str):
    """A frame's latency floor in dependent instructions, from the nvdisasm
    listing of csrc/g729_decode.cu (a -lineinfo build; csrc the sources'
    directory): each pipeline stage's chain a frame, and the longest of
    them, which bounds a step.  A stage's instructions are those whose
    inline chain passes through its block of g729_decode.cu.
    * parameters: the longest dependent chain through the whole block (the
      LSF decode and sort, the LSP polynomials, the tilt's 22-step impulse
      response, the gains' log2/pow2 and divisions; its loops once);
    * excitation: twice (a subframe) one sample's interpolation and the
      first LP synthesis (the overflow redo left out);
    * postfilter: twice the long-term filter's correlation, the 1/A(z/gd)
      synthesis and the AGC's 40 steps;
    * high-pass: its 80 steps.
    A floor: the shuffles, the loads and the barrier between steps are
    left out."""
    with open(os.path.join(csrc, "g729_decode.cu")) as f:
        dsrc = f.read()
    with open(os.path.join(csrc, "g729_common.cuh")) as f:
        csrc_text = f.read()
    kernel = G_KERNEL
    body, _ = _listing(text, kernel, "g729_decode.cu")
    cbody, _ = _listing(text, kernel, "g729_common.cuh")
    insns = [(o, a, dl, cl) for (o, a, dl), (_, _, cl) in zip(body, cbody)]
    marks, lines = [0], dsrc.splitlines()
    for m in [m for _, m in STAGES] + ["// the state after frame T"]:
        marks.append(next(i + 1 for i, ln in enumerate(lines)
                          if i >= marks[-1] and m in ln))
    marks = marks[1:]

    def where(rng, lines):
        return any(x in rng for x in lines)

    synth = _lines_between(csrc_text, "bool synthesis(", "return ovf;")
    interp = _lines_between(csrc_text, "int v = 0;",
                            "exc[base + n] = g729_round(")
    agc = _lines_between(dsrc, "int gp = gain_coeff;", "gain_coeff = gp;")
    corr = _lines_between(dsrc, "uint32_t acc = 0;", "acc += (uint32_t)a")
    hp = _lines_between(dsrc, "const int x = f.pcm[n];", "hz1 = x;")
    stages = {}
    for k, (name, _) in enumerate(STAGES):
        rng = range(marks[k], marks[k + 1])
        mem = [i for i, ins in enumerate(insns) if where(rng, ins[2])]

        def part(lines, in_common=True):
            return [c for c in _stretch_chains(insns, [
                i for i in mem if where(lines, insns[i][3 if in_common
                                                       else 2])]) if c > 8]
        if name == "parameters":
            parts = {"block": longest_chain([insns[i][:2] for i in mem])}
        elif name == "excitation":
            sites = part(synth)[0::2]       # each subframe's first pass
            parts = {"synthesis": sum(sites) * (2 // len(sites)),
                     "interpolation": 2 * max(part(interp))}
        elif name == "postfilter":
            sites = part(synth)
            parts = {"synthesis": sum(sites) * (2 // len(sites)),
                     "agc": 2 * max(part(agc, False)),
                     "correlation": 2 * max(part(corr, False))}
        else:
            parts = {"high-pass": max(part(hp, False))}
        stages[name] = {"instructions": len(mem), "parts": parts,
                        "chain": sum(parts.values())}
    longest = max(stages, key=lambda n: stages[n]["chain"])
    chain = stages[longest]["chain"]
    return {"stages": stages, "binding": longest, "instructions": chain,
            "cycles": DEP_CYCLES * chain}


def listing(build, source: str, save=None) -> str:
    """nvcc -lineinfo of csrc/<source> to a cubin, and nvdisasm's listing
    with inlined line information (written to `save` when given)."""
    import tempfile
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    bindir = os.path.dirname(build._nvcc())
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    flags += getattr(build, "SOURCE_FLAGS", {}).get(source, [])
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([build._nvcc(), *flags, "-lineinfo", "-cubin", "-o",
                        cubin, os.path.join(tk._csrc(build), source)],
                       capture_output=True, text=True, check=True)
        text = subprocess.run(
            [os.path.join(bindir, "nvdisasm"), "--print-line-info-inline",
             cubin], capture_output=True, text=True, check=True).stdout
    if save:
        with open(save, "w") as f:
            f.write(text)
    return text


K_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "g729_encode_baseline.cu")


def k_libraries(build, sources, csrc=None):
    """Kernel K sources built with nvcc (K's own flags; all started
    together) into libraries of their own beside the port's, and loaded:
    {name: CDLL} for sources {name: (path, phases)}; `phases` adds
    -DK_PHASES (csrc/g729_encode_phases.cuh: the time by phase)."""
    import ctypes
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    csrc = csrc or tk._csrc(build)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    flags = [*build.NVCC_FLAGS, *build.SOURCE_FLAGS["g729_encode.cu"],
             "-shared", "-I", csrc]
    sos = {name: os.path.join(build.BUILD_DIR, f"libk_{name}.so")
           for name in sources}
    build._run([[build._nvcc(), *flags, *(["-DK_PHASES"] if ph else []),
                 "-o", sos[name], path]
                for name, (path, ph) in sources.items()])
    libs = {}
    for name, (path, ph) in sources.items():
        lib = ctypes.CDLL(sos[name])
        lib.amv_g729_encode.argtypes = build._SIGNATURES["amv_g729_encode"]
        lib.amv_g729_encode.restype = ctypes.c_int
        if ph:
            lib.amv_g729_encode_phases.argtypes = [ctypes.c_void_p]
            lib.amv_g729_encode_phases.restype = ctypes.c_int
            lib.amv_g729_encode_phase_names.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def encode_with(lib, st, hist, frames):
    """K from `lib` (a k_libraries entry) on CUDA tensors: (state after
    frame T, hist, parms), as `kernels.g729.encode_frames` returns them."""
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.kernels import g729 as K
    t, b = frames.shape[:2]
    x = frames.to(torch.float32).contiguous()
    flat = K.flatten_state(st)
    h = hist.to(torch.float32).contiguous().clone()
    parms = torch.empty((t, b, 16), dtype=torch.int32, device=x.device)
    with _build.on_device(x, flat, h, parms) as (_, stream):
        rc = lib.amv_g729_encode(x.data_ptr(), t, b, flat.data_ptr(),
                                 h.data_ptr(), parms.data_ptr(), stream)
    _build.check(rc, "amv_g729_encode")
    return K.unflatten_state(flat), h, parms


def k_phases(lib, st, hist, frames):
    """K's time by phase from a profile build: {phase: cycles a frame a
    CTA} (thread 0's clock64() between the stamps, summed over the CTAs
    and divided by streams x frames), the run's ms, and the total."""
    n = frames.shape[0] * frames.shape[1]
    buf = np.zeros(64, np.uint64)
    lib.amv_g729_encode_phases(buf.ctypes.data)             # cleared
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    encode_with(lib, st, hist, frames)
    b.record()
    torch.cuda.synchronize()
    lib.amv_g729_encode_phases(buf.ctypes.data)
    names = lib.amv_g729_encode_phase_names().decode().split(",")
    cyc = {k: float(v) / n for k, v in zip(names, buf) if v}
    return {"cycles": cyc, "total": sum(cyc.values()),
            "ms": a.elapsed_time(b)}


def k_turns(E, lib, st0, h0, fr, reps):
    """K's first design (lib: baseline) and the tree's K on the same inputs
    in turns (baseline, tree, tree, baseline), each the median of `reps`
    launches by CUDA events; their parameters, hist and state must be
    equal."""
    out = {"baseline_ms": [], "tree_ms": []}
    got = {}
    for name in ("baseline", "tree", "tree", "baseline"):
        fn = (lambda: encode_with(lib, st0, h0, fr)) if name == "baseline" \
            else (lambda: E.encode_frames_scan(st0, h0, fr))
        ms, got[name] = tt.event_ms(fn, reps, fr.device)
        out[f"{name}_ms"].append(ms)
    (sa, ha, pa), (sb, hb, pb) = got["baseline"], got["tree"]
    assert torch.equal(pa, pb), "the tree's K parameters != the baseline's"
    assert torch.equal(ha.view(torch.int32), hb.view(torch.int32))
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"state {k} != the baseline's"
    return out


def sass_ops(so: str, key: str):
    """{kernel function holding key: {"instructions": n, opcode: count}}
    of a library's sm_90a code (cuobjdump; static counts), with the shared
    loads and stores and the local ones (the stack) picked out."""
    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if key in m.group(1) else None
            continue
        m = tk._INSN.match(line)
        if fn and m and m.group(1) != "NOP":
            counts[fn][m.group(1).split(".")[0]] += 1
    return {f: {"instructions": sum(c.values()),
                **{o: c[o] for o in ("LDS", "STS", "LDL", "STL", "FADD",
                                     "FMUL", "MUFU", "BAR", "SHFL")},
                "top": c.most_common(8)} for f, c in counts.items()}


def ptxas_of(build, path):
    """nvcc -Xptxas -v of one K source (K's flags): each entry function's
    registers, stack and spills."""
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *build.SOURCE_FLAGS[
            "g729_encode.cu"], "-I", tk._csrc(build), "-Xptxas", "-v", "-c",
         "-o", os.devnull, path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return tk.ptxas_lines([(os.path.basename(path), proc)])


def g_readings(G, fixtures, dev, args):
    """Kernel G on the batch and on one long stream."""
    from amv_tpu_torch.kernels import g729 as K
    rng = np.random.default_rng(0)
    out = {}
    for key, b, t in (("batch", args.batch, args.frames),
                      ("long", 1, args.long_frames)):
        frames = fixtures.g729_frames(rng, t, b, erasure=0.01,
                                      bad_parity=0.01, high_pitch=0.05)
        parms = G.unpack_frames(torch.from_numpy(frames).to(dev))
        st0 = G.init_state(b, device=dev)
        l0 = K.LAUNCHES
        ms, (st, pcm) = tt.event_ms(
            lambda: G.decode_frames_scan(st0, parms), args.reps, dev)
        launches = (K.LAUNCHES - l0) / (args.reps + 1)
        split = tt.device_ms(lambda: G.decode_frames_scan(st0, parms),
                             max(1, args.reps // 2), dev)
        host = []
        for _ in range(3):            # the host clock around a synchronize
            _sync = torch.cuda.synchronize if dev.type == "cuda" else int
            _sync()
            t0 = time.perf_counter()
            G.decode_frames_scan(st0, parms)
            _sync()
            host.append(1e3 * (time.perf_counter() - t0))
        dev_ms = None if split is None else sum(
            v for k, v in split.items() if "g729" in k)
        n = b * t
        r = {"streams": b, "frames": t, "ms": ms, "device_ms": dev_ms,
             "host_ms": sorted(host),
             "device_split_ms": split,
             "launches_a_call": launches if dev.type == "cuda" else 0,
             "frames_s": n / ms * 1e3,
             "real_time_factor": n * 10.0 / ms,
             "bytes_bound_ms": bound_ms(n * BYTES_A_FRAME)[0]}
        k = min(args.check_frames, t)
        sp, want = G.init_state(b, device=dev), []
        for i in range(k):
            sp, w = G.decode_frame_batch(sp, parms[i])
            want.append(w)
        assert torch.equal(pcm[:k], torch.stack(want)), f"G {key} != plain"
        r["checked_frames"] = k
        stream = G.decode_streams(torch.from_numpy(frames).to(dev))
        assert torch.equal(stream, pcm.permute(1, 0, 2).reshape(b, -1))
        out[key] = r
    return out


def k_shape(text: str):
    """"1024x600" -> (1024, 600): streams x frames."""
    b, t = text.lower().split("x")
    return int(b), int(t)


def k_readings(E, G, fixtures, dev, args, libs=None):
    """Kernel K on seeded speech at each of `--k-shapes` (streams x
    frames; one `encode_frames_scan` launch): its time, frames/s, its
    first frames held against the plain version on the card; given the
    libraries of `k_libraries` ("baseline", and the profile builds
    "baseline phases" and "tree phases"), in turns with the baseline and
    the time by phase of each."""
    from amv_tpu_torch.kernels import g729 as K
    out = {}
    for b, t in map(k_shape, args.k_shapes.split(",")):
        pcm = torch.from_numpy(fixtures.speech_streams(b, t * 80, 16)).to(dev)
        fr = pcm.float().reshape(b, t, 80).permute(1, 0, 2).contiguous()
        st0 = G.init_state(b, device=dev)
        h0 = torch.zeros((b, 160), dtype=torch.float32, device=dev)
        l0 = K.ENCODE_LAUNCHES
        ms, (_, _, parms) = tt.event_ms(
            lambda: E.encode_frames_scan(st0, h0, fr), max(1, args.reps // 3),
            dev)
        k = min(args.check_frames, t, 2)
        sp, hp = st0, h0
        for i in range(k):
            sp, hp, p = E.encode_frame_batch(sp, hp, fr[i])
            assert torch.equal(p, parms[i]), f"K frame {i} != plain"
        r = {"streams": b, "frames": t, "ms": ms,
             "frames_s": b * t / ms * 1e3,
             "launches": K.ENCODE_LAUNCHES - l0, "checked_frames": k}
        if libs:
            r["turns"] = k_turns(E, libs["baseline"], st0, h0, fr,
                                 max(1, args.reps // 3))
            r["phases"] = {name: k_phases(libs[f"{name} phases"], st0, h0,
                                          fr)
                           for name in ("baseline", "tree")}
        out[f"{b}x{t}"] = r
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=6000)
    ap.add_argument("--long-frames", type=int, default=60000)
    ap.add_argument("--check-frames", type=int, default=8)
    ap.add_argument("--k-shapes", default="1024x600,4096x150",
                    help="K's streams x frames, comma-separated")
    ap.add_argument("--only", default="M,G,K",
                    help="the kernels to time, comma-separated")
    ap.add_argument("--ms-seconds", type=float, default=300.0,
                    help="44,100 Hz stereo MS-ADPCM for M")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--burst", type=int, default=2000,
                    help="M's launches queued back to back for M_burst_ms")
    ap.add_argument("--sass-dir", default=None,
                    help="write each kernel's nvdisasm listing here")
    args = ap.parse_args(argv)
    import amv_tpu_torch
    from amv_tpu_torch.codecs import wav_audio
    from amv_tpu_torch.kernels import _build, adpcm
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.verify import fixtures
    try:
        G = importlib.import_module("amv_tpu_torch.codecs.g729a")
    except ImportError:
        G = None                      # a tree before kernel G
    try:
        E = importlib.import_module("amv_tpu_torch.codecs.g729a_encoder_batch")
    except ImportError:
        E = None                      # a tree before kernel K

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (or --device cpu)")
    only = set(args.only.split(","))
    srcs = [s for s in ("g729_decode.cu", "g729_encode.cu", "adpcm_ms.cu")
            if os.path.exists(os.path.join(tk._csrc(_build), s))]
    ptx = None
    if dev.type == "cuda":
        ptx = tk.ptxas_start(_build, srcs)
        _build.library()
    out = {"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(amv_tpu_torch.__file__)))}
    out["card"] = tk.smi("name,power.limit") if dev.type == "cuda" \
        else "cpu"
    ms = tt.ms_readings(adpcm, wav_audio, dev, args) if "M" in only else {}
    if G is not None and "G" in only:
        ms["G"] = g_readings(G, fixtures, dev, args)
    if E is not None and "K" in only:
        libs = None
        if dev.type == "cuda" and os.path.exists(K_BASELINE):
            tree_k = os.path.join(tk._csrc(_build), "g729_encode.cu")
            libs = k_libraries(_build, {
                "baseline": (K_BASELINE, False),
                "baseline phases": (K_BASELINE, True),
                "tree phases": (tree_k, True)})
            out["K_sass"] = {
                "tree": sass_ops(_build.build(), "g729_encode_kernel"),
                "baseline": sass_ops(os.path.join(
                    _build.BUILD_DIR, "libk_baseline.so"),
                    "g729_encode_kernel")}
            out["K_ptxas_baseline"] = ptxas_of(_build, K_BASELINE)
        ms["K"] = k_readings(E, G, fixtures, dev, args, libs)
    out["ms"] = ms
    out["ptxas"] = tk.ptxas_lines(ptx) if ptx else None
    if dev.type == "cuda" and only & {"M", "G"}:
        sass = {src: listing(_build, src, save=args.sass_dir and
                             os.path.join(args.sass_dir, src + ".sass"))
                for src in srcs if src != "g729_encode.cu"}
        out["line_loops"] = {
            src: line_loops(sass[src], k, src)
            for src, k in (("adpcm_ms.cu", "ms_expand_kernel"),
                           ("g729_decode.cu", G_KERNEL))
            if src in srcs}
        if "g729_decode.cu" in srcs:
            out["g729_floor"] = g729_floor(sass["g729_decode.cu"],
                                           tk._csrc(_build))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
