"""The pure parts of amv_tpu_torch/tools/time_transcode_kernel.py, which
the chip runs read kernel T's instruction counts through."""

import pytest

from amv_tpu_torch.kernels import _build
from amv_tpu_torch.tools import time_transcode_kernel as tool


def test_t_parts_found_once_and_disjoint():
    """Each part of kernel T's transform names one range of source lines,
    and no two ranges of a file overlap, so every instruction is counted
    under one part."""
    found = tool.t_part_lines(tool._csrc(_build))
    assert {p for p, _, _ in found} == {p for p, _, _ in tool.T_PARTS}
    for i, (_, fa, ra) in enumerate(found):
        assert len(ra) >= 3
        for _, fb, rb in found[i + 1:]:
            assert fa != fb or not set(ra) & set(rb)


@pytest.mark.parametrize("mode,pix,entry", [
    (0, "Lb0E", "zigzag"), (0, "Lb1E", "zigzag pix"), (1, "Lb1E", "wrap pix"),
    (2, "Lb1E", "deq pix"), (1, "", "wrap")])
def test_t_instance_names(mode, pix, entry):
    # the last case: an earlier tree's kernel, templated on its mode alone
    name = (f"_ZN12_GLOBAL__N_123transcode_blocks_kernelILi{mode}E{pix}"
            "EEvPKsPKiNS_6TablesENS_4GeomEPsPhi")
    assert tool.t_instance(name) == entry


def test_issue_ms_is_warp_instructions_over_the_schedulers():
    # 32 blocks of 528 instructions: 528 warp instructions, one on each of
    # 132 x 4 schedulers, is one clock
    assert tool.issue_ms(528, 32, 1000.0) == pytest.approx(1e-6)


def test_attribute_walks_the_inline_chain():
    """An instruction counts under the innermost part on its chain of
    `//##` lines (helpers such as dct.cuh's sra belong to no part, so the
    walk goes on to the line they were inlined at); an instruction with no
    line of its own keeps its predecessor's part."""
    parts = [("IDCT", "dct.cuh", range(41, 62)),
             ("dequant", "transcode.cu", range(117, 136))]
    fn = ("_ZN12_GLOBAL__N_123transcode_blocks_kernelILi0ELb0EEEvPKsPKiNS_"
          "6TablesENS_4GeomEPsPhi")
    text = "\n".join([
        f".text.{fn}:",
        '\t//## File "/x/transcode.cu", line 160',
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        '\t//## File "/x/dct.cuh", line 33 inlined at "/x/transcode.cu", '
        "line 132",
        "        /*0010*/                   IMAD R2, R3, R4, RZ ;",
        "        /*0020*/              @!P0 SHF.R.S32.HI R2, RZ, 0x10, R2 ;",
        '\t//## File "/x/dct.cuh", line 33 inlined at "/x/dct.cuh", line 45',
        '\t//## File "/x/dct.cuh", line 45 inlined at "/x/dct.cuh", line 91',
        '\t//## File "/x/dct.cuh", line 91 inlined at "/x/transcode.cu", '
        "line 207",
        "        /*0030*/                   IADD3 R5, R2, R6, RZ ;",
        "        /*0040*/                   NOP ;",
        ".text.other_kernel:",
        "        /*0000*/                   EXIT ;"])
    assert tool.attribute(text, parts) == {
        "zigzag": {"total": 4, "dequant": 2, "body": 1, "IDCT": 1}}


def test_time_serving_runs_on_the_cpu_at_a_tiny_size():
    """amv_tpu_torch/tools/time_serving.py end to end on the CPU: every
    configuration of the sweep and both transcode_bytes routes give the
    same payloads (the tool asserts it), the idle share is not measured
    there, and the parent's escape (this tree's, loaded as a second
    module) gives the change's bytes."""
    import os

    from amv_tpu_torch.tools import time_serving
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = time_serving.main(["--frames", "64", "--size", "32x32",
                             "--batches", "16", "--depths", "1", "2",
                             "--reps", "1", "--device", "cpu",
                             "--parent", root])
    assert out["card"] == "cpu" and out["frames"] == 64
    assert set(out["sweep"]) == {"16x1", "16x2"}
    assert all(v["idle_share"] is None and v["frames_s"] > 0
               for v in out["sweep"].values())
    assert set(out["transcode_bytes"]) == {"served_16", "whole"}
    assert set(out["staged_escape_s"]) == {
        f"{k}_{s}" for k in ("change", "parent")
        for s in ("escape", "escape_mux")}


def test_time_trellis_runs_on_the_cpu_at_a_tiny_size():
    """amv_tpu_torch/tools/time_trellis.py end to end on the CPU (its
    plain versions, one torch thread): L at both chunk sizes and the chain
    round by round, the MS-ADPCM expand and the WAVE decode, each held
    against its plain version by the tool; no device time or ptxas there."""
    import torch

    from amv_tpu_torch.tools import time_trellis
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = time_trellis.main(["--device", "cpu", "--seconds", "0.25",
                                 "--seconds-44k", "0.09", "--ms-seconds",
                                 "0.05", "--reps", "1"])
    finally:
        torch.set_num_threads(n)
    ms = out["ms"]
    assert out["card"] == "cpu" and out["ptxas"] is None
    assert (ms["L_chunks"], ms["L_chunk_samples"]) == (4, 1378)
    assert (ms["L_44k_chunks"], ms["L_44k_chunk_samples"]) == (2, 3674)
    rounds = ms["chain_rounds"]
    assert rounds[0]["chunks"] == 4 and all(r["launch_ms"] is None
                                            for r in rounds)
    assert ms["L_device_ms"] is None and ms["M_device_ms"] is None
    assert ms["M_lanes"] == 4 and ms["M_samples"] == 2034
    assert ms["wav_ms_msamples_s"] > 0


def test_trellis_variants_apply_to_the_source():
    """amv_tpu_torch/tools/trellis_variants.py's edits of kernel L's source
    all apply (the tool builds each with nvcc on the card): each variant
    differs from the shipped source, and the shipped one is the file."""
    import os

    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools import trellis_variants as tv
    text = open(os.path.join(tk._csrc(_build), tv.SOURCE)).read()
    out = tv.sources(text)
    assert out["shipped"] == text
    assert all(v != text for k, v in out.items() if k != "shipped")


def test_ms_variants_apply_to_the_source():
    """amv_tpu_torch/tools/ms_variants.py's edits of kernel M's source (the
    rows a warp walks, and the diagnostics that leave out a part of a
    tile) all apply: each differs from the shipped source, and the
    shipped one is the file."""
    import os

    from amv_tpu_torch.kernels import _build
    from amv_tpu_torch.tools import ms_variants as mv
    from amv_tpu_torch.tools import time_transcode_kernel as tk
    from amv_tpu_torch.tools import trellis_variants as tv
    text = open(os.path.join(tk._csrc(_build), mv.SOURCE)).read()
    out = tv.sources(text, {**mv.VARIANTS, **mv.DIAGNOSTICS})
    assert out["shipped"] == text and len(out) == 14
    assert all(v != text for k, v in out.items() if k != "shipped")
    assert [mv.rows_a_warp(k) for k in mv.VARIANTS] == [32, 24, 16, 8, 32, 32, 32]
    assert all(mv.rows_a_warp(k) == 32 for k in mv.DIAGNOSTICS)


def test_k_variants_apply_to_the_source():
    """amv_tpu_torch/tools/k_variants.py's edits of kernel K's source each
    apply once to csrc/g729_encode.cu, change it (all but the shipped
    one), and every copy gains the resident-CTA entry."""
    import os

    from amv_tpu_torch.tools import k_variants as kv
    src = open(os.path.join(os.path.dirname(__file__), os.pardir,
                            "amv_tpu_torch", "csrc", kv.SOURCE)).read()
    out = kv.sources(src)
    assert list(out) == list(kv.VARIANTS)
    assert out["shipped"] == src + kv.RESIDENT
    for name, text in out.items():
        assert text.endswith(kv.RESIDENT)
        assert (text == src + kv.RESIDENT) == (name == "shipped"), name
    assert "candidate_score<true>" in out["two grid paths"]
    assert "if (warp == 1) lp_head(S, lane, slot" in out["no head overlap"]


def test_loop_counts_takes_the_uniform_per_sample_loop():
    """time_trellis.loop_counts on a cuobjdump-shaped listing: the
    innermost loop with a shuffle and over 200 instructions (not the outer
    loop around it, nor a fallback loop holding WARPSYNC), split by pipe."""
    from amv_tpu_torch.tools import time_trellis as tool

    def line(addr, op):
        return f"        /*{addr:04x}*/                   {op} ;"

    rows = ["\tFunction : other_kernel", line(0, "EXIT"),
            "\tFunction : _Z14trellis_kernelv", line(0, "MOV R1, R2")]
    addr = 0x10
    for k in range(240):                       # the per-sample loop
        op = ("SHFL.IDX PT, R1, R2, R3, 0x1f" if k == 5 else
              "IMAD R1, R2, R3, R4" if k % 4 == 0 else "LOP3.LUT R1, R2")
        rows.append(line(addr, op))
        addr += 0x10
    rows.append(line(addr, "@!P0 BRA 0x10"))
    addr += 0x10
    rows.append(line(addr, "BRA 0x0"))         # the outer loop
    addr += 0x10
    start = addr
    for k in range(210):                       # a divergent fallback
        rows.append(line(addr, "WARPSYNC.COLLECTIVE R0" if k == 1 else
                         "SHFL.IDX PT, R1, R2, R3, 0x1f"))
        addr += 0x10
    rows.append(line(addr, f"BRA 0x{start:x}"))
    got = tool.loop_counts("\n".join(rows), "trellis_kernel")
    assert got["instructions"] == 241 and got["mio"] == 1
    assert got["imad"] == 60 and got["alu"] == 241 - 60 - 1 - 1
    assert tool.loop_counts("\n".join(rows), "absent") is None


def test_time_g729_runs_on_the_cpu_at_a_tiny_size():
    """amv_tpu_torch/tools/time_g729.py end to end on the CPU (the plain
    versions): G on a batch and on one stream, each held against the plain
    frame step and decode_streams by the tool, K on a batch, and M with
    the WAVE decode; no device time, ptxas, SASS, baseline or phases
    there."""
    import torch

    from amv_tpu_torch.tools import time_g729
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = time_g729.main(["--device", "cpu", "--batch", "2", "--frames",
                              "3", "--long-frames", "4", "--check-frames",
                              "2", "--ms-seconds", "0.05", "--reps", "1",
                              "--k-shapes", "2x3,3x2"])
    finally:
        torch.set_num_threads(n)
    ms = out["ms"]
    assert out["card"] == "cpu" and out["ptxas"] is None
    assert ms["M_lanes"] == 4 and ms["M_device_ms"] is None
    g = ms["G"]
    assert (g["batch"]["streams"], g["batch"]["frames"]) == (2, 3)
    assert (g["long"]["streams"], g["long"]["frames"]) == (1, 4)
    assert g["batch"]["checked_frames"] == 2 and g["long"]["device_ms"] is None
    assert "turns" not in g["batch"]
    k = ms["K"]
    assert (k["2x3"]["streams"], k["2x3"]["frames"],
            k["2x3"]["checked_frames"]) == (2, 3, 2)
    assert (k["3x2"]["streams"], k["3x2"]["frames"]) == (3, 2)
    assert "turns" not in k["2x3"] and "phases" not in k["2x3"]
    assert "K_sass" not in out


def _nvdisasm(body, kernel="_ZN4g729_decode_kernelEv", src="/x/k.cu"):
    """An nvdisasm --print-line-info-inline shaped listing: body holds
    (label or None, source lines (innermost first) or None, instruction)
    rows."""
    rows, addr = [f".text.{kernel}:"], 0
    for label, lns, insn in body:
        if label:
            rows.append(f"{label}:")
        if lns:
            ln = [lns] if isinstance(lns, int) else lns
            rows.append(f'        //## File "{src}", line {ln[0]}' + "".join(
                f' inlined at "{src}", line {x}' for x in ln[1:]))
        rows.append(f"        /*{addr:04x}*/                   {insn} ;")
        addr += 0x10
    return "\n".join(rows)


def test_line_loops_carried_chain():
    """time_g729.line_loops: a backward branch's body, its source lines,
    stores, and the chain from the values it carries in to their new
    values (here s: IMAD, SHF, LEA.HI, VIMNMX; the address add apart)."""
    from amv_tpu_torch.tools import time_g729 as tool
    text = _nvdisasm([
        (None, 10, "MOV R1, c[0x0][0x28]"),
        (".L_x_1", 20, "IMAD R2, R3, R4, R5"),
        (None, 21, "SHF.R.S32.HI R6, RZ, 0x1f, R2"),
        (None, 21, "LEA.HI R2, R6, R2, RZ, 0x8"),
        (None, 22, "VIMNMX R3, R2, 0x7fff, PT"),
        (None, 23, "STS [R7], R3"),
        (None, 23, "IADD3 R7, R7, 0x4, RZ"),
        (None, 24, "ISETP.NE.AND P0, PT, R7, R8, PT"),
        (None, 24, "@P0 BRA `(.L_x_1)"),
        (None, 30, "EXIT")])
    (loop,) = tool.line_loops(text, "g729_decode_kernel", "k.cu")
    assert loop["lines"] == [20, 24] and loop["instructions"] == 8
    assert loop["stores"] == 1 and loop["chain"] == 4
    assert tool.line_loops(text, "other_kernel", "k.cu") == []


def test_g729_floor_counts_the_recurrences(tmp_path):
    """time_g729.g729_floor finds each pipeline stage by its block of
    g729_decode.cu (through the inline chain: a helper of g729_common.cuh
    counts at its call site) and each recurrence by the lines of its
    source, and gives each stage's chain a frame: the parameter block's
    longest chain; the excitation's first synthesis site (the redo left
    out) and a sample's interpolation, twice; the postfilter's
    correlation, synthesis and AGC, twice; the high-pass once.  The
    longest stage binds."""
    from amv_tpu_torch.tools import time_g729 as tool
    dec, com = ["//"] * 60, ["//"] * 20
    for at, text in ((10, "// ---- parameters of frame t"),
                     (20, "// ---- excitation and LP synthesis of frame t"),
                     (30, "// ---- the postfilter of frame t"),
                     (32, "uint32_t acc = 0;"), (33, "acc += (uint32_t)a"),
                     (35, "int gp = gain_coeff;"), (36, "gain_coeff = gp;"),
                     (40, "// ---- the 100 Hz high-pass of frame t"),
                     (41, "const int x = f.pcm[n];"), (43, "hz1 = x;"),
                     (50, "// the state after frame T")):
        dec[at - 1] = text
    for at, text in ((5, "bool synthesis("), (7, "return ovf;"),
                     (12, "int v = 0;"), (14, "exc[base + n] = g729_round(")):
        com[at - 1] = text
    (tmp_path / "g729_decode.cu").write_text("\n".join(dec))
    (tmp_path / "g729_common.cuh").write_text("\n".join(com))
    # the build at 8 CTAs an SM comes first and is not counted
    rows, addr = [".text._Z18g729_decode_kernelILi8EEvPKixxPiPs:",
                  "        /*0000*/   IMAD R2, R2, R9, RZ ;",
                  ".text._Z18g729_decode_kernelILi4EEvPKixxPiPs:"], 0

    def put(n, site, common=None, r=2):
        # n dependent instructions through R<r> at decode line `site`
        nonlocal addr
        for _ in range(n):
            where = (f'File "/x/g729_common.cuh", line {common} inlined at '
                     f'"/x/g729_decode.cu", line {site}' if common else
                     f'File "/x/g729_decode.cu", line {site}')
            rows.append(f"        //## {where}")
            rows.append(f"        /*{addr:04x}*/   IMAD R{r}, R{r}, R9, RZ ;")
            addr += 0x10

    put(30, 11)
    for site, common, n in ((22, 6, 12), (23, 6, 14), (21, 13, 9)):
        put(20, 25, r=20)                      # filler, chain 20 apart
        put(n, site, common)
    put(20, 31, r=20)
    put(10, 33)
    put(20, 31, r=20)
    put(16, 34, 6)
    put(20, 31, r=20)
    put(11, 35)
    put(20, 45, r=20)
    put(20, 42)
    out = tool.g729_floor("\n".join(rows), str(tmp_path))
    st = out["stages"]
    assert st["parameters"]["parts"] == {"block": 30}
    assert st["excitation"]["parts"] == {"synthesis": 24,
                                         "interpolation": 18}
    assert st["postfilter"]["parts"] == {"synthesis": 32, "agc": 22,
                                         "correlation": 20}
    assert st["high-pass"]["parts"] == {"high-pass": 20}
    assert st["postfilter"]["instructions"] == 10 + 16 + 11 + 3 * 20
    assert out["binding"] == "postfilter" and out["instructions"] == 74
    assert out["cycles"] == tool.DEP_CYCLES * 74
