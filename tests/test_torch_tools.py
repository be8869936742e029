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
