"""The port's CUDA kernel sources run on the CPU, against their plain torch
versions.

Each source (amv_tpu_torch/csrc/*.cu) is compiled with g++ against the
stand-in runtime of tests/cuda_emu/cuda_runtime.h, which runs every CTA's
threads as std::threads with barriers for __syncthreads/__syncwarp and a
shared buffer for the warp shuffles; its launches `k<<<g, b, s, st>>>(...)`
are rewritten into that header's launch helper.  The library is loaded
with ctypes under the C signatures of `kernels._build`, and the kernel's
output is held bit-exact against its plain version at small sizes.  This
checks a kernel's logic (indices, tiles, scans, barriers) where there is no
card; what nvcc makes of it is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Skipped where g++ is absent.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from amv_tpu_torch.codecs.amv_video import encoder_qmat
from amv_tpu_torch.kernels import _build
from amv_tpu_torch.kernels import adpcm as AQ
from amv_tpu_torch.kernels import fdct as F
from amv_tpu_torch.kernels import transcode as T

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "amv_tpu_torch", "csrc")
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def emulated(source: str, out_dir) -> ctypes.CDLL:
    """csrc/<source> built with g++ against tests/cuda_emu, loaded."""
    text = open(os.path.join(CSRC, source)).read()
    text = _LAUNCH.sub(lambda m: f"amv_emu::launch({m.group(1)}, "
                                 f"{m.group(2)}, ", text)
    cpp = os.path.join(out_dir, source + ".cpp")
    so = os.path.join(out_dir, source + ".so")
    with open(cpp, "w") as f:
        f.write(text)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-w", "-I", os.path.join(HERE, "cuda_emu"),
                    "-I", CSRC, "-o", so, cpp], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def adpcm_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("adpcm_decode.cu", str(tmp_path_factory.mktemp("emu")))


def _decode(lib, pay, pred, sidx, repeat, skip=0):
    """Kernel A's C entry on numpy arrays; the payload starts `skip` bytes
    into its buffer (an offset view)."""
    c, nb = pay.shape
    buf = np.zeros(c * nb + skip + 16, np.uint8)
    base = (-buf.ctypes.data) % 16 + skip
    buf[base:base + c * nb] = pay.reshape(-1)
    out = np.zeros((c * repeat, 2 * nb), np.int16)
    rc = lib.amv_adpcm_decode(buf.ctypes.data + base, nb, pred.ctypes.data,
                              sidx.ctypes.data, c, c * repeat,
                              out.ctypes.data, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("nbytes,fill,repeat,skip", [
    (1, None, 1, 0), (16, None, 1, 3), (31, None, 3, 1), (32, None, 1, 0),
    (33, None, 1, 7), (689, None, 1, 5), (689, 0x77, 1, 0),
    (689, 0xFF, 1, 0), (689, 0x88, 2, 0), (2100, None, 1, 9)])
def test_adpcm_decode_source_matches_plain(adpcm_lib, nbytes, fill, repeat,
                                           skip):
    """Kernel A's warp scans on the CPU: runs shorter than a lane, a tile
    of 689 bytes, two tiles and a part (2,100 bytes), the clamp rails, the
    wrap, and payloads that start off a 16-byte boundary."""
    rng = np.random.default_rng(nbytes + repeat)
    c = 6
    pay = rng.integers(0, 256, (c, nbytes)).astype(np.uint8)
    if fill is not None:
        pay[:] = fill
    pred = np.array([0, 32767, -32768, 1000, 70000, -2 ** 31], np.int32)
    sidx = np.array([0, 88, 200, -5, 40, 88], np.int32)
    if fill == 0x77:
        pred[:] = 32767
    got = _decode(adpcm_lib, pay, pred, sidx, repeat, skip)
    want = AQ.decode_chunks_plain(*(torch.from_numpy(a) for a in
                                    (pay, pred, sidx)), repeat=repeat)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.fixture(scope="module")
def transcode_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("transcode.cu", str(tmp_path_factory.mktemp("emu")))


def _transcode(lib, lv, dc, qmat, geom, mode, with_pix, repeat=1):
    """Kernel T's C entry on numpy arrays -> (levels, pixels or None)."""
    n = lv.shape[0] * repeat
    tables, geo = T.kernel_args(qmat, geom, n, lv.shape[0])
    out = np.zeros((n, 64), np.int16)
    pix = np.zeros((n, 64), np.uint8) if with_pix else None
    rc = lib.amv_transcode_blocks(
        lv.ctypes.data, None if dc is None else dc.ctypes.data,
        tables.ctypes.data, geo, out.ctypes.data,
        None if pix is None else pix.ctypes.data, n, mode, None)
    assert rc == 0
    return out, pix


@pytest.mark.parametrize("case", ["160x120", "168x120", "320x240", "none",
                                  "deq", "wrap"])
def test_transcode_source_matches_plain(transcode_lib, case):
    """Kernel T's shared-memory tiles on the CPU: a last CTA that is half
    full (3 frames of 160x120 are 7.5 CTAs), pad rows and columns, whole
    MCUs, no edge replication, the dequantized entry on a block count that
    is not whole MCUs, and the wrap, each entry against its plain version."""
    rng = np.random.default_rng(len(case))
    q = encoder_qmat(1 if case in ("none", "deq") else 2)
    sizes = {"160x120": (160, 120), "168x120": (168, 120),
             "320x240": (320, 240), "none": None}
    if case == "deq":
        deq = rng.integers(-2048, 2048, (1001, 64)).astype(np.int16)
        got_lv, got_px = _transcode(transcode_lib, deq, None, q,
                                    (1, 1, 16, 16), 2, True)
        want_px, want_lv = T.transcode_deq_plain(torch.from_numpy(deq), q)
    elif case == "wrap":
        n_base, repeat = 8 * 96, 16
        lv = _levels(rng, n_base)
        dc = rng.integers(-4000, 4000, n_base * repeat).astype(np.int32)
        got_lv, got_px = _transcode(transcode_lib, lv, dc, q,
                                    (1, 1, 16, 16), 1, True, repeat)
        want_lv, want_px = T.transcode_blocks_plain(
            torch.from_numpy(lv)[T.wrap_index(n_base, repeat)],
            torch.from_numpy(dc), q)
    else:
        size = sizes[case]
        n = 3 * (80 if size is None else
                 ((size[0] + 15) // 16) * ((size[1] + 15) // 16)) * 6
        lv = _levels(rng, n)
        dc = rng.integers(-40000, 40000, n).astype(np.int32)
        geom = T._geometry(size, n)
        got_lv, got_px = _transcode(transcode_lib, lv, dc, q, geom, 0, True)
        got_lv2, _ = _transcode(transcode_lib, lv, dc, q, geom, 0, False)
        np.testing.assert_array_equal(got_lv2, got_lv)
        want_lv, want_px = T.transcode_blocks_plain(
            torch.from_numpy(lv), torch.from_numpy(dc), q, geom)
    np.testing.assert_array_equal(got_lv, want_lv.numpy())
    np.testing.assert_array_equal(got_px, want_px.numpy())


def _levels(rng, n_blocks, dense=0.15):
    lv = np.where(rng.random((n_blocks, 64)) < dense,
                  rng.integers(-1023, 1024, (n_blocks, 64)), 0)
    lv[rng.random(n_blocks) < 0.05] = 1023
    return lv.astype(np.int16)


@pytest.fixture(scope="module")
def fdct_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    return emulated("fdct.cu", str(tmp_path_factory.mktemp("emu")))


@pytest.mark.parametrize("qscale,zigzag", [(1, True), (2, False), (31, True)])
def test_fdct_source_matches_plain(fdct_lib, qscale, zigzag):
    """Kernel F, the FDCT and the quantizer of dct.cuh that kernels T and V
    share, on the CPU: random pixels and the extremes (flat 0 and 255, and
    a checkerboard of both, whose products wrap at qscale 1), a block
    count that is not a whole CTA, raster and zigzag out."""
    rng = np.random.default_rng(qscale)
    pix = rng.integers(0, 256, (400, 64)).astype(np.uint8)
    pix[0], pix[1] = 0, 255
    pix[2] = np.where(np.add.outer(np.arange(8), np.arange(8)) % 2, 255,
                      0).reshape(64)
    q = encoder_qmat(qscale)
    out = np.zeros((400, 64), np.int16)
    rc = fdct_lib.amv_fdct_quant(pix.ctypes.data,
                                 np.ascontiguousarray(q, np.int32).ctypes.data,
                                 out.ctypes.data, 400, int(zigzag), None)
    assert rc == 0
    want = F.fdct_quantize_plain(torch.from_numpy(pix), q)
    if zigzag:
        want = want[:, torch.as_tensor(F.ZIGZAG).long()]
    np.testing.assert_array_equal(out, want.numpy())
