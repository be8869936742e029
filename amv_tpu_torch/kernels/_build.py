"""Build and load the port's CUDA kernels (amv_tpu_torch/csrc/*.cu).

At first use, nvcc compiles every source into one shared library with a
plain C interface under build/amv_tpu_torch/ at the repository root, and
ctypes loads it: one nvcc per source, all started together, then one
link.  Every pointer and the stream cross as c_void_p.  The
library is rebuilt when a source is newer than it; a failed build raises.
Each C entry returns the cudaGetLastError() of its launch, and `check`
raises on anything but 0.

Every wrapper reaches its C entries inside `on_device(*tensors)`, the one
launch guard: it makes the tensors' card the current device and hands
over that card's current stream, so a kernel runs where its tensors lie
(and its entry sizes its grid for that card) whichever device the caller
had current.  tests/test_torch_sharding.py walks the port's sources and
fails on a C entry called outside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

from ..utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "amv_tpu_torch")
_SO = os.path.join(BUILD_DIR, "libamv_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# C entry -> argtypes (csrc/*.cu, extern "C")
_SIGNATURES = {
    "amv_transcode_blocks": [_P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    "amv_decode_scans": [_P, _I64, _P, _P, _I32, _I32, _P, _P, _P, _P, _P,
                         _P],
    "amv_decode_records": [_P, _I64, _P, _P, _I32, _I32, _P, _I64, _P, _P,
                           _P, _P],
    "amv_expand_records": [_P, _I64, _P, _I32, _I32, _P, _P],
    "amv_pack_records": [_P, _I64, _P, _I32, _I32, _P, _P, _P],
    "amv_encode_levels": [_P, _I32, _I32, _P, _I32, _P, _P, _P, _P],
    "amv_count_bits": [_P, _I32, _I32, _P, _P, _P],
    "amv_idct_blocks": [_P, _P, _P, _P, _I64, _P],
    "amv_fdct_quant": [_P, _P, _P, _I64, _I32, _P],
    "amv_decode_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _P],
    "amv_encode_fused": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P],
    "amv_adpcm_decode": [_P, _I64, _P, _P, _I64, _I64, _P, _P],
    "amv_adpcm_encode": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P],
    "amv_adpcm_encode_scratch": [_I64, _I64, _I64],
    "amv_trellis": [_P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "amv_trellis_scratch": [_I64, _I64],
    "amv_ms_expand": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P],
    "amv_g729_decode": [_P, _I64, _I64, _P, _P, _P],
    "amv_g729_state_words": [],
    "amv_g729_encode": [_P, _I64, _I64, _P, _P, _P, _P],
    "amv_yuv2rgb_packed": [_P, _P, _P, _P, _P, _P, _P],
    "amv_amvlib_idct": [_P, _P, _P, _P, _P, _P, _I32, _P],
}
# a source's flags beyond NVCC_FLAGS: kernel K's float sums must round as
# its plain version's separate torch multiplies and adds do
SOURCE_FLAGS = {"g729_encode.cu": ["-fmad=false"]}

# entries that return something other than an int status
_RESTYPES = {"amv_adpcm_encode_scratch": _I64, "amv_trellis_scratch": _I64,
             "amv_g729_state_words": _I64}

_lib = None
_lib_lock = threading.Lock()    # one thread builds and loads the library


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile csrc/*.cu into the shared library if it is missing or
    older than a source or header; return its path.  Raises on a failed
    build."""
    srcs = sorted(glob.glob(os.path.join(_SRC, "*.cu")))
    deps = srcs + glob.glob(os.path.join(_SRC, "*.cuh"))
    if os.path.exists(_SO) and all(
            os.path.getmtime(s) <= os.path.getmtime(_SO) for s in deps):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    try:
        _run([[nvcc, *NVCC_FLAGS,
               *SOURCE_FLAGS.get(os.path.basename(s), []), "-c", "-o", o, s]
              for s, o in zip(srcs, objs)])
        tmp = f"{_SO}.{tag}"
        _run([[nvcc, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, _SO)
    return _SO


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, by one thread)."""
    global _lib
    if _lib is None:
        with _lib_lock, span("kernels.build"):
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _RESTYPES.get(name, ctypes.c_int)
                _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """A kernel runs on CUDA tensors only, all on one device: that device
    (with its index)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    return next(iter(devs))


@contextlib.contextmanager
def on_device(*tensors: torch.Tensor):
    """The launch guard: with the tensors' CUDA device current (they must
    all lie on one), yield (the loaded library, that device's current
    stream as a raw handle for the launch)."""
    dev = require_cuda(*tensors)
    lib = library()
    with torch.cuda.device(dev):
        yield lib, torch.cuda.current_stream(dev).cuda_stream


def on_stream(dev: torch.device, stream) -> contextlib.ExitStack:
    """dev as the current device (a card) and stream (one of dev's, or
    None on the CPU) as its current stream: where a shard's work is
    issued before its wrappers' launches go through `on_device`."""
    ctx = contextlib.ExitStack()
    if dev.type == "cuda":
        ctx.enter_context(torch.cuda.device(dev))
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def device_key(device) -> torch.device:
    """A device as a cache key: "cuda" names the current card, so it
    becomes "cuda:<current index>"; every other device is itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
