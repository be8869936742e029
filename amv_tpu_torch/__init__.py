"""amv_tpu_torch: the AMV codec framework on PyTorch and CUDA.

The port of `amv_tpu` (JAX/Pallas on a TPU) to PyTorch with kernels
written by hand in CUDA C++ for Hopper (sm_90a).  It keeps the JAX
package's contracts and bytes; `amv_tpu` stays the reference it is
tested against.  This package imports `torch` and never `jax`.

Ported so far: the complete AMV->AMV transcode
(`pipeline.transcode.transcode_bytes`), the AMV decode to YUV420 frames
and PCM (`pipeline.decode.decode_bytes`), the AMV encode from them
(`pipeline.encode.encode_to_bytes`) with its ingest (raw-video and
baseline MJPEG AVI, `-s` rescaling, `-ar` resampling, every WAVE format)
and the `-trellis` quantizer, the baseline MJPEG encode
(`codecs.mjpeg`), and their CLI routes (`python -m amv_tpu_torch`).  The port keeps its own copies of the host
layer it needs (containers, tables, the C byte passes and oracles) and
imports nothing of `amv_tpu`.
"""

__version__ = "0.1.0"
