"""amv_tpu_torch: the AMV codec framework on PyTorch and CUDA.

The port of `amv_tpu` (JAX/Pallas on a TPU) to PyTorch with kernels
written by hand in CUDA C++ for Hopper (sm_90a).  It keeps the JAX
package's contracts and bytes; `amv_tpu` stays the reference it is
tested against.  This package imports `torch` and never `jax`.

Ported so far: the complete AMV->AMV transcode
(`pipeline.transcode.transcode_bytes`, `python -m amv_tpu_torch`).
"""

__version__ = "0.1.0"
