"""PyTorch / CUDA port of asr_model_tpu for NVIDIA Hopper (H100).

The JAX package ``asr_model_tpu`` is the numerics reference; this
package computes the same functions with PyTorch and hand-written
``sm_90a`` CUDA kernels (``csrc/``) where the JAX package used Pallas
kernels (``ops/cuda/``).  It imports nothing of JAX or of the JAX
package.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); functions that take tensors follow the tensor's
device.  On a CUDA tensor every kernel wrapper launches its kernel or
raises; a CPU tensor takes the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
