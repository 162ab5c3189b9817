"""PyTorch/CUDA port of the package-query engine (``repro``).

Same module layout as the JAX package: ``core/`` holds the pipeline
(DLV build, Progressive Shading, Dual Reducer, branch & bound), and
``kernels/`` holds the hand-written Hopper kernels (CUDA C++ sources in
``csrc/``) with a plain-torch version of each for CPU tensors.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
requested but absent; the CPU runs only when the caller asks for it.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
