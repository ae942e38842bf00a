"""repro_torch — the PyTorch and CUDA port of `repro`, for an NVIDIA H100.

It mirrors the layout and names of the JAX package `repro`, which stays
the reference, and imports none of it: only the parity tests import
both. Each TPU kernel on a ported path is a kernel written by hand for
Hopper, beside a plain PyTorch version of the same function.

Ported so far: the SASRec retrieval serving path (`repro_torch.launch
.serve`), through the `ivf_topk` CUDA kernel.
"""

__version__ = "0.1.0"
