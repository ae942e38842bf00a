"""What every kernel wrapper does around a launch: check its tensors,
find the stream and the card's SM count, and turn a nonzero CUDA error
code into an exception (a refused launch never runs, and a later
`torch.cuda.synchronize` would not report it)."""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "C_SIGNATURES", "aligned16", "check", "declare", "raise_on_error",
    "sm_count", "stream",
]

# argtypes shorthands: a pointer or the stream, an int
C_SIGNATURES = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def declare(lib: ctypes.CDLL, name: str, args: str, restype=ctypes.c_int) -> None:
    """Declare ``lib.name``'s C signature; ``args`` spells one argument
    per letter of `C_SIGNATURES` ("ppi" = two pointers and an int)."""
    fn = getattr(lib, name)
    fn.argtypes = [C_SIGNATURES[c] for c in args]
    fn.restype = restype


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start on a 16-byte boundary
    (the kernels read rows as 16-byte words)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def raise_on_error(err: int, lib: ctypes.CDLL, error_string: str, kernel: str) -> None:
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
