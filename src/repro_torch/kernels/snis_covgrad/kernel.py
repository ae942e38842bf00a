"""The Hopper fused covgrad kernels (`csrc/snis_covgrad_fwd.cu`,
`csrc/snis_covgrad_bwd.cu`), bound with ctypes.

`snis_fwd_cuda` computes what the reference's `snis_covgrad_fwd_pallas`
and `snis_covgrad_fwd_tiled_pallas` compute (sampled scores, and in
covgrad mode the SNIS covariance gradient); `snis_bwd_cuda` what
`snis_covgrad_bwd_pallas` and `snis_covgrad_bwd_tiled_pallas` compute
(the coefficient-weighted gather-reduce). See the sources for the
designs and their bounds.

The wrappers check device, dtype, shape and contiguity, split S across
blocks (`splits_for`), allocate outputs and scratch with `torch.empty`,
launch on PyTorch's current stream without synchronising, and raise if
a launch is refused. They count their launches in
``snis_fwd_cuda.launches`` and ``snis_bwd_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = [
    "BWD_SOURCE", "FWD_SOURCE", "bwd_library", "fwd_library", "snis_bwd_cuda",
    "snis_fwd_cuda", "splits_for",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
FWD_SOURCE = _CSRC / "snis_covgrad_fwd.cu"
BWD_SOURCE = _CSRC / "snis_covgrad_bwd.cu"

_GROUPS = 32  # samples in flight per block (256 threads, 8 lanes each)


@functools.cache
def fwd_library() -> ctypes.CDLL:
    lib = _build.load(FWD_SOURCE)
    _launch.declare(lib, "snis_fwd_launch", "pppppppp" + "iiiiii" + "p")
    _launch.declare(lib, "snis_fwd_max_dim", "")
    _launch.declare(lib, "snis_fwd_error_string", "i", ctypes.c_char_p)
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    _launch.declare(lib, "snis_bwd_launch", "ppppp" + "iiiii" + "p")
    _launch.declare(lib, "snis_bwd_max_dim", "")
    _launch.declare(lib, "snis_bwd_error_string", "i", ctypes.c_char_p)
    return lib


def splits_for(b: int, s: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): S cut into `splits` chunks of `chunk` samples (a
    multiple of the block's 32 groups), so that about four blocks per SM
    gather rows at once even when B alone would light few SMs."""
    want = max(1, -(-4 * sms // max(1, b)))
    chunk = max(_GROUPS, -(-(-(-s // want)) // _GROUPS) * _GROUPS)
    return -(-s // chunk), chunk


def _check_dim(l: int, max_dim: int) -> None:
    if l % 4 or not 4 <= l <= max_dim:
        raise ValueError(
            f"the covgrad kernels take L a multiple of 4 in [4, {max_dim}], got {l}"
        )


def _check_rows(name, t, b, s, dtype, dev):
    _launch.check(name, t, dtype, 2, dev)
    if t.shape != (b, s):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, s)}")


def snis_fwd_cuda(
    h: torch.Tensor,  # [B, L] float32
    beta: torch.Tensor,  # [P, L] float32
    actions: torch.Tensor,  # [B, S] int32, -1 marks masked slots
    log_q: torch.Tensor,  # [B, S] float32
    rewards: torch.Tensor,  # [B, S] float32
    *,
    covgrad: bool,
):
    """scores [B, S] (covgrad=False), or (scores [B, S], grad [B, L])."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"snis_fwd_cuda takes CUDA tensors, got {dev}")
    _launch.check("h", h, torch.float32, 2, dev)
    _launch.check("beta", beta, torch.float32, 2, dev)
    b, l = h.shape
    s = actions.shape[1] if actions.dim() == 2 else -1
    _check_rows("actions", actions, b, s, torch.int32, dev)
    _check_rows("log_q", log_q, b, s, torch.float32, dev)
    _check_rows("rewards", rewards, b, s, torch.float32, dev)
    if beta.shape[1] != l:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, beta {tuple(beta.shape)}")
    if b < 1 or s < 1 or b > 65535:
        raise ValueError(f"need 1 <= B <= 65535 and S >= 1 (got {b}, {s})")
    lib = fwd_library()
    _check_dim(l, lib.snis_fwd_max_dim())
    h, beta = _launch.aligned16(h), _launch.aligned16(beta)
    splits, chunk = splits_for(b, s, _launch.sm_count(dev.index or 0))
    scores = torch.empty((b, s), dtype=torch.float32, device=dev)
    part = grad = None
    if covgrad:
        part = torch.empty((b, splits, 3 + 2 * l), dtype=torch.float32, device=dev)
        grad = torch.empty((b, l), dtype=torch.float32, device=dev)
    err = lib.snis_fwd_launch(
        h.data_ptr(), beta.data_ptr(), actions.data_ptr(), log_q.data_ptr(),
        rewards.data_ptr(), scores.data_ptr(),
        part.data_ptr() if covgrad else None, grad.data_ptr() if covgrad else None,
        b, s, l, splits, chunk, int(covgrad), _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "snis_fwd_error_string", "snis_covgrad_fwd")
    snis_fwd_cuda.launches += 1
    return (scores, grad) if covgrad else scores


def snis_bwd_cuda(
    coeff: torch.Tensor,  # [B, S] float32 dL/df
    actions: torch.Tensor,  # [B, S] int32, -1 marks masked slots
    beta: torch.Tensor,  # [P, L] float32
) -> torch.Tensor:
    """grad_h [B, L] = sum_s select(a >= 0, coeff, 0) * beta[a]."""
    dev = coeff.device
    if dev.type != "cuda":
        raise ValueError(f"snis_bwd_cuda takes CUDA tensors, got {dev}")
    _launch.check("beta", beta, torch.float32, 2, dev)
    b, s = coeff.shape if coeff.dim() == 2 else (-1, -1)
    _check_rows("coeff", coeff, b, s, torch.float32, dev)
    _check_rows("actions", actions, b, s, torch.int32, dev)
    l = beta.shape[1]
    if b < 1 or s < 1 or b > 65535:
        raise ValueError(f"need 1 <= B <= 65535 and S >= 1 (got {b}, {s})")
    lib = bwd_library()
    _check_dim(l, lib.snis_bwd_max_dim())
    beta = _launch.aligned16(beta)
    splits, chunk = splits_for(b, s, _launch.sm_count(dev.index or 0))
    part = torch.empty((b, splits, l), dtype=torch.float32, device=dev)
    grad = torch.empty((b, l), dtype=torch.float32, device=dev)
    err = lib.snis_bwd_launch(
        coeff.data_ptr(), actions.data_ptr(), beta.data_ptr(), part.data_ptr(),
        grad.data_ptr(), b, s, l, splits, chunk, _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "snis_bwd_error_string", "snis_covgrad_bwd")
    snis_bwd_cuda.launches += 1
    return grad


snis_fwd_cuda.launches = 0
snis_bwd_cuda.launches = 0
