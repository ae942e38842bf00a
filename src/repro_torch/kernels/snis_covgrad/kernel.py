"""The Hopper fused covgrad kernels (`csrc/snis_covgrad_fwd.cu`,
`csrc/snis_covgrad_bwd.cu`), bound with ctypes.

`snis_fwd_cuda` computes what the reference's `snis_covgrad_fwd_pallas`
and `snis_covgrad_fwd_tiled_pallas` compute (sampled scores, and in
covgrad mode the SNIS covariance gradient); `snis_bwd_cuda` what
`snis_covgrad_bwd_pallas` and `snis_covgrad_bwd_tiled_pallas` compute
(the coefficient-weighted gather-reduce), at any L: a register layout
for L a multiple of 4 up to 256 (the forward's lanes a sample from
`fwd_lanes`), a wide path (one warp per row, read in chunks) for every
other L. See the sources for the designs and their
bounds.

The wrappers check device, dtype, shape and contiguity, split S across
blocks (`splits_for`, `fwd_pass`, `bwd_per_sm`), allocate outputs and scratch
with `torch.empty`, launch on PyTorch's current stream without
synchronising, and raise if a launch is refused. The backward is one
launch: the last block of a row adds the row's partials
(`_launch.ticket_counters`). They count their launches in
``snis_fwd_cuda.launches`` and ``snis_bwd_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = [
    "BWD_SOURCE", "FWD_SOURCE", "bwd_library", "bwd_per_sm", "fwd_lanes", "fwd_library",
    "fwd_pass", "snis_bwd_cuda", "snis_bwd_work", "snis_fwd_cuda", "snis_fwd_work",
    "splits_for",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
FWD_SOURCE = _CSRC / "snis_covgrad_fwd.cu"
BWD_SOURCE = _CSRC / "snis_covgrad_bwd.cu"

_ROUND = 32  # samples a round of the 8-lane layouts (the backward, covgrad mode), the wide path
_WARPS, _BATCH, _MAX_WORDS = 8, 2, 8  # the forward's warps a block, samples a group, words a lane


@functools.cache
def fwd_library() -> ctypes.CDLL:
    lib = _build.load(FWD_SOURCE)
    _launch.declare(lib, "snis_fwd_launch", "pppppppp" + "iiiiiii" + "p")
    _launch.declare(lib, "snis_fwd_error_string", "i", ctypes.c_char_p)
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE)
    _launch.declare(lib, "snis_bwd_launch", "pppppp" + "iiiii" + "p")
    _launch.declare(lib, "snis_bwd_capture_id", "p", ctypes.c_ulonglong)
    _launch.declare(lib, "snis_bwd_error_string", "i", ctypes.c_char_p)
    return lib


def splits_for(b: int, s: int, sms: int, per_sm: int = 4,
               multiple: int = _ROUND) -> tuple[int, int]:
    """(splits, chunk): S cut into `splits` chunks of `chunk` samples (a
    multiple of `multiple`: the block's samples a round or a pass), so that
    about `per_sm` blocks per SM gather rows at once even when B alone
    would light few SMs."""
    want = max(1, -(-per_sm * sms // max(1, b)))
    chunk = max(multiple, -(-(-(-s // want)) // multiple) * multiple)
    return -(-s // chunk), chunk


def fwd_lanes(l: int) -> int:
    """Lanes a sample in the forward's register layout in scores mode,
    which takes L a multiple of 4 up to 256 (0: the wide path; covgrad
    mode's register layout gives a sample 8 lanes). Each lane holds
    ceil(L / 4 / lanes) <= 8 of the row's 16-byte words, and a warp
    32 // lanes <= 8 samples; the lanes chosen leave the fewest of the
    warp's load slots idle (5 at L 100: six samples of 25 words in 30
    lanes x 5 words), the fewest among equals (more words in flight a
    lane)."""
    words = l // 4
    if l % 4 or l > 256 or words < 1:
        return 0
    fits = [g for g in range(4, 33) if -(-words // g) <= _MAX_WORDS]
    return max(fits, key=lambda g: ((32 // g) * words / (32 * -(-words // g)), -g))


def fwd_pass(l: int) -> int:
    """Samples a block of the forward's register layout scores in one pass
    in scores mode (every row word of the pass in flight at once): 96 at
    L 100. Covgrad mode and the wide path take rounds of 32."""
    lanes = fwd_lanes(l)
    return _WARPS * (32 // lanes) * _BATCH if lanes else _ROUND


def bwd_per_sm(l: int) -> int:
    """The backward's blocks per SM: two in its register layout (L a
    multiple of 4 up to 256), where every block is resident at once and
    issues all its rows' words before its first add, and fewer, longer
    chunks leave fewer partials for the last block of a row to add (B 32,
    S 1000: 8 chunks of 128); four in the wide path, as the forward."""
    return 2 if l % 4 == 0 and l <= 256 else 4


def snis_fwd_work(b: int, s: int, l: int, p: int, covgrad: bool,
                  rows: float | None = None) -> tuple[int, int, float]:
    """(FLOPs of each product, products, bytes) of one forward call over
    [B, S] slots (S as launched, padded). Each distinct beta row gathered
    is read once (a masked slot scores row 0): ``rows`` of them, by
    default the most there can be, min(B S, P). Scores mode reads the
    actions and h and writes the scores; covgrad mode also reads log q
    and the rewards and writes the gradient. Each product takes 2 B S L
    FLOPs: the scores, and in covgrad mode the two weighted row sums of
    the online softmax."""
    rows = min(b * s, p) if rows is None else rows
    io = b * s * 16 + b * l * 8 if covgrad else b * s * 8 + b * l * 4
    return 2 * b * s * l, 3 if covgrad else 1, rows * l * 4 + io


def snis_bwd_work(b: int, s: int, l: int, p: int,
                  rows: float | None = None) -> tuple[int, int, float]:
    """(FLOPs of the product, 1, bytes) of one backward call over [B, S]
    slots: each distinct live beta row read once (a masked slot reads
    none; ``rows``, by default min(B S, P)), the coefficients and actions
    read, grad_h written; 2 B S L FLOPs."""
    rows = min(b * s, p) if rows is None else rows
    return 2 * b * s * l, 1, rows * l * 4 + b * s * 8 + b * l * 4


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
    if b < 1 or s < 1 or l < 1 or b > 65535:
        raise ValueError(f"need 1 <= B <= 65535, S >= 1 and L >= 1 (got {b}, {s}, {l})")
    lib = fwd_library()
    h, beta = _launch.aligned16(h), _launch.aligned16(beta)
    step = _ROUND if covgrad else fwd_pass(l)
    splits, chunk = splits_for(b, s, _launch.sm_count(dev.index or 0), multiple=step)
    scores = torch.empty((b, s), dtype=torch.float32, device=dev)
    part = grad = None
    if covgrad:
        part = torch.empty((b, splits, 3 + 2 * l), dtype=torch.float32, device=dev)
        grad = torch.empty((b, l), dtype=torch.float32, device=dev)
    err = lib.snis_fwd_launch(
        h.data_ptr(), beta.data_ptr(), actions.data_ptr(), log_q.data_ptr(),
        rewards.data_ptr(), scores.data_ptr(),
        part.data_ptr() if covgrad else None, grad.data_ptr() if covgrad else None,
        b, s, l, splits, chunk, fwd_lanes(l), int(covgrad), _launch.stream(dev),
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
    if b < 1 or s < 1 or l < 1 or b > 65535:
        raise ValueError(f"need 1 <= B <= 65535, S >= 1 and L >= 1 (got {b}, {s}, {l})")
    lib = bwd_library()
    beta = _launch.aligned16(beta)
    splits, chunk = splits_for(b, s, _launch.sm_count(dev.index or 0), bwd_per_sm(l))
    stream = _launch.stream(dev)
    counters = _launch.ticket_counters(dev, stream, b, lib.snis_bwd_capture_id(stream))
    part = torch.empty((b, splits, l), dtype=torch.float32, device=dev)
    grad = torch.empty((b, l), dtype=torch.float32, device=dev)
    err = lib.snis_bwd_launch(
        coeff.data_ptr(), actions.data_ptr(), beta.data_ptr(), part.data_ptr(),
        grad.data_ptr(), counters.data_ptr(), b, s, l, splits, chunk, stream,
    )
    _launch.raise_on_error(err, lib, "snis_bwd_error_string", "snis_covgrad_bwd")
    snis_bwd_cuda.launches += 1
    return grad


snis_fwd_cuda.launches = 0
snis_bwd_cuda.launches = 0
