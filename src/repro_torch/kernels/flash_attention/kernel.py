"""The Hopper flash-attention kernels, forward
(`csrc/flash_attention_fwd.cu`) and backward (`csrc/flash_attention_bwd.cu`),
bound with ctypes.

`flash_attention_fwd_cuda` computes what the reference's
`flash_attention_pallas` computes (the causal / sliding-window /
soft-capped attention and the per-row logsumexp), and
`flash_attention_bwd_cuda` what its `flash_backward_pallas` computes (dq,
dk and dv from the saved logsumexp and D = rowsum(dO * O)), over the
model's [B, S, heads, D] layout directly and with grouped KV heads read
in place. See the sources for the designs and their bounds.

The wrappers check device, dtype, shape, contiguity and alignment,
allocate the outputs with `torch.empty`, launch on PyTorch's current
stream without synchronising, and raise if a launch is refused. Each
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, _launch

__all__ = [
    "BWD_SOURCE", "HEAD_DIMS", "SOURCE", "bwd_library", "flash_attention_bwd_cuda",
    "flash_attention_fwd_cuda", "library",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the sources instantiate
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel's library, with its C
    signatures declared."""
    lib = _build.load(SOURCE)
    _launch.declare(lib, "flash_fwd_launch", "ppppp" + "i" * 10 + "ff" + "i" + "p")
    _launch.declare(lib, "flash_fwd_smem_bytes", "i", ctypes.c_size_t)
    _launch.declare(lib, "flash_fwd_error_string", "i", ctypes.c_char_p)
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    """Build (first use) and load the backward's library."""
    lib = _build.load(BWD_SOURCE)
    _launch.declare(lib, "flash_bwd_launch", "p" * 9 + "i" * 10 + "ff" + "i" + "p")
    _launch.declare(lib, "flash_bwd_error_string", "i", ctypes.c_char_p)
    return lib


def _check_attention(q, k, v, seq_kv, window) -> tuple[int, ...]:
    """The checks both kernels share; returns (B, Sq, H, D, Skv, KV, seq_kv)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash-attention kernels take CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernels take float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _launch.check(name, t, q.dtype, 4, dev)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} has no kernel (widths: {HEAD_DIMS})")
    seq_kv = skv if seq_kv is None else seq_kv
    if not 1 <= seq_kv <= skv or sq < 1:
        raise ValueError(f"need 1 <= seq_kv <= Skv and Sq >= 1 (got {seq_kv}, {skv}, {sq})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None (got {window})")
    if h > 65535 or b > 65535:
        raise ValueError(f"B {b} and H {h} must each fit the grid's 65535")
    return b, sq, h, d, skv, kvh, seq_kv


def flash_attention_fwd_cuda(
    q: torch.Tensor,  # [B, Sq, H, D] float32 or bfloat16
    k: torch.Tensor,  # [B, Skv, KV, D], H % KV == 0
    v: torch.Tensor,  # [B, Skv, KV, D]
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] float32) on the
    card. Keys at positions >= ``seq_kv`` (default Skv) are masked."""
    b, sq, h, d, skv, kvh, seq_kv = _check_attention(q, k, v, seq_kv, window)
    dev = q.device
    q, k, v = (_launch.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = library()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPES[q.dtype], b, h, kvh, sq, skv, d, seq_kv, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap),
        1.0 / float(d) ** 0.5, int(q_offset), _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "flash_fwd_error_string", "flash_attention_fwd")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # [B, Sq, H, D] float32 or bfloat16
    k: torch.Tensor,  # [B, Skv, KV, D], H % KV == 0
    v: torch.Tensor,  # [B, Skv, KV, D]
    do: torch.Tensor,  # [B, Sq, H, D], the output's cotangent
    lse: torch.Tensor,  # [B, H, Sq] float32, from the forward
    dsum: torch.Tensor,  # [B, H, Sq] float32, rowsum(dO * O)
    *,
    seq_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq [B, Sq, H, D], dk, dv [B, Skv, KV, D]) in the inputs' dtype, on
    the card: the dq and the dk/dv kernels, one launch of the pair. The
    GQA group sum of dk and dv is taken in fp32 inside the kernel."""
    b, sq, h, d, skv, kvh, seq_kv = _check_attention(q, k, v, seq_kv, window)
    dev = q.device
    _launch.check("do", do, q.dtype, 4, dev)
    if do.shape != q.shape:
        raise ValueError(f"do has shape {tuple(do.shape)}, expected {tuple(q.shape)}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        _launch.check(name, t, torch.float32, 3, dev)
        if t.shape != (b, h, sq):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, h, sq)}")
    q, k, v, do = (_launch.aligned16(t) for t in (q, k, v, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = bwd_library()
    err = lib.flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPES[q.dtype], b, h, kvh, sq, skv, d, seq_kv, int(bool(causal)),
        0 if window is None else int(window),
        0.0 if logit_cap is None else float(logit_cap),
        1.0 / float(d) ** 0.5, int(q_offset), _launch.stream(dev),
    )
    _launch.raise_on_error(err, lib, "flash_bwd_error_string", "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
