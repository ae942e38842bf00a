"""Shared neural layers: plain functions over parameter trees of tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm that scales by ``1 + scale`` (a zero scale is the identity
    gain), computed in fp32."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, Dh]; positions: [..., S]. The
    angles, and the rotation, are fp32; the result is cast back to x's
    dtype at the end, in the reference's order."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down, act: str = "silu") -> torch.Tensor:
    """(act(x w_gate) * x w_up) w_down. "gelu" is the tanh approximation,
    `jax.nn.gelu`'s default (`F.gelu`'s default is the exact erf form)."""
    g = x @ w_gate
    u = x @ w_up
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ w_down


def dense_init(d_in: int, d_out: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn((d_in, d_out), generator=generator, device=device) / d_in**0.5


def mlp_init(
    dims: tuple[int, ...], generator: torch.Generator, device
) -> list[dict[str, torch.Tensor]]:
    return [
        {
            "w": dense_init(di, do, generator, device),
            "b": torch.zeros((do,), device=device),
        }
        for di, do in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(params: list[dict], x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i + 1 < len(params):
            h = act(h)
    return h
