"""Shared neural layers: plain functions over parameter trees of tensors."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm that scales by ``1 + scale`` (a zero scale is the identity
    gain), computed in fp32."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


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
