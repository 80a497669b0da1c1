"""Seeded weights, made by the benchmark on the device and handed alike to the
program and to the reference.

Every leaf of two or more dimensions (a convolution or dense kernel) is
LeCun-normal, truncated at ±2σ and scaled by 1/√fan_in corrected for the
truncation; one-dimensional leaves named ``weight`` (GroupNorm scales) are 1
and every bias is 0. The kernels of all leaves come from one draw of uniforms
on the device, turned into truncated normals by the inverse CDF, in the order
of the reference's ``named_parameters``.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978     # std of a standard normal truncated at ±2


def stream(seed: int, purpose: int) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + purpose * 0xBF58476D1CE4E5B9) % (1 << 63)


def make(shapes: dict[str, tuple], seed: int, device, purpose: int = 1) -> dict[str, torch.Tensor]:
    """name → f32 tensor on ``device`` for each (name, shape) of ``shapes``."""
    kernels = [(k, s) for k, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(stream(seed, purpose))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)).float()
    out, at = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[name] = z[at:at + n].view(shape) * (fan_in ** -0.5 / _TRUNC_STD)
        at += n
    for name, shape in shapes.items():
        if len(shape) < 2:
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple]:
    return {k: tuple(p.shape) for k, p in module.named_parameters()}


def load(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters; the names must match exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise KeyError(f"weights do not match the module: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])
