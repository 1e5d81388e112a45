"""Counter-based RNG: Threefry-2x32 (20 rounds), uniforms, Box-Muller.

The plain PyTorch twin of the generator the CUDA kernel
(``csrc/mc_paths.cu``) computes in registers, and bit-for-bit the
reference's ``repro.kernels.prng``: the draw for (path p, step s) is a pure
function of (seed, task_id, p, s), so any split of paths across blocks or
devices draws the same numbers.

PyTorch has no uint32 ``+``, ``<<`` or ``>>`` on the CPU, so words are held
in int64 tensors with values in [0, 2**32) and every sum or shift is masked
back to 32 bits. Inputs are int64 tensors (or Python ints) holding uint32
values; outputs are int64 tensors of the same kind.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "uniforms", "normal_pair", "TWO_PI"]

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF

#: 2π as the reference writes it: float32(2.0 * 3.14159265358979).
TWO_PI = 2.0 * 3.14159265358979


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32: (key0, key1, ctr0, ctr1) -> (out0, out1).

    Arguments broadcast; at least one must be a tensor (it fixes the
    device). Returns two int64 tensors of uint32 values.
    """
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    for block in range(5):  # 5 x 4 = 20 rounds
        rots = _ROT[:4] if block % 2 == 0 else _ROT[4:]
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        # key injection after each 4-round block
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def uniforms(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Two float32 U(0,1) draws per counter, strictly inside (0, 1).

    The top 24 bits convert to float32 exactly, so u never rounds to 1.0.
    """
    a, b = threefry2x32(k0, k1, x0, x1)
    scale = 2.0 ** -24
    u0 = ((a >> 8).to(torch.float32) + 0.5) * scale
    u1 = ((b >> 8).to(torch.float32) + 0.5) * scale
    return u0, u1


def normal_pair(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent float32 N(0,1) draws per counter via Box-Muller."""
    u0, u1 = uniforms(k0, k1, x0, x1)
    r = torch.sqrt(-2.0 * torch.log(u0))
    theta = torch.tensor(TWO_PI, dtype=torch.float32) * u1
    return r * torch.cos(theta), r * torch.sin(theta)
