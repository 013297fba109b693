"""Weights made from the seed, on the card, for both sides.

The leaves are those of the configuration's family, under the
benchmark's own names, at the published shapes (``leaves`` of its plain
reference in ``references/``). Every random leaf is one slice of a single
``normal_`` call on the device, in the dtype the model is served in, then
scaled. The same seed gives the same values on the same card, so the
reference makes them again after the program's run, without taking
anything from the program.
"""

from __future__ import annotations

import math

import torch

from . import references


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """{name: tensor} in ``dtype`` on ``device`` from ``seed``: one
    ``normal_`` call for all random leaves, one ``mul_`` a leaf."""
    leaves = references.of(c).leaves(c)
    n = sum(math.prod(s) for _, s, init, _ in leaves if init == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(n, dtype=dtype, device=device).normal_(generator=gen)
    out, at = {}, 0
    for name, shape, init, scale in leaves:
        if init == "normal":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(scale)
            at += k
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def n_params(c: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in references.of(c).leaves(c))
