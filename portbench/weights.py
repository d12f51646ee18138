"""The weights of a cell, made by the benchmark on the device from the
seed, in the dtype they are served in, and handed to both the program and
the plain reference.

All drawn leaves come from one ``torch.randn`` call on a generator on the
device, cut into views and scaled in place, so making yi-6b's 6 billion
parameters is a few large calls. The scales and the constant leaves are
those the program's own initialiser uses (normal draws scaled by
``fan_in ** -0.5``, embeddings by 0.02, norms at one, RWKV6's decay bias,
bonus and token-shift mix at their constants); the tree has the
program's layout: per-layer leaves stacked on a leading layer axis.
"""

from __future__ import annotations

import math

import torch

from portbench.traffic import seed_key


def make(s: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree for the shapes ``s`` (the architecture's
    ``shapes``), in the layout its module gives."""
    from portbench import archs

    layout = archs.get(s["arch"]).layout(s)
    drawn = [(p, shape, scale) for p, (shape, scale) in layout.items()
             if not isinstance(scale, tuple)]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_key(seed))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    at = 0
    for path, (shape, scale) in layout.items():
        if isinstance(scale, tuple):
            _, value, cdtype = scale
            leaf = torch.full(shape, value, dtype=cdtype or dtype,
                              device=device)
        else:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            leaf.mul_(scale)
            at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s leaves (views of the stacked ones)."""
    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[i]
    return cut(tree["layers"])
