"""The collectives a serving mesh runs, counted like kernel launches.

Every rank of a mesh runs the same session (SPMD, one process per
device), so a collective is issued by every rank of its group at the same
point of the same host schedule. Each one here is pure data movement: an
all-gather concatenates blocks, a broadcast copies the donor's tensor,
and a value crosses ranks unchanged, which is what keeps a meshed
stream bitwise the unmeshed one.

``launches`` counts the calls by purpose: ``wave`` (inside a decode
wave: its tokens, logprobs and selected KV pages), ``rows`` (a wave
buffer's rows gathered for the host or the demand merge) and ``prefill``
(the donor's prefill handed to every rank). A captured wave adds its
collectives on every replay, as its kernel launches
(``runtime.graphs.KERNEL_COUNTERS``).

On the card the group is NCCL, on the CPU gloo
(``repro_torch.launch.mesh``). ``torch.distributed.all_gather`` with a
list of outputs exists under that name in every PyTorch this runs on.

Leaf module: imports torch only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

#: collective calls by purpose (see the module docstring)
launches = {"wave": 0, "rows": 0, "prefill": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def all_gather_cat(t: torch.Tensor, group, dim: int = 0, *,
                   purpose: str = "wave") -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    the group's rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    launches[purpose] += 1
    return torch.cat(parts, dim)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """A tensor's place in a broadcast tree: its shape and dtype."""

    shape: tuple
    dtype: torch.dtype


def _map_leaves(fn, tree):
    if isinstance(tree, (torch.Tensor, _Slot)):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


def _tensors(tree) -> list[torch.Tensor]:
    out: list = []
    _map_leaves(out.append, tree)
    return out


def receive_like(tree, src: int, group, device) -> object:
    """The structure of ``tree`` (meaningful on rank ``src`` only) on
    every rank, its tensors allocated but not yet filled: the donor
    broadcasts each tensor's shape and dtype, and the others allocate
    them on ``device``. :func:`broadcast_` fills them."""
    skeleton = [None]
    if dist.get_rank() == src:
        skeleton = [_map_leaves(lambda t: _Slot(tuple(t.shape), t.dtype),
                                tree)]
    dist.broadcast_object_list(skeleton, src=src, group=group,
                               device=device if device.type == "cuda"
                               else None)
    launches["prefill"] += 1
    if dist.get_rank() == src:
        return tree
    return _map_leaves(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                             device=device), skeleton[0])


def broadcast_(tree, src: int, group) -> object:
    """Rank ``src``'s tensors of ``tree`` copied into every rank's, in
    place; returns ``tree``."""
    for t in _tensors(tree):
        dist.broadcast(t, src=src, group=group)
        launches["prefill"] += 1
    return tree


@dataclasses.dataclass(frozen=True, eq=False)
class PageShard:
    """A rank's block of a KV cache whose page axis is split over the
    mesh's 'model' axis: ``index`` of ``size`` equal blocks, the others
    held by the ranks of ``group``.

    A sectored step over such a cache writes each new K/V row on the
    rank that owns its position (:meth:`append_`) and reads its selected
    pages through :meth:`gather_pages`.
    """

    group: object
    index: int
    size: int

    def append_(self, k: torch.Tensor, v: torch.Tensor, length, k_new,
                v_new) -> None:
        """Write each sequence's new row at global position ``length``
        into this block, in place, where the block holds that position
        (the others leave their rows as they are, as an append past a
        cache's end does). k/v: (B, S_block, Hkv, hd); k_new/v_new: (B,
        1, Hkv, hd)."""
        B, S = k.shape[:2]
        b = torch.arange(B, device=k.device)
        local = length.long() - self.index * S
        row = torch.clamp(local, 0, S - 1)
        owned = ((local >= 0) & (local < S))[:, None, None]
        k[b, row] = torch.where(owned, k_new[:, 0].to(k.dtype), k[b, row])
        v[b, row] = torch.where(owned, v_new[:, 0].to(v.dtype), v[b, row])

    def gather_pages(self, pages: torch.Tensor,
                     page_idx: torch.Tensor) -> torch.Tensor:
        """This block's pages (B, P_block, page, Hkv, hd) -> a full-length
        page buffer (B, P_block * size, page, Hkv, hd) that holds the
        pages ``page_idx`` (B, Hkv, K) selects at their own page indices
        (every other page zero). Each rank reads the selected pages at
        their offset in its block, one all-gather brings every rank's
        reads, and each selected page is taken from the rank that owns
        it: only the selected pages cross ranks, and unchanged."""
        B, pb, page, hkv, hd = pages.shape
        idx = page_idx.long()
        owner = idx // pb
        b = torch.arange(B, device=pages.device)[:, None, None]
        h = torch.arange(hkv, device=pages.device)[None, :, None]
        mine = pages.permute(0, 3, 1, 2, 4)[b, h, idx % pb]  # (B,H,K,p,hd)
        every = all_gather_cat(mine[None], self.group)  # (size, B,H,K,p,hd)
        selected = every[owner, b, h, torch.arange(
            idx.shape[-1], device=pages.device)[None, None, :]]
        full = pages.new_zeros((B, pb * self.size, page, hkv, hd))
        full[b, idx, :, h, :] = selected
        return full
