"""The collectives a mesh runs, counted like kernel launches and by
bytes.

Every rank of a mesh runs the same session (SPMD, one process per
device), so a collective is issued by every rank of its group at the same
point of the same host schedule. Each one here is pure data movement: an
all-gather concatenates blocks, a broadcast copies the donor's tensor,
and a value crosses ranks unchanged, which is what keeps a meshed
stream bitwise the unmeshed one.

``launches`` counts the calls by purpose: ``wave`` (inside a decode
wave: its tokens, logprobs and selected KV pages), ``rows`` (a wave
buffer's rows gathered for the host or the demand merge) and ``prefill``
(the donor's prefill handed to every rank), ``train`` (a training
step's parameter gathers and gradient reductions, :class:`MeshComm`),
``checkpoint`` (leaves gathered for a save) and ``tp`` (the partitioned
layer program's crossings over 'model', ``parallel.tensor``). A captured wave adds
its collectives on every replay, as its kernel launches
(``runtime.graphs.KERNEL_COUNTERS``).

``collective_bytes`` counts bytes by the reference's five kinds (its
``launch/roofline.py``): each logical collective adds its output bytes
on this rank, as the reference reads them off its compiled program. A
reduction the port carries out as an all-to-all plus an ordered local
sum (below) is counted as the reduce-scatter or all-reduce it stands
for, in the gradient's own dtype.

Training over a mesh (:class:`MeshComm`): parameters are stored as each
rank's block and gathered before use by :func:`gather_param`, whose
backward reduces the gradient. Over the data axes (``pod``, ``data``)
every rank holds other rows of the batch, so the gradients are summed:
in f32 and in rank order (an all-to-all brings each rank the pieces it
keeps, which it adds in order), so that ``D`` data ranks give the bits
of one rank taking ``D`` microbatches. A leaf the partitioned layer
program splits over ``model`` (``parallel.tensor``) is gathered over
the data axes only, and its gradient arrives as the rank's block. A
leaf whole over ``model`` (replicated, or split on its layer axis) is
gathered over it too and read by the layer's replicated compute, so
every rank of the group holds the same full gradient: the backward
takes the rank's slice and sums nothing (a sum there would multiply
the gradient by the axis size).

On the card the group is NCCL, on the CPU gloo
(``repro_torch.launch.mesh``). ``torch.distributed.all_gather`` with a
list of outputs exists under that name in every PyTorch this runs on.

Imports torch and the sharding rules only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding

#: collective calls by purpose (see the module docstring)
launches = {"wave": 0, "rows": 0, "prefill": 0, "train": 0,
            "checkpoint": 0, "tp": 0}

#: the reference's collective kinds (its ``launch/roofline.py``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: output bytes on this rank by kind since :func:`reset_bytes`
collective_bytes = dict.fromkeys(KINDS, 0)
#: the part of ``collective_bytes`` the partitioned layer program's
#: crossings over 'model' moved (``parallel.tensor``)
tp_bytes = dict.fromkeys(KINDS, 0)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def reset_bytes() -> None:
    for key in collective_bytes:
        collective_bytes[key] = 0
        tp_bytes[key] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather_list(t: torch.Tensor, group) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_gather_cat(t: torch.Tensor, group, dim: int = 0, *,
                   purpose: str = "wave") -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    the group's rank order."""
    out = torch.cat(_gather_list(t, group), dim)
    launches[purpose] += 1
    collective_bytes["all-gather"] += _nbytes(out)
    return out


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


def all_to_all(t: torch.Tensor, group, *,
               purpose: str = "wave") -> torch.Tensor:
    """``t`` (n, ...) over a group of n ranks: row j goes to the group's
    rank j; row j of the result came from rank j."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    launches[purpose] += 1
    collective_bytes["all-to-all"] += _nbytes(out)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class PageShard:
    """A rank's block of a KV cache whose page axis is split over a group
    of ranks (the mesh's 'model' axis, or every rank for a long context):
    ``index`` of ``size`` equal blocks, the others held by the ranks of
    ``group`` (None: every rank), block j by the group's rank j.

    A sectored step over such a cache writes each new K/V row on the
    rank that owns its position (:meth:`append_`) and reads its selected
    pages through :meth:`gather_pages`. ``rows``: for each member of the
    group, the kv head of each row its attention reads (the partitioned
    program's rank attends only its query heads' kv heads); None where
    every member reads every kv head.
    """

    group: object
    index: int
    size: int
    rows: tuple | None = None

    @classmethod
    def of(cls, mesh, spec, shape, *, long_context: bool = False,
           rows_for=None) -> "PageShard":
        """This rank's shard of a KV leaf ``(L, B, S, Hkv, hd)`` of global
        ``shape`` under ``spec``, its sequence split over 'model' (over
        every axis for ``long_context``). ``rows_for(i)``: the kv head of
        each attention row of a rank at 'model' index ``i`` (None: every
        kv head on every rank)."""
        mc = MeshComm(mesh)
        index, size = sharding.block_index(spec, tuple(shape), mesh,
                                           mc.coords, 2)
        if long_context:
            group, members = None, [c["model"] if "model" in c else 0
                                    for c in mc.rank_coords]
            want = dist.get_rank()
        else:
            group = mesh.get_group("model")
            members = list(range(mc.sizes.get("model", 1)))
            want = mc.coords.get("model", 0)
        if size != len(members) or index != want:
            raise ValueError(
                f"a page shard needs block j of the sequence on the "
                f"group's rank j: block {index} of {size} on a group of "
                f"{len(members)} (rank {want})")
        rows = None if rows_for is None else tuple(
            tuple(rows_for(i)) for i in members)
        return cls(group, index, size, rows)

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
        """This block's pages (B, P_block, page, Hkv, hd) and the selected
        page indices of every kv head (B, Hkv, K) -> the selected pages of
        this rank's rows, (B, R, K, page, hd): row r holds the pages of kv
        head ``rows[index][r]`` (of kv head r where ``rows`` is None), in
        selection order.

        Each rank reads, for every member of the group, the selected
        pages of that member's rows at their offset in its own block; an
        all-gather (every member reads every kv head) or an all-to-all
        (each member its rows) brings each rank every member's reads, and
        each page is taken from the rank that owns it: only selected pages
        cross ranks, and unchanged. Nothing full-length is built."""
        B, pb, page, hkv, hd = pages.shape
        dev = pages.device
        idx = page_idx.long()
        by_head = pages.permute(0, 3, 1, 2, 4)  # (B, Hkv, P_block, page, hd)
        b = torch.arange(B, device=dev)
        if self.rows is None:
            mine = by_head[b[:, None, None], torch.arange(
                hkv, device=dev)[None, :, None], idx % pb]  # (B, H, K, ..)
            every = all_gather_cat(mine[None], self.group)
            own = idx
        else:
            heads = torch.tensor(self.rows, device=dev)  # (size, R)
            want = idx[:, heads].transpose(0, 1)  # (size, B, R, K)
            # (size, B, R, K, page, hd): member j's reads in row j
            mine = by_head[b[None, :, None, None], heads[:, None, :, None],
                           want % pb]
            every = all_to_all(mine, self.group)
            own = want[self.index]
        rows, k = own.shape[1:]
        return every[own // pb, b[:, None, None],
                     torch.arange(rows, device=dev)[None, :, None],
                     torch.arange(k, device=dev)[None, None, :]]


# -- training over a mesh ------------------------------------------------------


class MeshComm:
    """One rank's view of a DeviceMesh for a training step: its
    coordinates, a group per axis of more than one rank, and the
    collectives a tree stored as rank blocks needs. Axes of size 1 issue
    no collective (a one-rank mesh runs none at all)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = sharding.mesh_axes(mesh)
        self.coords = sharding.mesh_coords(mesh)
        self.groups = {a: mesh.get_group(a) for a, n in self.sizes.items()
                       if n > 1}
        #: data axes of more than one rank, outermost first
        self.data = tuple(a for a in sharding.data_axes(mesh)
                          if self.sizes[a] > 1)
        self.n_data = math.prod(self.sizes[a] for a in self.data)
        names = tuple(self.sizes)
        ranks = mesh.mesh.reshape(-1).tolist()
        by_rank = sorted(zip(ranks, _indices(tuple(self.sizes.values()))))
        #: every rank's coordinates, in rank order
        self.rank_coords = [dict(zip(names, idx)) for _, idx in by_rank]
        self.world = len(ranks)

    def data_shard(self) -> tuple[int, int]:
        """``(index, count)`` of this rank's rows of a global batch: the
        data axes flattened, the outermost first (the batch spec's
        order)."""
        index, count = 0, 1
        for a in sharding.data_axes(self.mesh):
            index = index * self.sizes[a] + self.coords[a]
            count *= self.sizes[a]
        return index, count

    def block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of a global tensor (a view)."""
        return t[sharding.local_slice(spec, tuple(t.shape), self.mesh,
                                      self.coords)]

    def gather(self, t: torch.Tensor, spec, *,
               purpose: str = "train") -> torch.Tensor:
        """The global tensor from this rank's block ``t`` of it under
        ``spec``: one all-gather per split axis (a dim split over several
        axes gathers the innermost first)."""
        for dim, entry in enumerate(spec):
            for a in reversed(sharding._axes_of(entry)):
                if a in self.groups:
                    t = all_gather_cat(t, self.groups[a], dim,
                                       purpose=purpose)
        return t

    def _all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...) with n the axis size: row j goes to the axis's
        rank j; returns (n, ...) whose row j came from rank j."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.groups[axis])
        launches["train"] += 1
        return out

    def _over_data(self, pieces: torch.Tensor) -> torch.Tensor:
        """``pieces`` (n_inner, ...) from the innermost data axis's ranks
        -> (n_data, ...) from every data rank, in rank order: the outer
        data axes all-gather it."""
        for a in reversed(self.data[:-1]):
            pieces = torch.cat(_gather_list(pieces, self.groups[a]), 0)
            launches["train"] += 1
        return pieces

    def reduce_grad(self, g: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block, under ``spec``, of the gradient summed over
        the data ranks: ``g`` is the rank's full gradient of the
        parameter. Over ``model`` the rank's slice is taken; over the data
        axes the sum is in f32, in rank order, and left undivided. With a
        single data rank ``g``'s slice is returned in its own dtype."""
        data = set(self.data)
        model_spec = tuple(
            tuple(a for a in sharding._axes_of(e) if a not in data) or None
            for e in spec)
        g = self.block(g, model_spec)
        if not self.data:
            return g
        inner = self.data[-1]
        n_inner = self.sizes[inner]
        dims = [d for d, e in enumerate(spec)
                if set(sharding._axes_of(e)) & data]
        if dims:  # stored split over data: a reduce-scatter
            d = dims[0]
            pieces = self._all_to_all(torch.stack(g.chunk(n_inner, d)), inner)
            total = self._sum_rows(self._over_data(pieces))
            collective_bytes["reduce-scatter"] += _nbytes(pieces[0])
            if len(self.data) > 1:
                collective_bytes["all-reduce"] += _nbytes(pieces[0])
            return total
        # replicated over data: an all-reduce (a reduce-scatter of a flat
        # view, then an all-gather of the f32 sums)
        collective_bytes["all-reduce"] += _nbytes(g)
        flat = g.reshape(-1)
        pad = (-flat.numel()) % n_inner
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        pieces = self._all_to_all(flat.reshape(n_inner, -1), inner)
        total = self._sum_rows(self._over_data(pieces))
        full = torch.cat(_gather_list(total, self.groups[inner]), 0)
        launches["train"] += 1
        return full[:g.numel()].reshape(g.shape)

    @staticmethod
    def _sum_rows(pieces: torch.Tensor) -> torch.Tensor:
        """``0 + pieces[0] + pieces[1] + ...`` in f32."""
        acc = torch.zeros(pieces.shape[1:], dtype=torch.float32,
                          device=pieces.device)
        for piece in pieces:
            acc = acc + piece.float()
        return acc

    def _every_rank(self, x: torch.Tensor) -> torch.Tensor:
        """(world, ...) of every rank's ``x``, in rank order."""
        if self.world == 1:
            return x[None]
        parts = _gather_list(x, None)
        launches["train"] += 1
        collective_bytes["all-reduce"] += _nbytes(x)
        return torch.stack(parts)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """``0 + x_0 + x_1 + ...`` over the data ranks in rank order (a
        rank's ``x`` is the same on every rank of its ``model`` group)."""
        if not self.data:
            return torch.zeros_like(x) + x
        every = self._every_rank(x)
        rows = [r for r, c in enumerate(self.rank_coords)
                if all(c[a] == 0 for a in self.sizes if a not in self.data)]
        acc = torch.zeros_like(x)
        for r in rows:
            acc = acc + every[r]
        return acc

    def max_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x``."""
        return torch.amax(self._every_rank(x), dim=0)

    def sum_of_shards(self, local: list, specs: list) -> torch.Tensor:
        """Sum over leaves, in order, of each leaf's value summed over
        the ranks holding its distinct blocks (for every leaf a 0-d f32
        tensor of this rank's block, e.g. its sum of squares): the ranks
        at coordinate 0 of every axis the leaf is not split over, in rank
        order."""
        every = self._every_rank(torch.stack(local))
        total = None
        for j, spec in enumerate(specs):
            split = {a for a in sharding.spec_axes(spec)
                     if self.sizes.get(a, 1) > 1}
            rows = [r for r, c in enumerate(self.rank_coords)
                    if all(c[a] == 0 for a in self.sizes if a not in split)]
            s = every[rows[0], j]
            for r in rows[1:]:
                s = s + every[r, j]
            total = s if total is None else total + s
        return total


def _indices(shape: tuple):
    """Every index tuple of ``shape``, row-major."""
    if not shape:
        yield ()
        return
    for i in range(shape[0]):
        for rest in _indices(shape[1:]):
            yield (i, *rest)


class _GatherParam(torch.autograd.Function):
    """Forward: the global parameter from the rank's block. Backward:
    :meth:`MeshComm.reduce_grad` of the full gradient, handed to ``sink``
    (``sink(key, block)``), so the f32 sum never passes through
    autograd's cast back to the block's dtype; the block itself gets no
    gradient."""

    @staticmethod
    def forward(ctx, block, mc, spec, sink, key):
        ctx.mc, ctx.spec, ctx.sink, ctx.key = mc, spec, sink, key
        return mc.gather(block, spec)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink(ctx.key, ctx.mc.reduce_grad(grad, ctx.spec))
        return None, None, None, None, None


def gather_param(block: torch.Tensor, mc: MeshComm, spec, sink,
                 key) -> torch.Tensor:
    """The global parameter from this rank's ``block`` under ``spec``;
    its gradient reaches ``sink(key, reduced block)`` (see
    :class:`_GatherParam`)."""
    return _GatherParam.apply(block, mc, spec, sink, key)
