"""MeshBackend: multi-device wave execution for ``ServeSession``
(counterpart of the JAX package's ``serve/mesh_backend.py``).

The paper's end game is throughput at scale under high memory-level
parallelism (§8): route every access class to the resource that serves it
cheapest. The serving translation of that principle:

* the wave's **slot axis** shards over the mesh's 'data' axis: batch
  capacity scales with devices while each slot's sectored fetch path
  stays fixed-width per device;
* the **paged KV cache** additionally spreads its page axis over
  'model' (storage distributed over the whole mesh); the sectored attend
  then gathers the predictor-selected pages across 'model' ranks — a
  device-to-device sector fetch, the VBL transfer crossing devices;
* **prefill** runs on a *donor* rank, the last of the mesh, which hands
  the finished rows to every rank.

Where the reference is one controller placing arrays with
``device_put``, the port is SPMD, PyTorch's idiom: one process per
device, every rank running the same ``ServeSession`` on the same host
schedule. A rank keeps its block of the wave buffer
(:class:`ShardedWave`), computes its slots' tokens, and one all-gather
per wave gives every rank all of them (and their logprobs), so every
rank's session sees the whole stream. Placement is collectives
(:mod:`repro_torch.parallel.comm`): the donor broadcasts prefilled rows,
'model' ranks gather selected pages, and 'data' ranks gather tokens.

Determinism contract (the cross-mesh oracle, ``tests/test_torch_mesh*``):
token streams, logprobs and metered joules are **bitwise equal across
mesh shapes** and to the unmeshed session, greedy and sampled. Every
cross-rank interaction is pure data movement: a slot's math is its own
(selection and RNG keys are per-slot pure functions of ``(seed,
position)``), the page shard is only ever gathered (the attend runs on
the gathered pages, never contracting over the sharded cache axis), and
energy comes from host counters. Page sharding is therefore enabled
only for gather-based backends, decided by *calling* ``k_for(None)``: a
``MeteredBackend`` always has the method but answers None over a dense
backend, whose attend must never see a sharded sequence axis.

``MeshBackend`` is a transparent decorator like
:class:`~repro_torch.telemetry.meters.MeteredBackend` and composes with
it in either order: unknown attributes (``meter``, ``k_for``,
``kv_geometry``, ...) delegate to the wrapped backend.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel import comm, sharding
from repro_torch.runtime.graphs import unflatten
from repro_torch.serve.backend import _in_place, _select_


class ShardedWave:
    """One rank's block of a serving wave buffer.

    ``local`` is a state of the inner backend's kind holding the slots
    ``slots`` (a slice of the global slot axis) and, where the pages are
    sharded, one block of every KV leaf's page axis. The session talks to
    it as to the whole buffer: :meth:`set_row` takes global slot indices
    (a rank keeps the rows of its slots), and ``table`` / ``position``
    are the whole buffer's, gathered over the 'data' ranks for the
    host-side meter (every rank reads them at the same point of the
    schedule).
    """

    def __init__(self, backend: "MeshBackend", local, specs: list,
                 slots: slice, sharded: bool):
        self.backend = backend
        self.local = local
        self.specs = specs
        self.slots = slots
        # False where the slot axis degraded to replicated (a slot count
        # the 'data' axis does not divide): every rank holds every slot
        self.sharded = sharded
        # True where the KV page axis is split over 'model'
        self.pages_sharded = any(
            "model" in sharding.spec_axes(spec) for spec in specs)

    def set_row(self, slot: int, row) -> None:
        """Admit a (replicated, batch-1) row into global slot ``slot``:
        the rank holding that slot keeps the row's block of pages."""
        if self.slots.start <= slot < self.slots.stop:
            self.local.set_row(slot - self.slots.start,
                               self.backend.row_block(row, self.specs))

    def _gathered(self, name: str) -> torch.Tensor:
        leaf, axis = next((t, a) for n, t, a in
                          sharding.slot_leaves(self.local) if n == name)
        if not self.sharded:
            return leaf
        return comm.all_gather_cat(leaf, self.backend.data_group, axis,
                                   purpose="rows")

    @property
    def table(self) -> torch.Tensor:
        return self._gathered("table")

    @property
    def position(self) -> torch.Tensor:
        return self._gathered("position")


class MeshBackend:
    """Wrap a ``DecodeBackend`` so session waves run sharded over a mesh.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` over every
    rank of the default process group, with axes ``("data",)`` or
    ``("data", "model")`` (``repro_torch.launch.mesh.make_serving_mesh``).
    The session discovers the hooks by ``getattr`` (see
    ``serve.backend``): ``wave_for`` (the meshed fused wave),
    ``place_stacked`` (a wave buffer to this rank's block),
    ``place_rows`` (the donor's prefilled rows to every rank) and
    ``vmapped_prefill`` (the group prefill on the donor). A plain backend
    has none and the session behaves as before.
    """

    def __init__(self, inner, mesh, *, shard_pages: bool | None = None,
                 donor_prefill: bool = True):
        self.inner = inner
        self.mesh = mesh
        axes = sharding.mesh_axes(mesh)
        if set(axes) - {"data", "model"}:
            raise ValueError(f"a serving mesh has axes ('data',) or "
                             f"('data', 'model'); got {tuple(axes)}")
        ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        if sorted(ranks) != list(range(dist.get_world_size())):
            raise ValueError(
                f"the mesh's ranks {ranks} must be every rank of the "
                f"process group (world size {dist.get_world_size()})")
        if shard_pages is None:
            # gather-based data paths only (see module docstring). Probe by
            # CALLING k_for, not by attribute presence: a MeteredBackend
            # always has the method but answers None over a dense inner
            # backend, and a dense attend must never get a sharded page axis
            k_for = getattr(inner, "k_for", None)
            shard_pages = k_for is not None and k_for(None) is not None
        self.shard_pages = shard_pages
        self.rank = dist.get_rank()
        self.coords = sharding.mesh_coords(mesh)
        self.data_group = mesh.get_group("data")
        self.page_shard = (comm.PageShard(mesh.get_group("model"),
                                          self.coords["model"],
                                          axes["model"])
                           if shard_pages and "model" in axes else None)
        # the donor: the last mesh rank, so the wave's slot blocks (filled
        # from rank 0 upward) drain before prefill contention matters
        self.donor_rank = ranks[-1] if donor_prefill else ranks[0]
        self.prefill_fn = self._donor_prefill
        # NOTE: a meter's mesh_shape provenance stamp is owned by the
        # ServeSession that actually drives waves (it clears the stamp
        # when the same meter is later reused unmeshed) — constructing a
        # wrapper must not mutate shared telemetry state

    # -- mesh identity -----------------------------------------------------

    @property
    def mesh_shape(self) -> tuple[int, ...]:
        return tuple(sharding.mesh_axes(self.mesh).values())

    @property
    def donor_device(self) -> str:
        """Where prefill runs: the donor rank and its device type."""
        return f"rank {self.donor_rank} ({self.mesh.device_type})"

    # -- placement ---------------------------------------------------------

    def wave_shardings(self, state) -> list:
        """Specs for a wave buffer's leaves
        (``sharding.wave_state_shardings``)."""
        return sharding.wave_state_shardings(self.mesh, state,
                                             shard_pages=self.shard_pages)

    def _block(self, spec, shape, batch_axis=None) -> tuple:
        index = sharding.local_slice(spec, shape, self.mesh, self.coords)
        if batch_axis is not None:
            index = (index[:batch_axis] + (slice(None),)
                     + index[batch_axis + 1:])
        return index

    def place_stacked(self, stacked):
        """A whole wave buffer to this rank's block (a copy), as a
        :class:`ShardedWave`; a ShardedWave is returned as it is."""
        if isinstance(stacked, ShardedWave):
            return stacked
        specs = self.wave_shardings(stacked)
        named = sharding.slot_leaves(stacked)
        blocks = [t[self._block(spec, tuple(t.shape))].clone()
                  for spec, (_, t, _) in zip(specs, named)]
        local = unflatten(stacked, blocks)
        # the slot axis as the position leaf (slots,) has it
        _, position, _ = named[-1]
        spec = specs[-1]
        block = self._block(spec, tuple(position.shape))[0]
        return ShardedWave(self, local, specs, block, spec[0] is not None)

    def row_block(self, row, specs: list):
        """A batch-1 row cut to this rank's block of pages (its batch axis
        kept whole)."""
        blocks = [t[self._block(spec, tuple(t.shape), axis)]
                  for spec, (_, t, axis) in zip(specs,
                                                sharding.slot_leaves(row))]
        return unflatten(row, blocks)

    def place_rows(self, rows):
        """The donor's prefilled rows (a state or a list of states) to
        every rank, replicated: each rank's tensors are overwritten with
        the donor's by broadcast. Rows from :meth:`vmapped_prefill` or
        ``prefill_fn`` are only complete on the other ranks once this
        ran."""
        return comm.broadcast_(rows, self.donor_rank, None)

    # -- wave execution ----------------------------------------------------

    def wave_for(self, fn: Callable, *, sampled: bool = False) -> Callable:
        """The meshed fused wave for a step ``fn``:
        ``wave(stacked, token, rows) -> (slots, 1) int32 tokens``.

        The same wave a session builds (``serve.backend.make_fused_wave``:
        the step, token selection, stop guard and logprob), run over this
        rank's block of slots: ``fn`` (over this rank's page block when
        the pages are sharded, ``fn.for_pages``) steps the block, each
        slot's token is selected from its own logits and sampler row, and
        one all-gather over the 'data' ranks gives every rank every
        slot's token and logprob. The sampler rows are replicated: every
        rank advances all of them. A step that offers ``capture`` makes
        the whole wave, collectives included, one CUDA graph.
        """
        built: list[Callable] = []

        def build(stacked: ShardedWave) -> Callable:
            step = fn
            if stacked.pages_sharded:
                for_pages = getattr(fn, "for_pages", None)
                if for_pages is None:
                    raise ValueError(
                        f"page-sharded waves need a step that attends over "
                        f"a block of pages (fn.for_pages); {fn!r} has none")
                step = for_pages(self.page_shard)
            step_ = getattr(step, "step_", None) or _in_place(step)
            block = stacked.slots
            gather = None
            if stacked.sharded:
                def gather(t):
                    return comm.all_gather_cat(t, self.data_group)

            def body(local, token, rows):
                logits = step_(local, token[block])
                return _select_(logits, token, rows, sampled, block=block,
                                gather=gather)
            capture = getattr(step, "capture", None)
            return capture(body) if capture is not None else body

        def wave(stacked: ShardedWave, token: torch.Tensor, rows):
            # built on the first buffer (a session rebuilding its buffer
            # drops its waves); a captured body refuses another buffer
            if not built:
                built.append(build(stacked))
            return built[0](stacked.local, token, rows)

        # the body once built: a CapturedStep (its ``launches`` include
        # the collectives one replay makes) where the step captures
        wave.built = built
        return wave

    # -- prefill (donor rank) ----------------------------------------------

    def _on_donor(self, compute: Callable):
        """``compute()`` on the donor; its logits broadcast to every rank
        and its rows allocated on the others (filled by
        :meth:`place_rows`)."""
        out = compute() if self.rank == self.donor_rank else None
        out = comm.receive_like(out, self.donor_rank, None, self.device)
        logits, rows = out
        comm.broadcast_(logits, self.donor_rank, None)
        return logits, rows

    def _donor_prefill(self, tokens):
        """Single-prompt prefill on the donor rank: ``(logits, state)``,
        the logits on every rank, the state on the others after
        :meth:`place_rows`."""
        return self._on_donor(lambda: self.inner.prefill_fn(tokens))

    def vmapped_prefill(self, prompts):
        """Group prefill on the donor rank: each prompt through the inner
        batch-1 prefill in turn (bitwise the FIFO admission path), as
        ``(logits (n, vocab), [state, ...])``; the logits on every rank,
        the states on the others after :meth:`place_rows`."""
        def compute():
            rows = [self.inner.prefill_fn(p[None, :]) for p in prompts]
            return torch.cat([r[0] for r in rows]), [r[1] for r in rows]
        return self._on_donor(compute)

    # -- demand merge ------------------------------------------------------

    def merge_demands(self, stacked, group_ids):
        """The inner OR-merge over the whole wave's sector table (slots of
        one group may lie on different ranks): the table is gathered over
        the 'data' ranks, merged, and each rank keeps its block, in place.
        """
        if not isinstance(stacked, ShardedWave):
            return self.inner.merge_demands(stacked, group_ids)
        local = stacked.local
        whole = dataclasses.replace(local, table=stacked.table)
        merged = self.inner.merge_demands(whole, group_ids)
        if merged is not whole:
            axis = next(a for n, _, a in sharding.slot_leaves(local)
                        if n == "table")
            index = [slice(None)] * merged.table.ndim
            index[axis] = stacked.slots
            local.table.copy_(merged.table[tuple(index)])
        return stacked

    # -- data-path delegation ----------------------------------------------
    # (identity-stable like MeteredBackend: the session's wave cache keys
    # on id(fn), and wave_for above closes over the delegated identity)

    @property
    def decode_fn(self):
        return self.inner.decode_fn

    @property
    def sectored_fn(self):
        return self.inner.sectored_fn

    @property
    def demand_merge_fn(self):
        return self.inner.demand_merge_fn

    @property
    def supports_sectored(self) -> bool:
        return self.inner.supports_sectored

    def sectored_fn_for(self, topk_frac: float | None):
        return self.inner.sectored_fn_for(topk_frac)

    def __getattr__(self, name: str):
        # transparent decorator: meter / k_for / kv_geometry / ... pass
        # through so MeshBackend and MeteredBackend compose in either order
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return (f"MeshBackend({self.inner!r}, mesh={self.mesh_shape}, "
                f"shard_pages={self.shard_pages})")
