"""Sectored KV-cache decode (counterpart of the JAX package's
``runtime/sectored_decode.py``): the paper's Sectored Activation + VBL
adapted to serving.

Each decode step, per layer:

  1. the Sector Predictor picks the top-K KV *sectors* (token pages) per
     (batch, kv-head) — the sector bits;
  2. only those pages are read (K*page tokens, not the whole sequence);
  3. attention runs over the read pages;
  4. the observed per-page attention mass updates the predictor's table.

``kernel`` picks how steps 2–3 run: ``"dispatch"`` gathers the selected
pages and attends with plain torch ops; ``"fused"`` calls
``kernels.sectored_attention.sectored_attention_paged`` — the CUDA kernel
on the GPU, its plain version on the CPU, where it is bitwise the
dispatch path; ``"fused_q8"`` feeds that kernel per-sector int8 KV.

The layer body is the reference's: attention, then SwiGLU or, for a MoE
config, ``models.moe.moe_ffn`` (``model.ffn``).

Port notes:

* the reference's ``lax.scan`` over layers is a Python loop over the
  stacked ``(L, ...)`` state;
* the reference's one-hot KV append becomes an in-place row write
  (``models.attention.append_kv``): a state passed to a step is consumed
  by it (its K/V buffers hold the new row afterwards);
* the step's one body is :func:`sectored_decode_step_`, which writes the
  new lengths, table and position into the state it is given, so its
  buffers never move and a CUDA graph can capture it; the functional
  :func:`sectored_decode_step` runs it on a fork of the state;
* where the reference jits (the step, the fused wave, the prefill scan),
  the backend on the card replays captured CUDA graphs
  (:mod:`repro_torch.runtime.graphs`); ``graphs=False`` runs eagerly;
* ``fused_q8`` re-quantizes the whole cache on every step, as the
  reference does;
* the prefix-cache hooks: ``state_prefix`` copies a cached state (the
  reference aliases its immutable arrays; here the next append would
  write into the cached entry) and ``suffix_prefill`` runs the prefill's
  step from that seed;
* a cache whose page axis is split over a mesh's 'model' axis
  (``serve.mesh_backend.MeshBackend``; every axis for a long context):
  where the reference's SPMD partitioner gathers the selected pages
  across shards, a step built with ``shard=``
  (:class:`~repro_torch.parallel.comm.PageShard`) writes each new row
  on the rank that owns its position and brings the rank the selected
  pages of the kv heads it reads from the ranks that own them. The
  dispatch attend reads them as it reads a gather from a whole cache;
  the paged kernel gets a buffer of the selected pages only (slot j
  holds the j-th selected page, whose valid tokens the count
  ``_slot_length`` gives), which changes neither its length mask nor
  its per-page mass.

The partitioned program (``tp``, a ``parallel.tensor.TP``; the default
``tensor.UNSPLIT`` runs today's ops of the unsplit program): as the
reference's step jitted under its shardings, the projections, FFN,
embedding and logits run as ``model.decode_step_`` runs them under
``tp``; the table is whole on every rank (``sectored_state_shardings``
replicates it over 'model'), so every rank selects the same pages; the
rank attends its query heads over the kv heads they read
(:func:`attend_rows`); the page mass is gathered over 'model' (a kv
head whose query heads straddle ranks: each rank's part of its sums,
summed over 'model'), so every rank applies the same table update; and
``wo``'s partial products are summed over 'model'.
:func:`make_sectored_decode_step` on a DeviceMesh runs it on the rank's
blocks (:func:`mesh_step`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import backend, quantized_kv, sectored_attention
from repro_torch.models import attention, layers, model
from repro_torch.parallel import comm, sharding, tensor
from repro_torch.parallel.tensor import UNSPLIT
from repro_torch.runtime import sector_predictor
from repro_torch.runtime.graphs import Step, copy_tree_, leaves
from repro_torch.serve.backend import ServingBackend
from repro_torch.telemetry.meters import KVGeometry
from repro_torch.train import step as step_mod

PAGE_SIZE = 128  # tokens per KV sector
TOPK_FRAC = 1 / 8  # fraction of pages fetched
MIN_TOPK = 4
NEG_INF = -1e30
KERNELS = ("dispatch", "fused", "fused_q8")


def n_pages(seq_len: int) -> int:
    return (seq_len + PAGE_SIZE - 1) // PAGE_SIZE


def topk_for(seq_len: int, frac: float = TOPK_FRAC,
             min_topk: int = MIN_TOPK) -> int:
    """Pages a fraction resolves to, floored at ``min_topk``."""
    return max(int(n_pages(seq_len) * frac), min_topk, 1)


def padded_pages(seq_len: int) -> int:
    """Pages of the state's KV buffer: a multiple of 8, with room for 8
    tokens past ``seq_len`` (the reference's padding)."""
    return ((n_pages(seq_len + 8) + 7) // 8) * 8


@dataclasses.dataclass
class SectoredState:
    kv: attention.KVCache  # leaves stacked over layers: (L, B, Spad, Hkv, hd)
    table: torch.Tensor  # (L, B, Hkv, P) sector-history table
    position: torch.Tensor  # (B,)

    def _parts(self):
        """(subtree, batch axis) of kv, table and position."""
        return ((self.kv, 1), (self.table, 1), (self.position, 0))

    def clone(self) -> "SectoredState":
        return SectoredState(
            kv=attention.KVCache(k=self.kv.k.clone(), v=self.kv.v.clone(),
                                 length=self.kv.length.clone()),
            table=self.table.clone(), position=self.position.clone())

    def fork(self) -> "SectoredState":
        """A state sharing this one's K/V buffers, with its own length,
        table and position: what a functional step writes into."""
        return SectoredState(
            kv=attention.KVCache(k=self.kv.k, v=self.kv.v,
                                 length=self.kv.length.clone()),
            table=self.table.clone(), position=self.position.clone())

    def zero_(self) -> None:
        """Back to :func:`init_state`'s values, in place."""
        for t in leaves(self):
            t.zero_()

    def zeros_batch(self, n: int) -> "SectoredState":
        """An all-zero state like this one with batch (slot) axis ``n``:
        a serving wave's buffer."""
        def z(t, axis):
            shape = list(t.shape)
            shape[axis] = n
            return torch.zeros(shape, dtype=t.dtype, device=t.device)
        return SectoredState(
            kv=attention.KVCache(k=z(self.kv.k, 1), v=z(self.kv.v, 1),
                                 length=z(self.kv.length, 1)),
            table=z(self.table, 1), position=z(self.position, 0))

    def row(self, slot: int) -> "SectoredState":
        """Batch row ``slot`` as a batch-1 state (views, no copy)."""
        return SectoredState(
            kv=attention.KVCache(k=self.kv.k[:, slot:slot + 1],
                                 v=self.kv.v[:, slot:slot + 1],
                                 length=self.kv.length[:, slot:slot + 1]),
            table=self.table[:, slot:slot + 1],
            position=self.position[slot:slot + 1])

    def set_row(self, slot: int, row: "SectoredState") -> None:
        """Copy batch row 0 of ``row`` into batch row ``slot``, in place
        (admission into a wave slot)."""
        if row.kv.k.shape[2:] != self.kv.k.shape[2:]:
            raise ValueError(
                f"state of cache shape {tuple(row.kv.k.shape[2:])} cannot "
                f"join a wave of {tuple(self.kv.k.shape[2:])}")
        self.kv.k[:, slot] = row.kv.k[:, 0]
        self.kv.v[:, slot] = row.kv.v[:, 0]
        self.kv.length[:, slot] = row.kv.length[:, 0]
        self.table[:, slot] = row.table[:, 0]
        self.position[slot] = row.position[0]


def check_uniform(cfg) -> None:
    """Sectored decode pages the KV cache of uniform attention layers
    (dense or MoE FFN); an attention-free or hybrid stack has none to
    page."""
    if not cfg.uniform_layers:
        raise ValueError(
            f"sectored decode needs uniform attention layers; arch "
            f"{cfg.name!r} is attention-free or hybrid")


def init_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> SectoredState:
    check_uniform(cfg)
    dev = backend.resolve_device(device)
    pages = padded_pages(seq_len)
    shape = (cfg.n_layers, batch, pages * PAGE_SIZE, cfg.n_kv_heads,
             cfg.head_dim_)
    kv = attention.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((cfg.n_layers, batch), dtype=torch.int32,
                           device=dev))
    table = sector_predictor.init_table(cfg.n_layers, batch, cfg.n_kv_heads,
                                        pages, device=dev)
    return SectoredState(kv=kv, table=table,
                         position=torch.zeros((batch,), dtype=torch.int32,
                                              device=dev))


def attend_rows(cfg, tp=UNSPLIT):
    """``(rows, rep)`` of a rank's sectored attend (``tp``: an attention
    layer's context): the kv head each row reads and the query heads a
    row (``rows`` None: every kv head, ``rep = H / Hkv``, the unsplit
    core). Where the core splits the query heads
    (``tensor.heads_local``) the rank's block of them is ``n = H / m``
    heads: whole kv heads where ``n`` is a multiple of ``rep``; one kv
    head's ``n`` heads where ``rep`` is a multiple of ``n`` (the kv
    head's query heads straddle ranks); else one row a query head, each
    reading its own kv head (``attention._core_kv``'s rule)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if not tensor.heads_local(cfg, tp):
        return None, rep
    h0, h1 = tp.block(cfg.n_heads)
    n = h1 - h0
    if n % rep == 0:
        return tuple(range(h0 // rep, h1 // rep)), rep
    if rep % n == 0:
        return (h0 // rep,), n
    return tuple(j // rep for j in range(h0, h1)), 1


def sectored_attend(attn_params, cfg, x, cache: attention.KVCache, table_l,
                    k_pages: int, probe: bool = False,
                    kernel: str = "dispatch", shard=None, tp=UNSPLIT):
    """One-token decode attention over predictor-selected KV sectors.

    x: (B, 1, D). Returns (out, new_cache, new_table_l); the new K/V row is
    written into ``cache`` in place.

    ``probe=True`` widens the selection by one round-robin probe page
    (``sector_predictor.probe_page_for``) so unfetched pages' scores stay
    honest. ``kernel`` selects how the selected pages are read and
    attended (see the module docstring). ``shard`` (a
    :class:`~repro_torch.parallel.comm.PageShard`): ``cache`` holds this
    rank's block of pages, and the selected pages are gathered across
    ranks first. ``tp`` (a ``parallel.tensor.TP``; the default runs the
    unsplit program): the partitioned program, see the module docstring.
    """
    B = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    q, k_new, v_new, local, kv_local = attention._split_qkv(
        attn_params, cfg, x, cache.length[:, None], tp)
    if kv_local:
        k_new, v_new = tp.gather(k_new, -2), tp.gather(v_new, -2)
    probe_page = None
    select_k = k_pages
    if probe:
        probe_page = sector_predictor.probe_page_for(cache.length, PAGE_SIZE)
        select_k = k_pages + 1

    if shard is None:
        attention.append_kv(cache, k_new, v_new)
    else:
        shard.append_(cache.k, cache.v, cache.length, k_new, v_new)
    k, v = cache.k, cache.v

    if getattr(cfg, "sector_share_heads", False):
        # one sector set per sequence (summed head scores)
        shared = torch.sum(table_l, dim=1, keepdim=True)  # (B, 1, P)
        page_idx = sector_predictor.predict_topk(
            shared, cache.length, PAGE_SIZE, select_k, probe_page=probe_page)
        pages = page_idx.expand(B, hkv, select_k)
    else:
        page_idx = sector_predictor.predict_topk(
            table_l, cache.length, PAGE_SIZE, select_k, probe_page=probe_page)
        pages = page_idx

    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}; got {kernel!r}")
    heads, rep = attend_rows(cfg, tp)
    # the rank holds some of a kv head's query heads: its mass is a part
    partial = rep != cfg.n_heads // hkv
    if partial and kernel != "dispatch":
        raise ValueError(
            f"the {kernel} kernel returns each kv head's mass normalised "
            f"over the rank's query heads: it needs whole kv heads on a "
            f"rank ({cfg.n_heads} heads over {tp.size} ranks, "
            f"{cfg.n_heads // hkv} a kv head)")
    qg = q[:, 0].reshape(B, -1, rep, hd)
    kp = k.view(B, -1, PAGE_SIZE, hkv, hd)
    vp = v.view(B, -1, PAGE_SIZE, hkv, hd)
    row_pages = pages if heads is None else pages[:, list(heads)]
    if shard is None and heads is None and kernel != "dispatch":
        # the unsplit program on a whole cache: the kernel steers its
        # reads through the cache's page-major view
        out, mass = _fused(kernel, qg.contiguous(), kp, vp, page_idx,
                           cache.length + 1)
    else:
        if shard is not None:
            # the selected pages of the rank's rows, from their owners
            k_sel = shard.gather_pages(kp, pages)
            v_sel = shard.gather_pages(vp, pages)
        else:
            # with every valid page selected (exact mode) the gathered
            # buffer is the dense cache prefix in ascending page order
            k_sel = sectored_attention.gather_pages(kp, pages)
            v_sel = sectored_attention.gather_pages(vp, pages)
            if heads is not None:
                k_sel, v_sel = k_sel[:, list(heads)], v_sel[:, list(heads)]
        if kernel != "dispatch":
            # the kernel takes a page-major buffer of the selected pages
            # only, slot j holding the rows' j-th selected page
            out, mass = _fused(
                kernel, qg.contiguous(),
                k_sel.permute(0, 2, 3, 1, 4).contiguous(),
                v_sel.permute(0, 2, 3, 1, 4).contiguous(),
                _slots(B, select_k, x.device),
                _slot_length(row_pages, cache.length + 1))
    if kernel == "dispatch":
        tok_pos = (row_pages[..., None].long() * PAGE_SIZE
                   + torch.arange(PAGE_SIZE, device=x.device))
        valid = tok_pos <= cache.length[:, None, None, None]
        if partial:
            out, page_e, total_e = sectored_attention.attend_pages_parts(
                qg, k_sel, v_sel, valid)
            mass = _whole_mass(tp, heads, hkv, page_e, total_e)
        else:
            out, mass = sectored_attention.attend_pages(qg, k_sel, v_sel,
                                                        valid)
    if heads is not None and not partial:
        mass = tp.gather(mass, 1)  # the rank's block of kv heads

    out = out.to(x.dtype).reshape(B, 1, -1, hd)
    out = attention.out_project(out, attn_params["wo"], tp, local)
    new_table = sector_predictor.update(table_l, pages, mass)
    new_cache = attention.KVCache(k=k, v=v, length=cache.length + 1)
    return out, new_cache, new_table


def _fused(kernel, qg, kp, vp, page_idx, length):
    """The paged kernel over page-major pages, bf16 or (``fused_q8``)
    int8 with per-sector scales."""
    if kernel == "fused_q8":
        kq, k_scale = quantized_kv.quantize_pages(kp)
        vq, v_scale = quantized_kv.quantize_pages(vp)
        return sectored_attention.sectored_attention_paged(
            qg, kq, vq, page_idx, length, k_scale=k_scale, v_scale=v_scale)
    return sectored_attention.sectored_attention_paged(qg, kp, vp, page_idx,
                                                       length)


def _slots(B: int, k: int, device) -> torch.Tensor:
    """Page indices 0..k-1 of a buffer of k selected pages, shared by
    every head: (B, 1, k) int32."""
    return torch.arange(k, dtype=torch.int32, device=device).expand(
        B, 1, k).contiguous()


def _slot_length(pages, length) -> torch.Tensor:
    """The kernel's count for a buffer whose slot j holds selected page
    ``pages[..., j]`` (B, R, K): the valid tokens of the selected pages.
    A selection is ascending, every valid page before any page past the
    fill, and holds the page being written (the recency bonus), so each
    slot's valid tokens are ``clamp(count - j * page, 0, page)`` for this
    count, the same for every row."""
    valid = torch.clamp(length[:, None].long() - pages[:, 0].long()
                        * PAGE_SIZE, 0, PAGE_SIZE)
    return torch.sum(valid, dim=-1).to(torch.int32)


def _whole_mass(tp, heads, hkv: int, page_e, total_e) -> torch.Tensor:
    """Each kv head's page mass from the parts of the rank's rows
    (``attend_pages_parts``), the parts summed over 'model' (f32, in rank
    order): the same bits on every rank."""
    idx = torch.as_tensor(heads, device=page_e.device)
    B, _, K = page_e.shape
    pe = page_e.new_zeros((B, hkv, K)).index_add_(1, idx, page_e)
    te = total_e.new_zeros((B, hkv)).index_add_(1, idx, total_e)
    return tp.sum(pe) / torch.clamp_min(tp.sum(te)[..., None], 1e-30)


def sectored_decode_step_(params, cfg, state: SectoredState, token,
                          k_pages: int, probe: bool = False,
                          kernel: str = "dispatch", shard=None,
                          tp=UNSPLIT) -> torch.Tensor:
    """Full-model one-token decode with sectored attention per layer, in
    place: token (B, 1) int -> logits (B, vocab).

    The new K/V rows, lengths, table and position are written into
    ``state``; no buffer of it moves and nothing syncs with the host, so a
    CUDA graph can capture the step. ``shard``: ``state``'s K/V hold one
    block of a page-sharded cache (see :func:`sectored_attend`). ``tp``:
    the partitioned program (embed, FFN and logits as
    ``model.decode_step_`` runs them under ``tp``).
    """
    x = layers.embed(params, token, tp)
    for i in range(cfg.n_layers):
        lp = model.layer_params(params, i)
        ltp = tp.layer(i)
        cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i],
                                  length=state.kv.length[i])
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        att, cache_new, table_new = sectored_attend(
            lp["attn"], cfg, h, cache, state.table[i], k_pages, probe=probe,
            kernel=kernel, shard=shard, tp=ltp.at("attn"))
        state.kv.length[i].copy_(cache_new.length)
        state.table[i].copy_(table_new)
        x = x + att
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + model.ffn(lp, cfg, h, ltp)
    hidden = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.position.add_(1)
    return model.logits_fn(params, cfg, hidden, tp)[:, 0, :]


def sectored_decode_step(params, cfg, state: SectoredState, token,
                         k_pages: int, probe: bool = False,
                         kernel: str = "dispatch"):
    """:func:`sectored_decode_step_` on ``state.fork()``: token (B, 1) int
    -> (logits (B, vocab), new state). ``state`` is consumed (in-place KV
    append); the new state shares its K/V buffers.
    """
    new_state = state.fork()
    logits = sectored_decode_step_(params, cfg, new_state, token, k_pages,
                                   probe=probe, kernel=kernel)
    return logits, new_state


def or_merge_demands(stacked_state: SectoredState,
                     group_ids) -> SectoredState:
    """Shared-prefix sector-demand OR-merge over a wave's slots.

    The port's wave is one SectoredState whose batch axis is the slot axis
    (the reference stacks per-slot states on a new leading axis and vmaps),
    so the table's slot axis is dim 1 of ``(L, slots, Hkv, P)``.
    """
    table = stacked_state.table.transpose(0, 1)
    pooled = sector_predictor.pool_demands(table, group_ids).transpose(0, 1)
    return SectoredState(kv=stacked_state.kv, table=pooled.contiguous(),
                         position=stacked_state.position)


def unique_fetches(pages, group_ids) -> int:
    """Distinct (group, kv-head, page) sectored fetches a wave issues.

    pages: (slots, Hkv, K) selected page indices per slot; slots in the
    same group fetch from the same KV pages, so duplicates collapse (the
    merge shrinks this when demands are OR-merged first).
    """
    pages = np.asarray(pages)
    gids = np.asarray(group_ids)
    S, H, K = pages.shape
    return len({(int(gids[s]), h, int(pages[s, h, k]))
                for s in range(S) for h in range(H) for k in range(K)})


class SectoredKVBackend(ServingBackend):
    """DecodeBackend over SectoredState with per-page-budget steps.

    Exact mode (every valid page selected) is bitwise the dense
    ``model.decode_step``; a sectored step at a narrower budget is built
    per distinct k (``sectored_fn_for``). ``kernel`` ("dispatch" | "fused"
    | "fused_q8") is how genuinely narrow steps attend; exact mode and
    prefill always run "dispatch", as in the reference.

    On the card (``graphs=True``, the default) the steps, the session's
    fused waves and the prefill step run as replays of captured CUDA
    graphs in one memory pool, where the reference jits them;
    ``graphs=False`` runs them eagerly. A CPU backend always runs eagerly.
    """

    KERNELS = KERNELS

    def __init__(self, cfg, params, *, seq_len: int,
                 topk_frac: float = TOPK_FRAC, min_topk: int = MIN_TOPK,
                 kernel: str = "dispatch", device=None, graphs: bool = True):
        if kernel not in self.KERNELS:
            raise ValueError(f"kernel must be one of {self.KERNELS}; "
                             f"got {kernel!r}")
        check_uniform(cfg)
        self.device = backend.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.seq_len = seq_len
        self.topk_frac = topk_frac
        self.min_topk = min_topk
        self.kernel = kernel
        self.pages = padded_pages(seq_len)
        self.graphs = graphs and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._k_cache: dict[tuple, Step] = {}
        # batch -> (static state, captured exact step) of the prefill
        self._prefill_graphs: dict[int, tuple] = {}
        exact_fn = self._step_for(self.pages)
        super().__init__(self._prefill, exact_fn,
                         self._step_for(self.k_for(topk_frac)),
                         or_merge_demands, vocab=cfg.vocab,
                         device=self.device)

    def _step_for(self, k_pages: int, shard=None) -> Step:
        """The step at a page budget, built once per budget (and per
        :class:`~repro_torch.parallel.comm.PageShard`: ``fn.for_pages(
        shard)`` is the same step over one block of a page-sharded
        cache)."""
        key = (k_pages, shard)
        fn = self._k_cache.get(key)
        if fn is None:
            cfg, params = self.cfg, self.params
            probe = self.probe_pages_for(k_pages) > 0
            kernel = self.kernel if 0 < k_pages < self.pages else "dispatch"

            def step_(state, token):
                return sectored_decode_step_(params, cfg, state, token,
                                             k_pages, probe=probe,
                                             kernel=kernel, shard=shard)
            fn = Step(step_, graphs=self.graphs, pool=self.pool)
            fn.k_pages = k_pages
            fn.kernel = kernel
            if shard is None:
                fn.for_pages = lambda s, k=k_pages: self._step_for(k, s)
            self._k_cache[key] = fn
        return fn

    def probe_pages_for(self, k_pages: int) -> int:
        """Extra probe pages a sectored step at this budget fetches per
        wave (0 in exact mode)."""
        return 1 if 0 < k_pages < self.pages else 0

    def k_for(self, topk_frac: float | None = None) -> int:
        """Concrete page budget a policy fraction resolves to."""
        if topk_frac is None:
            topk_frac = self.topk_frac
        return min(topk_for(self.seq_len, topk_frac, self.min_topk),
                   self.pages)

    def kv_geometry(self):
        """Cache layout for :class:`repro_torch.telemetry.meters.WaveMeter`.

        A ``fused_q8`` backend's sectored fetches move int8 words, so the
        geometry carries the bytes-per-word fraction the meter feeds into
        ``kv_fetch_energy`` (prefill and exact/dense waves read the bf16
        master cache and stay at full width)."""
        word_fraction = (quantized_kv.kv_word_fraction()
                         if self.kernel == "fused_q8" else 1.0)
        return KVGeometry.from_model_cfg(self.cfg, seq_len=self.seq_len,
                                         page_size=PAGE_SIZE,
                                         total_pages=self.pages,
                                         kv_word_fraction=word_fraction)

    def sectored_fn_for(self, topk_frac: float | None):
        if topk_frac is None:
            return self.sectored_fn
        return self._step_for(self.k_for(topk_frac))

    def _prefill(self, tokens):
        """Exact-mode prefill: the exact decode step over each prompt
        token in turn (the reference scans the same step).

        With graphs, every prompt of a batch size replays one captured
        step over one static state, zeroed first: the state's shape
        depends on ``seq_len``, not on the prompt. Each token is a copy
        into the static token and a replay, with no host sync between
        tokens; the logits and state returned are copies.
        """
        return self._scan(None, tokens)

    def _scan(self, seed, tokens):
        """The exact step over ``tokens`` (B, S) from ``seed`` (None: a
        fresh state), as :meth:`_prefill` describes."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32,
                                 device=self.device)
        batch = tokens.shape[0]
        exact = self._step_for(self.pages)
        if self.graphs:
            if batch not in self._prefill_graphs:
                self._prefill_graphs[batch] = (
                    init_state(self.cfg, batch, self.seq_len,
                               device=self.device),
                    exact.capture(exact.step_))
            state, step = self._prefill_graphs[batch]
            if seed is None:
                state.zero_()
            else:
                copy_tree_(state, seed)
        else:
            state = (init_state(self.cfg, batch, self.seq_len,
                                device=self.device)
                     if seed is None else seed)
            step = exact.step_
        logits = None
        for i in range(tokens.shape[1]):
            logits = step(state, tokens[:, i:i + 1])
        if self.graphs:
            return logits.clone(), state.clone()
        return logits, state

    # -- prefix-cache hooks (serve.prefix.PrefixCache warm admission) ------

    def state_prefix(self, state: SectoredState, n_tokens: int
                     ) -> SectoredState:
        """A copy of a donor state cut to its first ``n_tokens``.

        KV rows for positions < n depend only on those n tokens, and the
        exact attend masks every row past the cache length to exact zero,
        so the donor's rows beyond n are invisible; the next append
        overwrites row n. The reference aliases the donor's (immutable)
        K/V; here a step appends in place, so the seed is a clone —
        sharing the donor's buffers would write the first suffix token
        into row n of a cached entry. The sector-history table is carried
        as-is, as in the reference: exact mode selects every page
        whatever the table holds, so only the exact path is bitwise the
        cold one.
        """
        seed = state.clone()
        seed.kv.length.fill_(int(n_tokens))
        seed.position.fill_(int(n_tokens))
        return seed

    def suffix_prefill(self, state: SectoredState, tokens):
        """Resume exact-mode prefill from a seeded state (a warm
        admission prefills only the unmatched prompt suffix): the same
        exact step :meth:`_prefill` runs, from ``state`` instead of a
        fresh one, so (seed at n) + (suffix) is bitwise the cold prefill.
        With graphs the seed is copied into the static prefill state and
        the captured step replayed, copies returned; eagerly the seed is
        consumed (stepped in place)."""
        return self._scan(state, tokens)


def make_serving_fns(cfg, *, params, seq_len: int,
                     topk_frac: float = TOPK_FRAC, min_topk: int = MIN_TOPK,
                     kernel: str = "dispatch", device=None,
                     graphs: bool = True) -> SectoredKVBackend:
    """Build the SectoredState serving backend."""
    return SectoredKVBackend(cfg, params, seq_len=seq_len,
                             topk_frac=topk_frac, min_topk=min_topk,
                             kernel=kernel, device=device, graphs=graphs)


def mesh_step(cfg, mesh, pspec, sspec, state_shape, k_pages: int, *,
              long_context: bool = False, kernel: str = "dispatch",
              probe: bool = False):
    """``step_(params, state, token) -> logits``: the partitioned
    sectored step on a DeviceMesh, in place on the rank's blocks.
    ``params`` are its blocks under ``pspec`` (each layer's leaves
    gathered as the layer runs, over the data axes and where 'model'
    does not split their compute: ``train.step.serving_params``),
    ``state`` its block under ``sspec`` (``sectored_state_shardings`` of
    ``state_shape``: the K/V pages split over 'model', over every axis
    for ``long_context``; the table, lengths and position whole over
    'model'), ``token`` its rows. Each rank attends its query heads over
    the selected pages of the kv heads they read (:func:`attend_rows`),
    gathered from the ranks that own them
    (:class:`~repro_torch.parallel.comm.PageShard`)."""
    serving = step_mod.serving_params(cfg, mesh, pspec)
    attn = step_mod.split_context(mesh, cfg, pspec)[0].layer(0).at("attn")
    rows_for = None
    if attend_rows(cfg, attn)[0] is not None:
        def rows_for(i):
            return attend_rows(cfg, dataclasses.replace(attn, index=i))[0]
    shard = comm.PageShard.of(mesh, sspec.kv.k, state_shape.kv.k.shape,
                              long_context=long_context, rows_for=rows_for)

    def step_(params, state, token):
        tree, tp = serving(params)
        return sectored_decode_step_(tree, cfg, state, token, k_pages,
                                     probe=probe, kernel=kernel, shard=shard,
                                     tp=tp)

    return step_


def make_sectored_decode_step(cfg, mesh, *, batch: int, seq_len: int,
                              long_context: bool = False,
                              topk_frac: float = TOPK_FRAC,
                              kernel: str = "dispatch", probe: bool = False):
    """Factory mirroring ``train.step.make_decode_step`` for the sectored
    path: ``(fn, (param_specs, state_specs, token_spec), state_shape)``,
    the specs from :mod:`repro_torch.parallel.sharding` over fake-tensor
    shapes (nothing is allocated), ``fn(params, state, token) -> (logits,
    new_state)``. On a DeviceMesh ``params`` are the rank's
    blocks, ``state`` its block under ``state_specs`` and ``token`` its
    rows: the step runs the partitioned program (:func:`mesh_step`) and
    returns the new state as the rank's block. ``kernel`` and ``probe``:
    as :func:`sectored_attend` takes them."""
    k_pages = topk_for(seq_len, topk_frac)
    pspec = sharding.param_shardings(
        mesh, sharding.abstract(model.init_params, cfg, device="cpu"))
    state_shape = sharding.abstract(init_state, cfg, batch, seq_len,
                                    device="cpu")
    dp = sharding.data_axes(mesh)
    sspec = sharding.sectored_state_shardings(mesh, state_shape,
                                              long_context=long_context)
    tok_spec = sharding.P(dp if not long_context else None, None)
    if step_mod.device_mesh(mesh):
        step_ = mesh_step(cfg, mesh, pspec, sspec, state_shape, k_pages,
                          long_context=long_context, kernel=kernel,
                          probe=probe)

        def fn(params, state, token):
            new_state = state.fork()
            return step_(params, new_state, token), new_state
    else:
        def fn(params, state, token):
            return sectored_decode_step(params, cfg, state, token, k_pages,
                                        probe=probe, kernel=kernel)
    return fn, (pspec, sspec, tok_spec), state_shape


def bytes_saved_fraction(seq_len: int, topk_frac: float = TOPK_FRAC) -> float:
    """Fraction of KV bytes NOT moved at a page budget."""
    k = topk_for(seq_len, topk_frac)
    return 1.0 - k / n_pages(seq_len)
