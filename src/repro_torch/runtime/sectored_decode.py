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
  reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import backend, quantized_kv, sectored_attention
from repro_torch.models import attention, layers, model
from repro_torch.runtime import sector_predictor
from repro_torch.runtime.graphs import Step, leaves
from repro_torch.serve.backend import ServingBackend
from repro_torch.telemetry.meters import KVGeometry

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


def init_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> SectoredState:
    model._check_supported(cfg)
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


def sectored_attend(attn_params, cfg, x, cache: attention.KVCache, table_l,
                    k_pages: int, probe: bool = False,
                    kernel: str = "dispatch"):
    """One-token decode attention over predictor-selected KV sectors.

    x: (B, 1, D). Returns (out, new_cache, new_table_l); the new K/V row is
    written into ``cache`` in place.

    ``probe=True`` widens the selection by one round-robin probe page
    (``sector_predictor.probe_page_for``) so unfetched pages' scores stay
    honest. ``kernel`` selects how the selected pages are read and
    attended (see the module docstring).
    """
    B = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    rep = cfg.n_heads // hkv
    q, k_new, v_new = attention.qkv(attn_params, cfg, x, cache.length[:, None])
    probe_page = None
    select_k = k_pages
    if probe:
        probe_page = sector_predictor.probe_page_for(cache.length, PAGE_SIZE)
        select_k = k_pages + 1

    attention.append_kv(cache, k_new, v_new)
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

    qg = q[:, 0].reshape(B, hkv, rep, hd)
    kp = k.view(B, -1, PAGE_SIZE, hkv, hd)
    vp = v.view(B, -1, PAGE_SIZE, hkv, hd)
    if kernel == "dispatch":
        # gather the selected pages, then attend; with every valid page
        # selected (exact mode) the gathered buffer is the dense cache
        # prefix in ascending page order
        k_sel = sectored_attention.gather_pages(kp, pages)
        v_sel = sectored_attention.gather_pages(vp, pages)
        tok_pos = (pages[..., None].long() * PAGE_SIZE
                   + torch.arange(PAGE_SIZE, device=x.device))
        valid = tok_pos <= cache.length[:, None, None, None]
        out, mass = sectored_attention.attend_pages(qg, k_sel, v_sel, valid)
    elif kernel in ("fused", "fused_q8"):
        qg = qg.contiguous()
        length = cache.length + 1  # the kernel's count convention
        if kernel == "fused_q8":
            kq, k_scale = quantized_kv.quantize_pages(kp)
            vq, v_scale = quantized_kv.quantize_pages(vp)
            out, mass = sectored_attention.sectored_attention_paged(
                qg, kq, vq, page_idx, length, k_scale=k_scale,
                v_scale=v_scale)
        else:
            out, mass = sectored_attention.sectored_attention_paged(
                qg, kp, vp, page_idx, length)
    else:
        raise ValueError(f"kernel must be one of {KERNELS}; got {kernel!r}")

    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads, hd)
    out = attention.out_project(out, attn_params["wo"])
    new_table = sector_predictor.update(table_l, pages, mass)
    new_cache = attention.KVCache(k=k, v=v, length=cache.length + 1)
    return out, new_cache, new_table


def sectored_decode_step_(params, cfg, state: SectoredState, token,
                          k_pages: int, probe: bool = False,
                          kernel: str = "dispatch") -> torch.Tensor:
    """Full-model one-token decode with sectored attention per layer, in
    place: token (B, 1) int -> logits (B, vocab).

    The new K/V rows, lengths, table and position are written into
    ``state``; no buffer of it moves and nothing syncs with the host, so a
    CUDA graph can capture the step.
    """
    model._check_supported(cfg)
    x = layers.embed(params, token)
    for i in range(cfg.n_layers):
        lp = model.layer_params(params, i)
        cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i],
                                  length=state.kv.length[i])
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        att, cache_new, table_new = sectored_attend(
            lp["attn"], cfg, h, cache, state.table[i], k_pages, probe=probe,
            kernel=kernel)
        state.kv.length[i].copy_(cache_new.length)
        state.table[i].copy_(table_new)
        x = x + att
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.swiglu(lp["mlp"], h)
    hidden = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.position.add_(1)
    return model.logits_fn(params, cfg, hidden)[:, 0, :]


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
        model._check_supported(cfg)
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
        self._k_cache: dict[int, Step] = {}
        # batch -> (static state, captured exact step) of the prefill
        self._prefill_graphs: dict[int, tuple] = {}
        exact_fn = self._step_for(self.pages)
        super().__init__(self._prefill, exact_fn,
                         self._step_for(self.k_for(topk_frac)),
                         or_merge_demands, vocab=cfg.vocab)

    def _step_for(self, k_pages: int) -> Step:
        fn = self._k_cache.get(k_pages)
        if fn is None:
            cfg, params = self.cfg, self.params
            probe = self.probe_pages_for(k_pages) > 0
            kernel = self.kernel if 0 < k_pages < self.pages else "dispatch"

            def step_(state, token):
                return sectored_decode_step_(params, cfg, state, token,
                                             k_pages, probe=probe,
                                             kernel=kernel)
            fn = Step(step_, graphs=self.graphs, pool=self.pool)
            fn.k_pages = k_pages
            fn.kernel = kernel
            self._k_cache[k_pages] = fn
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
            state.zero_()
        else:
            state = init_state(self.cfg, batch, self.seq_len,
                               device=self.device)
            step = exact.step_
        logits = None
        for i in range(tokens.shape[1]):
            logits = step(state, tokens[:, i:i + 1])
        if self.graphs:
            return logits.clone(), state.clone()
        return logits, state


def make_serving_fns(cfg, *, params, seq_len: int,
                     topk_frac: float = TOPK_FRAC, min_topk: int = MIN_TOPK,
                     kernel: str = "dispatch", device=None,
                     graphs: bool = True) -> SectoredKVBackend:
    """Build the SectoredState serving backend."""
    return SectoredKVBackend(cfg, params, seq_len=seq_len,
                             topk_frac=topk_frac, min_topk=min_topk,
                             kernel=kernel, device=device, graphs=graphs)


def bytes_saved_fraction(seq_len: int, topk_frac: float = TOPK_FRAC) -> float:
    """Fraction of KV bytes NOT moved at a page budget."""
    k = topk_for(seq_len, topk_frac)
    return 1.0 - k / n_pages(seq_len)
