"""LM stack (counterpart of the JAX package's ``models/model.py``), for
all ten configs: uniform attention (dense or MoE FFN), attention-free
RWKV6 and the RG-LRU / local-attention hybrid. ``init_params``,
``forward`` (the training and prefill trunk, with per-layer remat),
``lm_loss``, ``prefill``, ``init_decode_state``, ``decode_step`` and
``logits_fn``. Parameters are a nested dict of
tensors with the reference's layout: where the layers are all of one
kind (uniform attention, RWKV) per-layer tensors are stacked on a leading
``(n_layers, ...)`` axis and the reference's ``lax.scan`` over layers is
a Python loop over it; a hybrid's layers are a list of per-kind dicts.

The decode step's one body is :func:`decode_step_`, which writes the new
K/V rows, lengths, recurrent states and position into the state it is
given, so no buffer moves and a CUDA graph can capture it (a serving wave
over the session's wave buffer); the functional :func:`decode_step` runs
it on a fork.

:func:`prefill` returns the decode state the prompt leaves: K/V rows of
every attention layer and the recurrent states of every RWKV and RG-LRU
layer. (The reference's ``prefill`` builds K/V only for uniform stacks
and returns the recurrent families' states empty, so its decode after a
prefill ignores the prompt; the port keeps the states its ``forward``
computes, which equal the reference's token-by-token ``decode_step``
chain over the prompt.)

``forward``, ``lm_loss``, ``prefill`` and ``decode_step_`` take a
``tp`` (a ``parallel.tensor.TP``: the rank's place in its 'model' group
and where 'model' lands on each parameter): the parameters are the
rank's blocks of the leaves that 'model' splits on an output or
contraction dim (whole elsewhere) and each layer runs its partitioned
program (``models/layers.py``, ``attention.py``, ``moe.py``,
``rwkv.py``, ``griffin.py``). The default, ``tensor.UNSPLIT`` (one
rank, every leaf whole), runs each product as one unsplit product.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import checkpoint

from repro_torch.kernels import backend
from repro_torch.models import attention, griffin, layers, moe, rwkv
from repro_torch.parallel.tensor import UNSPLIT
from repro_torch.runtime.graphs import clone_tree, copy_tree_, leaves, map_tree


# -- parameters ----------------------------------------------------------------


def _init_attn_layer(gen, cfg, dtype, dev, lead) -> dict:
    p = dict(norm1=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
             norm2=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
             attn=attention.init_attention(gen, cfg, dtype, dev, lead=lead))
    if cfg.moe:
        p["moe"] = moe.init_moe(gen, cfg, dtype, dev, lead=lead)
    else:
        p["mlp"] = layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev,
                                      lead=lead)
    return p


def _init_rwkv_layer(gen, cfg, dtype, dev, lead) -> dict:
    return dict(
        norm1=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
        norm2=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
        tmix=rwkv.init_rwkv(gen, cfg, dtype, dev, lead=lead))


def _init_rec_layer(gen, cfg, dtype, dev, lead) -> dict:
    return dict(
        norm1=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
        norm2=torch.ones((*lead, cfg.d_model), dtype=dtype, device=dev),
        rec=griffin.init_rec(gen, cfg, dtype, dev, lead=lead),
        mlp=layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev,
                               lead=lead))


_LAYER_INIT = {"attn": _init_attn_layer, "rwkv": _init_rwkv_layer,
               "rec": _init_rec_layer}


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``None`` = the GPU). The draws differ from ``jax.random``'s; tests
    that compare with the reference bridge its parameters instead
    (``repro_torch.bridge.params_from_numpy``)."""
    dev = backend.resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kinds = cfg.layer_kinds
    params: dict[str, Any] = layers.init_embed(
        gen, cfg.vocab, cfg.d_model, dtype, dev, cfg.tie_embeddings)
    params["final_norm"] = layers.init_rms(cfg.d_model, dtype, dev)
    if cfg.uniform_layers or cfg.attn_free:  # one kind: stacked layers
        params["layers"] = _LAYER_INIT[kinds[0]](gen, cfg, dtype, dev,
                                                 (cfg.n_layers,))
    else:
        params["layers"] = [_LAYER_INIT[kind](gen, cfg, dtype, dev, ())
                            for kind in kinds]
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: its slice of the stacked tensors (views),
    or its entry of a hybrid's list."""
    if isinstance(params["layers"], list):
        return params["layers"][i]
    return map_tree(lambda t: t[i], params["layers"])


def logits_fn(params: dict, cfg, hidden: torch.Tensor,
              tp=UNSPLIT) -> torch.Tensor:
    """The logits of ``hidden``, whole (gathered over 'model' where the
    vocab is split, which is exact)."""
    return layers.unembed(params, hidden, cfg.tie_embeddings, tp)


def ffn(lp: dict, cfg, h: torch.Tensor, tp=UNSPLIT) -> torch.Tensor:
    """An attention layer's FFN: the MoE layer where ``cfg.moe``, else
    SwiGLU."""
    if cfg.moe:
        return moe.moe_ffn(lp["moe"], cfg, h, tp.at("moe"))
    return layers.swiglu(lp["mlp"], h, tp.at("mlp"))


def _attn_block(lp: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0, tp=UNSPLIT) -> torch.Tensor:
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + attention.attend(lp["attn"], cfg, h, positions, window=window,
                             tp=tp.at("attn"))
    h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + ffn(lp, cfg, h, tp)


def _rec_block(lp: dict, cfg, x: torch.Tensor, h0: torch.Tensor,
               tp=UNSPLIT):
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    y, h_last = griffin.rglru(lp["rec"], h, h0, tp.at("rec"))
    x = x + y
    h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + layers.swiglu(lp["mlp"], h, tp.at("mlp")), h_last


def _window(cfg) -> int:
    """The attention window of an attention layer: a hybrid's are local."""
    return 0 if cfg.uniform_layers else cfg.local_window


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params: dict, cfg, tokens=None, *, embeds=None,
            positions=None, remat: bool = False,
            layer_hook=None, tp=UNSPLIT) -> torch.Tensor:
    """Trunk: tokens (B, S) or embeds (B, S, D) -> final hidden states
    (B, S, D). ``remat`` recomputes each layer's activations in the
    backward pass instead of keeping them (the reference's
    ``jax.checkpoint`` of the layer body): the same ops on the same
    inputs, so the loss and every gradient keep their bits.

    ``layer_hook(i, lp) -> lp`` maps layer ``i``'s parameters before the
    layer uses them (a mesh step gathers the rank's blocks there); it runs
    inside the remat region, so a gathered layer is freed after the
    forward and gathered again for the recompute. ``None`` is the
    identity. ``tp``: see the module docstring."""
    if embeds is None:
        x = layers.embed(params, tokens, tp)
    else:
        x = embeds
    B, S = x.shape[:2]
    if positions is None:
        positions = _positions(B, S, x.device)
    x = _layers_over_prompt(params, cfg, x, positions, remat=remat,
                            layer_hook=layer_hook, tp=tp)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            remat: bool = False, layer_hook=None,
            tp=UNSPLIT) -> torch.Tensor:
    """Causal LM loss: the mean over all positions of
    ``logsumexp(logits_f32) - gold``.

    The reference takes the gold logit as a masked sum over the vocab
    (``iota == label``), so that a vocab-sharded logits tensor reduces
    shard-locally; every other term of that sum is 0, so it equals a
    ``torch.gather`` of the label's logit exactly, which spares a
    (B, S, vocab) f32 tensor here. With the vocab split, each rank
    holds its block of the logits: the log-sum-exp takes the max and the
    sum of ``exp`` over 'model' (:class:`_SplitLogSumExp`), and the gold
    logit is taken on the rank whose block holds the label and summed
    over 'model' (zeros elsewhere, so exactly)."""
    hidden = forward(params, cfg, tokens, remat=remat, layer_hook=layer_hook,
                     tp=tp)
    logits, vd = layers.split_logits(params, hidden, cfg.tie_embeddings, tp)
    logits = logits.float()
    if vd is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    logz = _SplitLogSumExp.apply(logits, tp)
    v0, v1 = tp.block(logits.shape[-1] * tp.size)
    ids = labels.long()
    mine = (ids >= v0) & (ids < v1)
    gold = torch.gather(logits, -1, torch.where(mine, ids - v0,
                                                0)[..., None])[..., 0]
    gold = tp.sum(torch.where(mine, gold, 0.0))
    return torch.mean(logz - gold)


class _SplitLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits split over 'model' (the
    rank's block ``l``): the max over every rank (its infinities taken
    as 0, as ``torch.logsumexp`` takes them), each rank's f32 sum of
    ``exp(l - max)`` summed over 'model', ``log`` of it plus the max.
    The backward is ``torch.logsumexp``'s, ``g * exp(l - result)``, on
    the rank's block."""

    @staticmethod
    def forward(ctx, logits, tp):
        mx = tp.max(torch.amax(logits, dim=-1, keepdim=True))
        mx.masked_fill_(mx.abs() == float("inf"), 0)
        s = tp.sum(torch.sum(torch.exp(logits - mx), dim=-1))
        out = torch.log(s) + mx[..., 0]
        ctx.save_for_backward(logits, out)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, out = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - out[..., None]), None


def _layer_over_prompt(lp: dict, cfg, kind: str, x: torch.Tensor,
                       positions: torch.Tensor, i: int = 0,
                       layer_hook=None, tp=UNSPLIT) -> torch.Tensor:
    """One layer of the reference's ``forward``, a recurrent one from a
    zero state."""
    if layer_hook is not None:
        lp = layer_hook(i, lp)
    tp = tp.layer(i)
    B = x.shape[0]
    if kind == "attn":
        return _attn_block(lp, cfg, x, positions, window=_window(cfg), tp=tp)
    if kind == "rec":
        return _rec_block(lp, cfg, x,
                          griffin.init_rec_state(cfg, B, x.device), tp)[0]
    return rwkv.rwkv_block(lp, cfg, x,
                           rwkv.init_state(cfg, B, x.device, x.dtype), tp,
                           keep_state=False)[0]


def _layers_over_prompt(params: dict, cfg, x: torch.Tensor,
                        positions: torch.Tensor, state=None,
                        remat: bool = False,
                        layer_hook=None, tp=UNSPLIT) -> torch.Tensor:
    """The layer stack over a whole prompt, each recurrent layer from a
    zero state (the reference's ``forward``). Without ``state``, ``remat``
    runs each layer under ``torch.utils.checkpoint`` (when autograd
    records). With ``state`` (a :class:`DecodeState` sized for the
    prompt), every layer's decode state is written into it: each
    attention layer's K/V re-projected into rows ``[:S]``, each RWKV
    block's ``(S, last_t, last_c)`` and each RG-LRU's last hidden
    state. ``layer_hook`` (without ``state``) and ``tp``: see
    :func:`forward`."""
    B, S = x.shape[:2]
    if state is None:
        remat = remat and torch.is_grad_enabled()
        for i, kind in enumerate(cfg.layer_kinds):
            lp = layer_params(params, i)
            if remat:
                x = checkpoint.checkpoint(_layer_over_prompt, lp, cfg, kind,
                                          x, positions, i, layer_hook, tp,
                                          use_reentrant=False)
            else:
                x = _layer_over_prompt(lp, cfg, kind, x, positions, i,
                                       layer_hook, tp)
        return x
    for i, kind in enumerate(cfg.layer_kinds):
        lp = layer_params(params, i)
        ltp = tp.layer(i)
        if kind == "attn":
            cache = state.layer_kv(i)
            h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
            _, k, v = attention.qkv(lp["attn"], cfg, h, positions,
                                    ltp.at("attn"))
            cache.k[:, :S] = k.to(cache.k.dtype)
            cache.v[:, :S] = v.to(cache.v.dtype)
            x = _attn_block(lp, cfg, x, positions, window=_window(cfg),
                            tp=ltp)
        elif kind == "rec":
            x, h_last = _rec_block(lp, cfg, x,
                                   griffin.init_rec_state(cfg, B, x.device),
                                   ltp)
            state.layer_rec(i).copy_(h_last)
        else:
            x, new = rwkv.rwkv_block(
                lp, cfg, x, rwkv.init_state(cfg, B, x.device, x.dtype), ltp)
            copy_tree_(state.layer_rec(i), new)
    return x


def prefill(params: dict, cfg, tokens: torch.Tensor,
            dtype=torch.bfloat16, tp=UNSPLIT):
    """Run the prompt: tokens (B, S) int -> (last-position logits
    (B, vocab), DecodeState).

    The state is ``init_decode_state(cfg, B, S, dtype)`` (caches padded to
    ``_pad_seq(S)``, a hybrid's local caches at most
    ``_pad_seq(local_window, 256)`` rows) holding what the prompt leaves
    (see :func:`_layers_over_prompt`); lengths and position are ``S``.
    One pass over the layers gives the reference's ``forward`` hidden
    states and the state together. Its shapes follow the prompt, so it
    runs eagerly. Raises ``ValueError`` for a prompt longer than a local
    cache.
    """
    B, S = tokens.shape
    state = init_decode_state(cfg, B, S, dtype, device=tokens.device)
    for cache in state.caches():
        if S > cache.k.shape[-3]:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens does not fit its "
                f"{cache.k.shape[-3]}-row local attention cache")
    x = layers.embed(params, tokens, tp)
    x = _layers_over_prompt(params, cfg, x, _positions(B, S, tokens.device),
                            state, tp=tp)
    for cache in state.caches():
        cache.length.fill_(S)
    state.position.fill_(S)
    hidden = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, hidden, tp)[:, 0, :], state


@dataclasses.dataclass
class DecodeState:
    """Per-layer decode state.

    Where the layers are all of one kind, leaves are stacked over layers
    (batch on axis 1): ``kv`` a KVCache ((L, B, S, Hkv, hd); length
    (L, B)) for uniform attention, ``rec`` the RWKV dict ((L, B, ...))
    for an attention-free stack. A hybrid holds per-layer lists (batch on
    axis 0), ``None`` at the other kind's layers: ``kv`` a KVCache per
    local-attention layer, ``rec`` an RG-LRU state (B, D) or an RWKV
    dict per recurrent layer. ``position`` (B,) is the next position.
    """

    kv: Any
    rec: Any
    position: torch.Tensor

    def _parts(self):
        """(subtree, batch axis) of kv, rec and position."""
        return ((self.kv, 0 if isinstance(self.kv, list) else 1),
                (self.rec, 0 if isinstance(self.rec, list) else 1),
                (self.position, 0))

    def _map(self, fn) -> "DecodeState":
        """A state with every tensor ``t`` replaced by ``fn(t, batch
        axis)``."""
        kv, rec, position = (map_tree(lambda t, a=a: fn(t, a), tree)
                             for tree, a in self._parts())
        return DecodeState(kv=kv, rec=rec, position=position)

    def caches(self) -> list:
        """The attention caches (one stacked KVCache, or a hybrid's
        per-layer ones)."""
        if self.kv is None:
            return []
        if isinstance(self.kv, list):
            return [c for c in self.kv if c is not None]
        return [self.kv]

    def layer_kv(self, i: int) -> attention.KVCache:
        """Layer ``i``'s cache (views into a stacked one)."""
        if isinstance(self.kv, list):
            return self.kv[i]
        return attention.KVCache(k=self.kv.k[i], v=self.kv.v[i],
                                 length=self.kv.length[i])

    def layer_rec(self, i: int):
        """Layer ``i``'s recurrent state (views into a stacked one)."""
        if isinstance(self.rec, list):
            return self.rec[i]
        return {key: t[i] for key, t in self.rec.items()}

    def clone(self) -> "DecodeState":
        return clone_tree(self)

    def fork(self) -> "DecodeState":
        """A state sharing this one's K/V buffers, with its own lengths,
        recurrent states and position: what a functional step writes
        into. The recurrent states are copies, because a step overwrites
        them; K/V can be shared because an append never rewrites a row
        the old state reads."""
        def fork_cache(c):
            if c is None:
                return None
            return attention.KVCache(k=c.k, v=c.v, length=c.length.clone())
        kv = ([fork_cache(c) for c in self.kv] if isinstance(self.kv, list)
              else fork_cache(self.kv))
        return DecodeState(kv=kv, rec=clone_tree(self.rec),
                           position=self.position.clone())

    def zeros_batch(self, n: int) -> "DecodeState":
        """An all-zero state like this one with batch (slot) axis ``n``:
        a serving wave's buffer."""
        def z(t, axis):
            shape = list(t.shape)
            shape[axis] = n
            return torch.zeros(shape, dtype=t.dtype, device=t.device)
        return self._map(z)

    def row(self, slot: int) -> "DecodeState":
        """Batch row ``slot`` as a batch-1 state (views, no copy)."""
        return self._map(lambda t, axis: t.narrow(axis, slot, 1))

    def set_row(self, slot: int, row: "DecodeState") -> None:
        """Copy batch row 0 of ``row`` into batch row ``slot``, in place
        (admission into a wave slot)."""
        pairs = [(dst, src, axis)
                 for (tree, axis), (other, _) in zip(self._parts(),
                                                     row._parts())
                 for dst, src in zip(leaves(tree), leaves(other),
                                     strict=True)]
        for dst, src, axis in pairs:
            want = dst.shape[:axis] + dst.shape[axis + 1:]
            have = src.shape[:axis] + src.shape[axis + 1:]
            if want != have:
                raise ValueError(
                    f"state of cache shape {tuple(have)} cannot join a "
                    f"wave of {tuple(want)}")
        for dst, src, axis in pairs:
            dst.select(axis, slot).copy_(src.select(axis, 0))


def _pad_seq(n: int, mult: int = 1024) -> int:
    """KV buffer length, padded as in the reference."""
    return ((n + 8 + mult - 1) // mult) * mult


def local_cache_rows(cfg, seq_len: int) -> int:
    """Rows of a hybrid's local-attention cache for a ``seq_len`` state
    (the reference's ``init_decode_state``)."""
    w = cfg.local_window or seq_len
    return min(_pad_seq(w, 256), _pad_seq(seq_len))


def init_decode_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                      device=None) -> DecodeState:
    """A zero state; ``dtype`` is that of the K/V rows and the RWKV
    token-shift rows (bf16, as in the reference)."""
    dev = backend.resolve_device(device)
    position = torch.zeros((batch,), dtype=torch.int32, device=dev)
    L = cfg.n_layers
    if cfg.attn_free:
        rec = {key: t.expand(L, *t.shape).clone()
               for key, t in rwkv.init_state(cfg, batch, dev, dtype).items()}
        return DecodeState(kv=None, rec=rec, position=position)
    if cfg.uniform_layers:
        shape = (L, batch, _pad_seq(seq_len), cfg.n_kv_heads, cfg.head_dim_)
        kv = attention.KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            length=torch.zeros((L, batch), dtype=torch.int32, device=dev))
        return DecodeState(kv=kv, rec=None, position=position)
    # hybrid: a list per layer; local-attention layers keep a bounded cache
    kv, rec = [], []
    for kind in cfg.layer_kinds:
        if kind == "attn":
            kv.append(attention.init_cache(
                cfg, batch, local_cache_rows(cfg, seq_len), dtype, dev))
            rec.append(None)
        elif kind == "rec":
            kv.append(None)
            rec.append(griffin.init_rec_state(cfg, batch, dev))
        else:
            kv.append(None)
            rec.append(rwkv.init_state(cfg, batch, dev, dtype))
    return DecodeState(kv=kv, rec=rec, position=position)


def decode_step_(params: dict, cfg, state: DecodeState,
                 token: torch.Tensor, tp=UNSPLIT) -> torch.Tensor:
    """One-token decode in place: token (B, 1) int -> logits (B, vocab).

    The new K/V rows, lengths, recurrent states and position are written
    into ``state``; no buffer of it moves and nothing syncs with the
    host, so a CUDA graph can capture the step. ``tp``: see the module
    docstring (the state is whole over 'model' and stays so; a mesh's
    decode step gathers a split one, ``train.step.gathered_state``).
    """
    x = layers.embed(params, token, tp)
    for i, kind in enumerate(cfg.layer_kinds):
        lp = layer_params(params, i)
        ltp = tp.layer(i)
        if kind == "attn":
            cache = state.layer_kv(i)
            h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
            att, cache_new = attention.decode_attend(
                lp["attn"], cfg, h, cache, window=_window(cfg),
                tp=ltp.at("attn"))
            cache.length.copy_(cache_new.length)
            x = x + att
            h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + ffn(lp, cfg, h, ltp)
        elif kind == "rec":
            h_prev = state.layer_rec(i)
            h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
            y, h_new = griffin.rglru_step(lp["rec"], h, h_prev,
                                          ltp.at("rec"))
            h_prev.copy_(h_new)
            x = x + y
            h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + layers.swiglu(lp["mlp"], h, ltp.at("mlp"))
        else:
            st = state.layer_rec(i)
            x, new = rwkv.rwkv_block(lp, cfg, x, st, ltp)
            copy_tree_(st, new)
    hidden = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.position.add_(1)
    return logits_fn(params, cfg, hidden, tp)[:, 0, :]


def decode_step(params: dict, cfg, state: DecodeState, token: torch.Tensor,
                tp=UNSPLIT):
    """token (B, 1) int -> (logits (B, vocab), new state):
    :func:`decode_step_` on ``state.fork()``. The K/V rows are appended
    in place, so ``state``'s caches take the new row; its lengths,
    recurrent states and position stay as they were. The new state
    shares its K/V buffers.
    """
    new_state = state.fork()
    return decode_step_(params, cfg, new_state, token, tp), new_state
