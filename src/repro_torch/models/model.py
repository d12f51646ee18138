"""LM stack (counterpart of the JAX package's ``models/model.py``).

This slice of the port covers configs whose layers are all attention
(``cfg.uniform_layers``): ``init_params``, ``forward`` (the prefill
trunk), ``prefill``, ``init_decode_state``, ``decode_step`` and
``logits_fn``. Parameters are a nested dict of tensors with the
reference's layout; per-layer tensors are stacked on a leading
``(n_layers, ...)`` axis, and the reference's ``lax.scan`` over layers is
a Python loop over that axis.

The decode step's one body is :func:`decode_step_`, which writes the new
K/V rows, lengths and position into the state it is given, so no buffer
moves and a CUDA graph can capture it (a serving wave over the session's
wave buffer); the functional :func:`decode_step` runs it on a fork.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import backend
from repro_torch.models import attention, layers

LATER = ("the MoE, RWKV and recurrent (hybrid) families are a later slice "
         "of the port")


def _check_supported(cfg) -> None:
    if cfg.moe or cfg.attn_free or not cfg.uniform_layers:
        raise NotImplementedError(f"{cfg.name}: {LATER}")


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``None`` = the GPU). The draws differ from ``jax.random``'s; tests
    that compare with the reference bridge its parameters instead
    (``repro_torch.bridge.params_from_numpy``)."""
    _check_supported(cfg)
    dev = backend.resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L = (cfg.n_layers,)
    params: dict[str, Any] = layers.init_embed(
        gen, cfg.vocab, cfg.d_model, dtype, dev, cfg.tie_embeddings)
    params["final_norm"] = layers.init_rms(cfg.d_model, dtype, dev)
    params["layers"] = dict(
        norm1=torch.ones((*L, cfg.d_model), dtype=dtype, device=dev),
        norm2=torch.ones((*L, cfg.d_model), dtype=dtype, device=dev),
        attn=attention.init_attention(gen, cfg, dtype, dev, lead=L),
        mlp=layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, dev,
                               lead=L),
    )
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer parameters (views)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    return layers.unembed(params, hidden, cfg.tie_embeddings)


def _attn_block(lp: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + attention.attend(lp["attn"], cfg, h, positions, window=window)
    h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + layers.swiglu(lp["mlp"], h)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(params: dict, cfg, tokens=None, *, embeds=None,
            positions=None) -> torch.Tensor:
    """Trunk: tokens (B, S) or embeds (B, S, D) -> final hidden states
    (B, S, D), the reference's uniform-attention branch."""
    _check_supported(cfg)
    x = layers.embed(params, tokens) if embeds is None else embeds
    B, S = x.shape[:2]
    if positions is None:
        positions = _positions(B, S, x.device)
    for i in range(cfg.n_layers):
        x = _attn_block(layer_params(params, i), cfg, x, positions)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps)


def prefill(params: dict, cfg, tokens: torch.Tensor):
    """Run the prompt: tokens (B, S) int -> (last-position logits
    (B, vocab), DecodeState).

    The state is ``init_decode_state(cfg, B, S)`` (the cache padded to
    ``_pad_seq(S)``) with each layer's K/V re-projected into ``[:, :S]``,
    as the reference builds it; lengths and position are ``S``. One pass
    over the layers gives the reference's ``forward`` hidden states and
    the cache together. Its shapes follow the prompt, so it runs eagerly.
    """
    _check_supported(cfg)
    B, S = tokens.shape
    state = init_decode_state(cfg, B, S, device=tokens.device)
    x = layers.embed(params, tokens)
    positions = _positions(B, S, tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        _, k, v = attention.qkv(lp["attn"], cfg, h, positions)
        state.kv.k[i, :, :S] = k.to(state.kv.k.dtype)
        state.kv.v[i, :, :S] = v.to(state.kv.v.dtype)
        x = _attn_block(lp, cfg, x, positions)
    state.kv.length.fill_(S)
    state.position.fill_(S)
    hidden = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_fn(params, cfg, hidden)[:, 0, :], state


@dataclasses.dataclass
class DecodeState:
    """Decode state of a uniform-attention stack: kv is a KVCache whose
    leaves are stacked over layers ((L, B, S, Hkv, hd); length (L, B))."""

    kv: attention.KVCache
    position: torch.Tensor  # (B,) next position

    def clone(self) -> "DecodeState":
        return DecodeState(
            kv=attention.KVCache(k=self.kv.k.clone(), v=self.kv.v.clone(),
                                 length=self.kv.length.clone()),
            position=self.position.clone())

    def fork(self) -> "DecodeState":
        """A state sharing this one's K/V buffers, with its own lengths
        and position: what a functional step writes into."""
        return DecodeState(
            kv=attention.KVCache(k=self.kv.k, v=self.kv.v,
                                 length=self.kv.length.clone()),
            position=self.position.clone())

    def zeros_batch(self, n: int) -> "DecodeState":
        """An all-zero state like this one with batch (slot) axis ``n``:
        a serving wave's buffer."""
        def z(t, axis):
            shape = list(t.shape)
            shape[axis] = n
            return torch.zeros(shape, dtype=t.dtype, device=t.device)
        return DecodeState(
            kv=attention.KVCache(k=z(self.kv.k, 1), v=z(self.kv.v, 1),
                                 length=z(self.kv.length, 1)),
            position=z(self.position, 0))

    def set_row(self, slot: int, row: "DecodeState") -> None:
        """Copy batch row 0 of ``row`` into batch row ``slot``, in place
        (admission into a wave slot)."""
        if row.kv.k.shape[2:] != self.kv.k.shape[2:]:
            raise ValueError(
                f"state of cache shape {tuple(row.kv.k.shape[2:])} cannot "
                f"join a wave of {tuple(self.kv.k.shape[2:])}")
        self.kv.k[:, slot] = row.kv.k[:, 0]
        self.kv.v[:, slot] = row.kv.v[:, 0]
        self.kv.length[:, slot] = row.kv.length[:, 0]
        self.position[slot] = row.position[0]


def _pad_seq(n: int, mult: int = 1024) -> int:
    """KV buffer length, padded as in the reference."""
    return ((n + 8 + mult - 1) // mult) * mult


def init_decode_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                      device=None) -> DecodeState:
    _check_supported(cfg)
    dev = backend.resolve_device(device)
    S = _pad_seq(seq_len)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim_)
    kv = attention.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((cfg.n_layers, batch), dtype=torch.int32,
                           device=dev))
    return DecodeState(kv=kv, position=torch.zeros((batch,), dtype=torch.int32,
                                                   device=dev))


def decode_step_(params: dict, cfg, state: DecodeState,
                 token: torch.Tensor) -> torch.Tensor:
    """One-token decode in place: token (B, 1) int -> logits (B, vocab).

    The new K/V rows, lengths and position are written into ``state``; no
    buffer of it moves and nothing syncs with the host, so a CUDA graph
    can capture the step.
    """
    _check_supported(cfg)
    x = layers.embed(params, token)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i],
                                  length=state.kv.length[i])
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        att, cache_new = attention.decode_attend(lp["attn"], cfg, h, cache)
        state.kv.length[i].copy_(cache_new.length)
        x = x + att
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.swiglu(lp["mlp"], h)
    hidden = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.position.add_(1)
    return logits_fn(params, cfg, hidden)[:, 0, :]


def decode_step(params: dict, cfg, state: DecodeState, token: torch.Tensor):
    """token (B, 1) int -> (logits (B, vocab), new state):
    :func:`decode_step_` on ``state.fork()``. The K/V rows are appended
    in place, so ``state`` is consumed; the new state shares its K/V
    buffers.
    """
    new_state = state.fork()
    return decode_step_(params, cfg, new_state, token), new_state
