"""LM stack for decode (counterpart of the JAX package's ``models/model.py``).

This slice of the port covers configs whose layers are all attention
(``cfg.uniform_layers``): ``init_params``, ``init_decode_state``,
``decode_step`` and ``logits_fn``. Parameters are a nested dict of
tensors with the reference's layout; per-layer tensors are stacked on a
leading ``(n_layers, ...)`` axis, and the reference's ``lax.scan`` over
layers is a Python loop over that axis.
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


@dataclasses.dataclass
class DecodeState:
    """Decode state of a uniform-attention stack: kv is a KVCache whose
    leaves are stacked over layers ((L, B, S, Hkv, hd); length (L, B))."""

    kv: attention.KVCache
    position: torch.Tensor  # (B,) next position


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


def decode_step(params: dict, cfg, state: DecodeState, token: torch.Tensor):
    """token (B, 1) int -> (logits (B, vocab), new state).

    The K/V rows are appended in place: ``state`` is consumed.
    """
    _check_supported(cfg)
    x = layers.embed(params, token)
    lengths = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        cache = attention.KVCache(k=state.kv.k[i], v=state.kv.v[i],
                                  length=state.kv.length[i])
        h = layers.rms_norm(x, lp["norm1"], cfg.norm_eps)
        att, cache_new = attention.decode_attend(lp["attn"], cfg, h, cache)
        lengths.append(cache_new.length)
        x = x + att
        h = layers.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + layers.swiglu(lp["mlp"], h)
    hidden = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, hidden)[:, 0, :]
    kv = attention.KVCache(k=state.kv.k, v=state.kv.v,
                           length=torch.stack(lengths))
    return logits, DecodeState(kv=kv, position=state.position + 1)
