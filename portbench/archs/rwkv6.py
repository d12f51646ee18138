"""RWKV6 (Finch) as the program states it: attention-free, an O(1)
recurrent state a slot; served on the dense path."""

from __future__ import annotations

import torch

from portbench.reference.rwkv6 import forward  # noqa: F401


def shapes(c: dict) -> dict:
    """The sizes the yardstick and the reference read, from the
    configuration file's keys alone."""
    d = c["hidden_size"]
    return dict(arch="rwkv6", layers=c["num_hidden_layers"], d=d,
                heads=d // c["head_size"], head_dim=c["head_size"],
                ffn=c["intermediate_size"], vocab=c["vocab_size"],
                eps=c["layer_norm_epsilon"], tied=c["tie_word_embeddings"])


def layout(s: dict) -> dict:
    """``{path: (shape, scale | ("const", value, dtype))}`` in the order
    the program's initialiser inserts the leaves (``weights.make``)."""
    L, d, V, f = s["layers"], s["d"], s["vocab"], s["ffn"]
    out = {("embedding",): ((V, d), 0.02)}
    if not s["tied"]:
        out[("lm_head",)] = ((V, d), 0.02)
    out[("final_norm",)] = ((d,), ("const", 1.0, None))
    norm = ((L, d), ("const", 1.0, None))
    out[("layers", "norm1")] = norm
    out[("layers", "norm2")] = norm
    t = ("layers", "tmix")
    for name in ("wr", "wk", "wv", "wg", "wo"):
        out[t + (name,)] = ((L, d, d), d ** -0.5)
    out[t + ("w_decay",)] = ((L, d, d), d ** -0.5 * 0.1)
    out[t + ("decay_bias",)] = ((L, d), ("const", -2.0, torch.float32))
    out[t + ("u",)] = ((L, s["heads"], s["head_dim"]),
                       ("const", 0.0, torch.float32))
    out[t + ("mix",)] = ((L, 5, d), ("const", 0.5, torch.float32))
    out[t + ("ck",)] = ((L, d, f), d ** -0.5)
    out[t + ("cv",)] = ((L, f, d), f ** -0.5)
    return out


def matmul_params(s: dict) -> int:
    """Parameters a token's decode multiplies by: every layer's six time
    mix and two channel mix projections, and the output head."""
    d = s["d"]
    return s["layers"] * (6 * d * d + 2 * d * s["ffn"]) + s["vocab"] * d


def decode_flops(s: dict, attended_tokens: int) -> float:
    """Model FLOPs of one token's decode step: 2 per parameter it
    multiplies by, plus the recurrence (its read-out and its state
    update, 2·hd² each per head, in every layer); there is no attention,
    so ``attended_tokens`` does not count."""
    return 2 * matmul_params(s) + 4 * s["d"] * s["head_dim"] * s["layers"]


def program_config(c: dict):
    """The program's ``ModelConfig`` for the configuration's keys."""
    from repro_torch.configs.base import ModelConfig

    heads = c["hidden_size"] // c["head_size"]
    return ModelConfig(
        name=c["name"], family="ssm", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=heads, n_kv_heads=heads,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], rope="none",
        attn_free=True, rwkv_head_dim=c["head_size"],
        norm_eps=c["layer_norm_epsilon"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"])
