"""A llama-style decoder (yi-6b): RMSNorm, grouped-query attention with
RoPE, SwiGLU; served on the sectored path."""

from __future__ import annotations

from portbench.reference.llama import forward  # noqa: F401


def shapes(c: dict) -> dict:
    """The sizes the yardstick and the reference read, from the
    configuration file's keys alone."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    return dict(arch="llama", layers=c["num_hidden_layers"], d=d, heads=h,
                kv_heads=c["num_key_value_heads"], head_dim=d // h,
                ffn=c["intermediate_size"], vocab=c["vocab_size"],
                eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
                tied=c["tie_word_embeddings"])


def layout(s: dict) -> dict:
    """``{path: (shape, scale | ("const", value, dtype))}`` in the order
    the program's initialiser inserts the leaves (``weights.make``)."""
    L, d, V, f = s["layers"], s["d"], s["vocab"], s["ffn"]
    h, g, hd = s["heads"], s["kv_heads"], s["head_dim"]
    out = {("embedding",): ((V, d), 0.02)}
    if not s["tied"]:
        out[("lm_head",)] = ((V, d), 0.02)
    out[("final_norm",)] = ((d,), ("const", 1.0, None))
    norm = ((L, d), ("const", 1.0, None))
    out[("layers", "norm1")] = norm
    out[("layers", "norm2")] = norm
    a = ("layers", "attn")
    out[a + ("wq",)] = ((L, d, h, hd), d ** -0.5)
    out[a + ("wk",)] = ((L, d, g, hd), d ** -0.5)
    out[a + ("wv",)] = ((L, d, g, hd), d ** -0.5)
    out[a + ("wo",)] = ((L, h, hd, d), d ** -0.5)
    m = ("layers", "mlp")
    out[m + ("w_gate",)] = ((L, d, f), d ** -0.5)
    out[m + ("w_up",)] = ((L, d, f), d ** -0.5)
    out[m + ("w_down",)] = ((L, f, d), f ** -0.5)
    return out


def matmul_params(s: dict) -> int:
    """Parameters a token's decode multiplies by: every layer's
    projections and the output head (the embedding is a lookup)."""
    d, f, hd, h, g = s["d"], s["ffn"], s["head_dim"], s["heads"], \
        s["kv_heads"]
    layer = d * hd * (h + 2 * g) + h * hd * d + 3 * d * f
    return s["layers"] * layer + s["vocab"] * d


def decode_flops(s: dict, attended_tokens: int) -> float:
    """Model FLOPs of one token's decode step: 2 per parameter it
    multiplies by, plus attention's two products over the tokens it
    reads in every layer (``attended_tokens``)."""
    return 2 * matmul_params(s) + 4 * s["heads"] * s["head_dim"] \
        * attended_tokens * s["layers"]


def program_config(c: dict):
    """The program's ``ModelConfig`` for the configuration's keys."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], rope="standard", norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"], dtype=c["torch_dtype"])
