"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892; unverified].
No KV cache: decode state is O(1) per layer, so long_500k runs natively and
the paper's KV-sector technique is inapplicable (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, rope="none", attn_free=True, rwkv_head_dim=64,
)
