"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]. d_ff=2048 is the per-expert width; one
shared expert per layer (DeepSeek-V3-style)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, rope="standard", head_dim=128,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1),
)
