"""Model/architecture configuration schema (counterpart of the JAX
package's ``configs/base.py``).

Every assigned architecture is expressed as a :class:`ModelConfig`; tests
instantiate ``reduced()`` configs on the CPU. The reference's
``token_specs``, input shapes and parameter counts (for its dry run and
roofline tools) wait for the port's tooling slice.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
RopeKind = Literal["none", "standard", "rope2d", "mrope"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN width
    n_shared_experts: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    rope: RopeKind = "standard"
    qk_norm: bool = False
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    # attention-free / hybrid structure
    attn_free: bool = False  # rwkv6: no attention at all
    layer_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn") cycle
    local_window: int = 0  # sliding-window size for local attention layers
    rwkv_head_dim: int = 64
    # frontend stubs ([audio]/[vlm]): inputs arrive as precomputed embeddings
    frontend: Literal["none", "audio", "vision"] = "none"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # §Perf: flash-style blocked attention (no S^2 materialization)
    blocked_attention: bool = False
    # §Perf: sectored decode shares page selection across kv heads
    sector_share_heads: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kinds, length n_layers."""
        if self.attn_free:
            return ("rwkv",) * self.n_layers
        if self.layer_pattern:
            reps = (self.n_layers + len(self.layer_pattern) - 1) // len(self.layer_pattern)
            return (self.layer_pattern * reps)[: self.n_layers]
        return ("attn",) * self.n_layers

    @property
    def uniform_layers(self) -> bool:
        return len(set(self.layer_kinds)) == 1 and self.layer_kinds[0] in ("attn",)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.layer_pattern else len(self.layer_pattern) or 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=256,
            vocab=256,
            head_dim=32,
            local_window=min(self.local_window, 32) if self.local_window else 0,
        )
        if self.layer_pattern:
            kw["n_layers"] = len(self.layer_pattern)
        if self.moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2,
                                  d_expert=64,
                                  n_shared_experts=self.moe.n_shared_experts)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)
