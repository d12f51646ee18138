"""Model/architecture configuration schema (counterpart of the JAX
package's ``configs/base.py``).

Every assigned architecture is expressed as a :class:`ModelConfig`; the
four LM shapes (train_4k / prefill_32k / decode_32k / long_500k) are
global. ``token_specs`` gives fake tensors (shapes and dtypes, no
storage: the port's stand-in for the reference's ``ShapeDtypeStruct``)
for the dry run; tests instantiate ``reduced()`` configs on the CPU.
``param_count`` and ``active_param_count`` give 6·N·tokens model FLOPs.
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

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + sum(self._layer_params(k) for k in self.layer_kinds)

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        hd = self.head_dim_
        n = 0
        if kind == "attn":
            n += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.moe:
                e = self.moe
                n += e.n_experts * 3 * d * e.d_expert + d * e.n_experts
                n += e.n_shared_experts * 3 * d * e.d_expert
            else:
                n += 3 * d * self.d_ff
        elif kind == "rwkv":
            n += 4 * d * d + 2 * d * self.d_ff
        elif kind == "rec":
            n += 2 * d * d + 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, e = self.d_model, self.moe
        dense = self.param_count() - self.n_layers * e.n_experts * 3 * d * e.d_expert
        active = self.n_layers * (e.top_k + e.n_shared_experts) * 3 * d * e.d_expert
        return dense + active

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def fake(shape, dtype, device="cpu"):
    """A fake tensor of ``shape`` and ``dtype`` (no storage)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device=device)


def token_specs(shape: ShapeConfig):
    """Fake tensors for a training/prefill batch."""
    import torch
    B, S = shape.global_batch, shape.seq_len
    return dict(tokens=fake((B, S), torch.int32),
                labels=fake((B, S), torch.int32))
