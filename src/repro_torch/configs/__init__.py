"""Architecture registry: ``get(name)`` returns the exact assigned config."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: F401

from repro_torch.configs.musicgen_large import CONFIG as musicgen_large
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.qwen3_32b import CONFIG as qwen3_32b
from repro_torch.configs.yi_6b import CONFIG as yi_6b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.kimi_k2 import CONFIG as kimi_k2
from repro_torch.configs.qwen3_moe_235b import CONFIG as qwen3_moe_235b
from repro_torch.configs.rwkv6_1b6 import CONFIG as rwkv6_1b6
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    musicgen_large, chatglm3_6b, qwen3_32b, yi_6b, qwen2_72b, qwen2_vl_72b,
    kimi_k2, qwen3_moe_235b, rwkv6_1b6, recurrentgemma_2b,
]}
assert len(ARCHS) == 10


def get(name: str) -> ModelConfig:
    return ARCHS[name]
