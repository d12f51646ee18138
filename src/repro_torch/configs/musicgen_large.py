"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: input_specs provides
precomputed frame embeddings (backbone-only per the assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, rope="standard", frontend="audio",
)
