"""Deterministic, shardable, checkpointable synthetic LM data pipeline
(counterpart of the JAX package's ``data/pipeline.py``).

Every (step, host_shard) pair maps to tokens purely functionally — a
numpy generator seeded from (seed, step, shard) — so any host can
regenerate any shard, a restart from a checkpoint resumes exactly (the
state is the step counter), and a retry sees the same batch. The token
stream is a Zipf-ish mixture with a copied window in every row, so the
LM loss decreases. The numpy half is the reference's, copied; only the
batch's device differs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


@dataclasses.dataclass
class PipelineState:
    step: int = 0


def _tokens_for(cfg: DataConfig, step: int, shard: int, n_shards: int,
                rows: int) -> np.ndarray:
    """Rows of this shard for this step (numpy, host-side)."""
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 4096 + shard)
    # zipf-ish unigram over vocab with short-range repetition structure
    base = rng.zipf(1.3, size=(rows, cfg.seq_len)).astype(np.int64)
    toks = (base - 1) % cfg.vocab
    # inject copy structure: each row repeats a window to give the LM signal
    w = cfg.seq_len // 4
    if w > 1:
        toks[:, 2 * w:3 * w] = toks[:, :w]
    return toks.astype(np.int32)


def batch_for(cfg: DataConfig, state: PipelineState, shard: int = 0,
              n_shards: int = 1, device=None) -> dict:
    """The (tokens, labels) shard for this step as int32 tensors on
    ``device`` (``None`` = the GPU). labels = next token (the last
    position wraps to the row's first token, as in the reference)."""
    dev = resolve_device(device)
    rows = cfg.global_batch // n_shards
    toks = _tokens_for(cfg, state.step, shard, n_shards, rows)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
    return dict(tokens=torch.from_numpy(toks).to(dev),
                labels=torch.from_numpy(labels).to(dev))


def advance(state: PipelineState) -> PipelineState:
    return PipelineState(step=state.step + 1)
