"""Performance metrics (paper §6.3): parallel speedup, weighted speedup,
MPKI accounting, and energy aggregation (counterpart of the JAX package's
``core/metrics.py``; numpy only, as there)."""

from __future__ import annotations

import numpy as np


def parallel_speedup(baseline_single_runtime_ps: float,
                     multicore_runtime_ps: np.ndarray) -> float:
    """Baseline single-core execution time / multi-core execution time.

    The multi-core run finishes when its slowest core finishes.
    """
    return float(baseline_single_runtime_ps) / float(np.max(multicore_runtime_ps))


def weighted_speedup(shared_ipc: np.ndarray, alone_ipc: np.ndarray) -> float:
    """Sum_i IPC_i(shared) / IPC_i(alone) [Snavely & Tullsen]."""
    return float(np.sum(np.asarray(shared_ipc) / np.asarray(alone_ipc)))


def llc_mpki(n_misses: int, n_instructions: int) -> float:
    return 1000.0 * n_misses / max(n_instructions, 1)


def dram_energy_per_token(joules: float, tokens: int) -> float:
    """DRAM joules per generated token — the serving-side Fig. 9 metric.

    A run that produced no tokens has no meaningful per-token energy;
    report 0.0 rather than dividing by zero (callers compare J/token
    across policies, and an empty run should never win or lose)."""
    if tokens <= 0:
        return 0.0
    return float(joules) / int(tokens)


def aggregate_energy_per_token(joules_seq, tokens_seq) -> float:
    """Token-weighted aggregate of per-run (joules, tokens) pairs.

    ``sum(J_i) / sum(n_i)`` — NOT the mean of per-run J/token, which would
    overweight short runs. Guards the all-empty case like
    :func:`dram_energy_per_token`.
    """
    joules = [float(j) for j in joules_seq]
    tokens = [int(t) for t in tokens_seq]
    if len(joules) != len(tokens):
        raise ValueError(f"mismatched runs: {len(joules)} energy values for "
                         f"{len(tokens)} token counts")
    return dram_energy_per_token(sum(joules), sum(tokens))
