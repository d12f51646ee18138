"""SamplerSpec: one request's token-selection contract.

The spec is *data*, not code: a frozen record of (temperature, top-k,
top-p, seed) that travels ``Request -> ServeSession.submit() ->`` the
wave's stacked :class:`~repro_torch.sample.kernel.SamplerRows` the same way a
:class:`~repro_torch.serve.policy.PathDecision` travels policy -> wave config.
Keeping the spec declarative is what lets every execution flavor —
looped reference, pre-fused vectorized, fused single-device, fused mesh
wave — consume the *same* per-slot scalars and therefore produce the
same tokens (the scheduler-invariance oracle).

``temperature == 0`` means greedy (first-max argmax), bit-identical to
the pre-sampling serving stack; ``Request.sampler is None`` is the same
thing spelled implicitly, so every legacy call site keeps its exact
token streams.

Counterpart of the JAX package's ``sample/spec.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Declarative token-selection parameters for one request.

    ``temperature`` — softmax temperature; ``0.0`` selects the greedy
    (argmax) path exactly. ``top_k`` — keep only the ``k`` highest
    logits before sampling (``0`` disables). ``top_p`` — nucleus
    truncation: keep the smallest descending-probability prefix whose
    mass reaches ``p`` (``1.0`` disables). ``seed`` — the request's RNG
    identity; together with the token position it fully determines every
    draw (:mod:`repro_torch.sample.rng`).

    Filters compose in the conventional order temperature -> top-k ->
    top-p (top-p mass is computed on the already-top-k-filtered
    distribution).
    """

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] (1.0 = off), got {self.top_p}")
        if not 0 <= int(self.seed) < 2**32:
            raise ValueError(f"seed must fit uint32, got {self.seed}")

    @property
    def is_greedy(self) -> bool:
        """True when this spec degenerates to argmax selection."""
        return self.temperature == 0.0

    @classmethod
    def greedy(cls) -> "SamplerSpec":
        """The explicit spelling of the default (argmax) selection."""
        return cls(temperature=0.0)

    def describe(self) -> str:
        """Compact human-readable form for provenance columns."""
        if self.is_greedy:
            return "greedy"
        parts = [f"T={self.temperature:g}"]
        if self.top_k:
            parts.append(f"k={self.top_k}")
        if self.top_p < 1.0:
            parts.append(f"p={self.top_p:g}")
        parts.append(f"seed={self.seed}")
        return "/".join(parts)


#: shared greedy instance (rows built for requests without a sampler)
GREEDY = SamplerSpec.greedy()
