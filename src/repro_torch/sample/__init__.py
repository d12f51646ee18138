"""repro_torch.sample — scheduler-invariant token selection (counterpart
of the JAX package's ``sample``).

* :mod:`repro_torch.sample.spec` — :class:`SamplerSpec`, the per-request
  contract (temperature / top-k / top-p / seed; T = 0 or no spec is
  greedy);
* :mod:`repro_torch.sample.rng` — :func:`token_key`, the counter-based
  threefry key of ``(seed, position)``, bitwise the reference's;
* :mod:`repro_torch.sample.kernel` — the selection kernel every wave runs
  and :class:`SamplerRows`, the stacked wave-side sampler state.
"""

from repro_torch.sample.kernel import (MAX_STOP_TOKENS, NO_STOP, SamplerRows,
                                       sample_from_logits, sample_token,
                                       select_tokens, token_logprob,
                                       token_logprobs)
from repro_torch.sample.rng import token_key
from repro_torch.sample.spec import GREEDY, SamplerSpec

__all__ = [
    "GREEDY", "MAX_STOP_TOKENS", "NO_STOP", "SamplerRows", "SamplerSpec",
    "sample_from_logits", "sample_token", "select_tokens", "token_key",
    "token_logprob", "token_logprobs",
]
