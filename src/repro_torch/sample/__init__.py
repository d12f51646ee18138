"""repro_torch.sample — token selection (greedy in this slice of the port).

* :mod:`repro_torch.sample.spec` — :class:`SamplerSpec`, the per-request
  selection contract (copied from the reference);
* :mod:`repro_torch.sample.kernel` — :class:`SamplerRows` (stacked
  per-slot state), greedy selection and :func:`token_logprob`.
"""

from repro_torch.sample.kernel import (MAX_STOP_TOKENS, NO_STOP, SamplerRows,
                                       greedy_select, token_logprob)
from repro_torch.sample.spec import GREEDY, SamplerSpec

__all__ = ["GREEDY", "MAX_STOP_TOKENS", "NO_STOP", "SamplerRows",
           "SamplerSpec", "greedy_select", "token_logprob"]
