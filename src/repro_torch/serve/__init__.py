"""repro_torch.serve — the serving stack of the port (counterpart of the
JAX package's ``serve``).

* :mod:`repro_torch.serve.backend` — the data path (prefill, dense and
  sectored decode, demand merge) and the fused / pre-fused waves;
* :mod:`repro_torch.serve.scheduler` — ``FifoScheduler`` and
  ``OverlapScheduler`` (prefill overlapped with the in-flight wave,
  paged-KV admission);
* :mod:`repro_torch.serve.policy` — sectored on/off and the page budget;
* :mod:`repro_torch.serve.pool` — ``KVPagePool``, the KV capacity model
  behind admission gating and preemption;
* :mod:`repro_torch.serve.prefix` — ``PrefixCache``, cross-request
  prefix sharing with warm suffix prefill;
* :mod:`repro_torch.serve.session` — ``ServeSession``, the facade
  composing them; :mod:`repro_torch.serve.engine` — the legacy
  ``Engine`` / ``LoopedEngine`` shims over it;
* :mod:`repro_torch.serve.mesh_backend` — ``MeshBackend``, the session's
  waves over a ``torch.distributed`` device mesh (slots over 'data',
  sectored KV pages over 'model', prefill on a donor rank).
"""

from repro_torch.sample import SamplerSpec
from repro_torch.serve.backend import (ServingBackend, fused_select_step,
                                       make_fused_wave, make_prefused_wave)
from repro_torch.serve.engine import Engine, EngineConfig, LoopedEngine
from repro_torch.serve.mesh_backend import MeshBackend
from repro_torch.serve.policy import (AdaptiveSectorPolicy, AlwaysDense,
                                      AlwaysSectored, HysteresisPolicy,
                                      PathDecision, SectorPolicy)
from repro_torch.serve.pool import KVPagePool
from repro_torch.serve.prefix import CacheEntry, PrefixCache, PrefixLease
from repro_torch.serve.scheduler import (FifoScheduler, OverlapScheduler,
                                         Scheduler)
from repro_torch.serve.session import (PrefillGroup, Request, ServeSession,
                                       StreamHandle, StreamTruncated,
                                       make_session, stacked_row_signature,
                                       state_signature)

__all__ = [
    "ServingBackend", "fused_select_step", "make_fused_wave",
    "make_prefused_wave",
    "Engine", "EngineConfig", "LoopedEngine", "MeshBackend",
    "AdaptiveSectorPolicy", "AlwaysDense", "AlwaysSectored",
    "HysteresisPolicy", "PathDecision", "SectorPolicy",
    "CacheEntry", "PrefixCache", "PrefixLease",
    "FifoScheduler", "KVPagePool", "OverlapScheduler", "Scheduler",
    "PrefillGroup", "Request", "SamplerSpec", "ServeSession",
    "StreamHandle", "StreamTruncated", "make_session", "state_signature",
    "stacked_row_signature",
]
