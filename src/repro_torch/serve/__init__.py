"""repro_torch.serve — the serving stack of the port.

``ServeSession`` (session.py) composes a backend (backend.py: the data
path and the fused greedy wave), a scheduler (scheduler.py: FIFO
admission) and a sector policy (policy.py: sectored on/off and page
budget). See each module for what this slice of the port covers.
"""

from repro_torch.serve.backend import (ServingBackend, fused_select_step,
                                       make_fused_wave)
from repro_torch.serve.policy import (AdaptiveSectorPolicy, AlwaysDense,
                                      AlwaysSectored, HysteresisPolicy,
                                      PathDecision, SectorPolicy)
from repro_torch.serve.scheduler import FifoScheduler, Scheduler
from repro_torch.serve.session import (Request, ServeSession, StreamHandle,
                                       StreamTruncated)

__all__ = [
    "AdaptiveSectorPolicy", "AlwaysDense", "AlwaysSectored",
    "FifoScheduler", "HysteresisPolicy", "PathDecision", "Request", "Scheduler", "SectorPolicy", "ServeSession",
    "ServingBackend", "StreamHandle", "StreamTruncated", "fused_select_step",
    "make_fused_wave",
]
