"""DDR4 timing model + Sectored DRAM's tFAW relaxation (paper §2.4, §4.1);
counterpart of the JAX package's ``core/timing.py``.

All times are in nanoseconds. Values follow the paper's Table 2 system
configuration: DDR4, 1600 MHz bus, 1 channel, 4 ranks, 16 banks/rank,
tRCD/tRAS/tRC/tFAW = 13.75/35.00/48.75/25 ns.

The tFAW relaxation is modeled as a *power token bucket* per rank: the DDR4
spec's "at most 4 ACTs in any tFAW window" is equivalently a budget that
replenishes at 4 row-activations' worth of charge per tFAW. A sectored ACT
draws only ``act_array_fraction(s)`` of a full row activation's array
power (§7.1 / Fig. 9), so it costs proportionally fewer tokens.

The reference computes the array functions in float32 with Python floats
as weakly typed operands (each constant rounded to float32, each
operation rounded to float32). Here every constant and intermediate is an
explicit ``np.float32``, in the same order, so the results equal the
reference's bit for bit whatever NumPy's promotion rules are.
"""

from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class DDR4Timing:
    """DDR4-1600 timing parameters (ns), per paper Table 2 / JEDEC DDR4.

    DDR4-1600 (1600 MT/s, 800 MHz clock): tCK = 1.25 ns, so a full 8-beat
    burst occupies 5 ns and one channel moves at most 12.8 GB/s.
    """

    tCK: float = 1.25  # bus clock period (800 MHz clock, 1600 MT/s)
    tRCD: float = 13.75  # ACT -> column command
    tRAS: float = 35.00  # ACT -> PRE to the same bank
    tRC: float = 48.75  # ACT -> ACT same bank (tRAS + tRP)
    tRP: float = 13.75  # PRE -> ACT
    tCL: float = 13.75  # READ -> first data beat (CAS latency, 11 cycles)
    tCWL: float = 12.50  # WRITE -> first data beat
    tFAW: float = 25.0  # four-activate window per rank
    tRRD: float = 2.5  # ACT -> ACT same rank (tRRD_S; bank-group interleaved)
    tCCD: float = 5.0  # column command -> column command (tCCD_L, 8 tCK)
    tWR: float = 15.0  # write recovery before PRE
    tRTP: float = 7.5  # READ -> PRE
    tREFI: float = 7800.0  # refresh interval
    tRFC: float = 350.0  # refresh cycle time
    faw_acts: int = 4  # ACTs allowed per tFAW window (full-row activations)
    # Burst absorption of the tFAW reservation model, in full-row-ACT units:
    # 4.0 = pure token bucket, 1.0 = sliding-window-conservative.
    faw_burst_acts: float = 1.0

    def burst_time(self, beats) -> np.ndarray:
        """Data-bus occupancy (float32) for a burst of ``beats`` DDR beats:
        a full cache block is 8 beats == 5 ns at DDR4-1600."""
        return np.asarray(beats, f32) * f32(self.tCK / 2.0)

    @property
    def full_burst_time(self) -> float:
        return 8 * self.tCK / 2.0  # 5 ns


DEFAULT_TIMING = DDR4Timing()


# --- tFAW power token bucket -------------------------------------------------

def faw_token_rate(t: DDR4Timing) -> float:
    """Token replenish rate: 4 full-row ACT tokens per tFAW window."""
    return t.faw_acts / t.tFAW


def faw_act_cost(act_array_fraction) -> np.ndarray:
    """Tokens an ACT consumes (float32): 1.0 for a full-row ACT, the
    fraction of full-row array power it draws for a sectored one."""
    return np.asarray(act_array_fraction, f32)


def faw_wait(tokens, now, last_refill, cost, t: DDR4Timing):
    """Earliest time >= now the bucket affords ``cost`` tokens, in float32.

    Returns (act_time, tokens_after, refill_time_after). Bucket capacity is
    ``faw_acts`` tokens.
    """
    tokens, now, last_refill, cost = (np.asarray(x, f32) for x in
                                      (tokens, now, last_refill, cost))
    rate = f32(faw_token_rate(t))
    cap = f32(t.faw_acts)
    avail = np.minimum(cap, tokens + (now - last_refill) * rate)
    deficit = np.maximum(cost - avail, f32(0.0))
    act_time = now + deficit / rate
    tokens_after = np.minimum(
        cap, tokens + (act_time - last_refill) * rate) - cost
    return act_time, tokens_after, act_time
