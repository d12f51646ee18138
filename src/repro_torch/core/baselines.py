"""DRAM architecture configurations: Sectored DRAM + every comparison point
the paper evaluates (Table 1, §7.4, §8.4, §9).

Each :class:`DRAMArch` describes how a fetch/writeback *sector mask* maps to
DRAM operations: how many sectors are activated (=> ACT energy and tFAW
token cost), how many beats the data burst carries (=> bus occupancy and
RD/WR energy), whether the transfer is serialized through one MAT (FGA) or
one chip (sub-ranked DGMS), and how much command-bus time a request needs.

Counterpart of the JAX package's ``core/baselines.py``; numpy only, on the
port's float32-exact power model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import power, predictor
from repro_torch.core.sectors import NUM_SECTORS
from repro_torch.core.timing import DEFAULT_TIMING


def popcount_np(mask: np.ndarray) -> np.ndarray:
    m = mask.astype(np.uint32)
    m = m - ((m >> 1) & 0x55555555)
    m = (m & 0x33333333) + ((m >> 2) & 0x33333333)
    m = (m + (m >> 4)) & 0x0F0F0F0F
    return ((m * 0x01010101) >> 24).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DRAMArch:
    """A DRAM substrate + its memory-controller fetch policy."""

    name: str
    policy: predictor.FetchPolicy
    sectored_hw: bool = False  # sector latches present (0.26% ACT overhead)
    act_sectors_read: int = 0  # 0 = popcount of the fetch mask
    act_sectors_write: int = 0  # 0 = popcount of the writeback mask
    beats_read: int = 0  # 0 = popcount (VBL); else fixed
    beats_write: int = 0
    burst_mult: int = 1  # DGMS: transfer serialized 8x on a sub-rank lane
    col_serial: int = 1  # FGA: column accesses serialized through one MAT
    relax_faw: bool = True  # sectored/half activations cost fewer tokens
    subranked: bool = False  # DGMS: 8 data lanes, command-bus heavy
    cmd_slots: int = 2  # command-bus slots per request

    # ------------------------------------------------------------------
    def act_sectors(self, mask: np.ndarray, is_write: np.ndarray) -> np.ndarray:
        pc = popcount_np(mask)
        s_rd = np.full_like(pc, self.act_sectors_read) if self.act_sectors_read else pc
        s_wr = np.full_like(pc, self.act_sectors_write) if self.act_sectors_write else pc
        return np.where(is_write, s_wr, s_rd)

    def beats(self, mask: np.ndarray, is_write: np.ndarray) -> np.ndarray:
        pc = popcount_np(mask)
        b_rd = np.full_like(pc, self.beats_read) if self.beats_read else pc
        b_wr = np.full_like(pc, self.beats_write) if self.beats_write else pc
        return np.where(is_write, b_wr, b_rd)

    def faw_cost(self, act_sectors: np.ndarray) -> np.ndarray:
        """ACT power-time reservation (1/16-ns units): a full-row ACT costs
        tFAW/4; a sectored ACT costs act_array_fraction(s) of that (§4.1)."""
        full = DEFAULT_TIMING.tFAW / 4.0 * 16.0
        if not self.relax_faw:
            return np.full(act_sectors.shape, int(round(full)), np.int32)
        frac = np.asarray(power.act_array_fraction(act_sectors))
        return np.round(frac * full).astype(np.int32)

    def request_fields(self, mask: np.ndarray, is_write: np.ndarray,
                       block: np.ndarray | None = None):
        """Vectorized per-request DRAM fields for the timing simulator.

        Returns dict with act_sectors, beats, bus_ps, cmd_ps, lane, faw_cost,
        e_act_nj, e_col_nj, data_bytes.
        """
        t = DEFAULT_TIMING
        acts = self.act_sectors(mask, is_write)
        beats = self.beats(mask, is_write)
        beat_u = int(round(t.tCK / 2.0 * 16))  # 1/16-ns units (dram.UNITS_PER_NS)
        bus_u = (beats.astype(np.int32) * beat_u * self.burst_mult).astype(np.int32)
        cmd_u = np.full(mask.shape, self.cmd_slots * int(round(t.tCK * 16)),
                        np.int32)
        if self.subranked and block is not None:
            lane = (block % 8).astype(np.int32)
        else:
            lane = np.zeros(mask.shape, np.int32)
        e_model = power.DRAMEnergyModel(t)
        e_act = np.asarray(
            e_model.act_energy(acts, sectored_hw=self.sectored_hw)
        ).astype(np.float32) * 1e9
        e_rd = np.asarray(e_model.rd_energy(beats)).astype(np.float32) * 1e9
        e_wr = np.asarray(e_model.wr_energy(beats)).astype(np.float32) * 1e9
        e_col = np.where(is_write, e_wr, e_rd)
        col_serial_u = np.full(
            mask.shape, (self.col_serial - 1) * int(round(t.tCCD * 16)),
            np.int32,
        )
        return dict(
            act_sectors=acts,
            beats=beats,
            bus_u=bus_u,
            col_serial_u=col_serial_u,
            cmd_u=cmd_u,
            lane=lane,
            faw_cost=self.faw_cost(acts).astype(np.int32),
            e_act_nj=e_act,
            e_col_nj=e_col.astype(np.float32),
            data_bytes=beats.astype(np.float64) * 8.0,
        )


# --- the evaluated systems ----------------------------------------------------

#: Conventional coarse-grained DDR4 (the paper's baseline system).
BASELINE = DRAMArch(
    "baseline", predictor.BASELINE,
    act_sectors_read=NUM_SECTORS, act_sectors_write=NUM_SECTORS,
    beats_read=NUM_SECTORS, beats_write=NUM_SECTORS, relax_faw=False,
)

#: Sectored DRAM, default LA128-SP512 configuration (the paper's system).
SECTORED = DRAMArch("sectored", predictor.LA128_SP512, sectored_hw=True)

#: Sectored DRAM hardware driven by other §7.2 fetch policies.
SECTORED_BASIC = DRAMArch("sectored-basic", predictor.BASIC, sectored_hw=True)
SECTORED_LA16 = DRAMArch("sectored-LA16", predictor.LA16, sectored_hw=True)
SECTORED_LA128 = DRAMArch("sectored-LA128", predictor.LA128, sectored_hw=True)
SECTORED_LA2048 = DRAMArch("sectored-LA2048", predictor.LA2048, sectored_hw=True)
SECTORED_SP512 = DRAMArch("sectored-SP512", predictor.SP512, sectored_hw=True)

#: Fine-Grained Activation [40] / SBA [27]: whole block from ONE MAT -- one
#: sector activated, but the transfer drains through that single MAT's
#: helper flip-flops at 1/8 rate, occupying the channel 8x ("FGA and SBA...
#: reduce the throughput of data transfers", §3.1).
FGA = DRAMArch(
    "fga", predictor.BASELINE, sectored_hw=True,
    act_sectors_read=1, act_sectors_write=1,
    beats_read=NUM_SECTORS, beats_write=NUM_SECTORS, burst_mult=8,
)

#: Partial Row Activation [20]: fine-grained *writes* only; reads remain
#: fully coarse (whole row, whole block).
PRA = DRAMArch(
    "pra", predictor.PRA_POLICY, sectored_hw=True,
    act_sectors_read=NUM_SECTORS, act_sectors_write=0,  # 0 => dirty popcount
    beats_read=NUM_SECTORS, beats_write=0,
)

#: HalfDRAM [39] / HalfPage [26]: half-row activation, full-block transfer at
#: full rate (mirrored CSL / doubled HFFs), no sector misses.
HALFDRAM = DRAMArch(
    "halfdram", predictor.BASELINE, sectored_hw=True,
    act_sectors_read=4, act_sectors_write=4,
    beats_read=NUM_SECTORS, beats_write=NUM_SECTORS,
)
HALFPAGE = dataclasses.replace(HALFDRAM, name="halfpage")

#: Burst chop only (§8.4): half-block transfer granularity, NO Sectored
#: Activation (full-row ACTs, no tFAW relief), standard DRAM chips.
BURST_CHOP = DRAMArch(
    "burst-chop", predictor.CHOP_LA128_SP512,
    act_sectors_read=NUM_SECTORS, act_sectors_write=NUM_SECTORS,
    relax_faw=False,
)

#: Sub-ranked DIMM (DGMS [19], 1x ABUS): whole block from one chip over its
#: 8-bit slice (8x serialized on that lane; 8 lanes run in parallel) with
#: doubled command-bus occupancy per command -- the command bus becomes the
#: bottleneck (§9).
DGMS = DRAMArch(
    "dgms", predictor.BASELINE, sectored_hw=False,
    act_sectors_read=1, act_sectors_write=1,
    beats_read=NUM_SECTORS, beats_write=NUM_SECTORS, burst_mult=8,
    subranked=True, cmd_slots=6,
)

ALL_ARCHS = {a.name: a for a in [
    BASELINE, SECTORED, SECTORED_BASIC, SECTORED_LA16, SECTORED_LA128,
    SECTORED_LA2048, SECTORED_SP512, FGA, PRA, HALFDRAM, HALFPAGE,
    BURST_CHOP, DGMS,
]}
