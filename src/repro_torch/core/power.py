"""DRAM power/energy model for Sectored DRAM (paper §6.2, §7.1 / Fig. 9);
counterpart of the JAX package's ``core/power.py``.

An analytical component model with two calibration anchors taken from the
paper's Fig. 9:

* 1-sector activation consumes 66.5% less *DRAM array* power than 8-sector
  activation, but only 12.7% less *overall* ACT power, because periphery
  dominates: ``array(s) = alpha + beta*s`` with array(8)=1, array(1)=0.335
  gives alpha=0.24, beta=0.095; the overall anchor gives an array share of
  19.1% of total ACT power.
* 1-sector READ (WRITE) draws 70.0% (70.6%) less module power than
  8-sector: ``rd(s) = gamma + (1-gamma) * s/8`` with rd(1)=0.30 gives
  gamma_rd=0.20 (gamma_wr=0.1931).

Absolute energy scale comes from DDR4 x8 4Gb IDD figures, 8 chips per
rank, VDD=1.2V. These are model outputs, not measurements of any device.

The array functions compute in float32 exactly as the reference does
(each Python constant rounded to float32, each operation rounded to
float32, in the reference's order), with every operand cast explicitly so
that NumPy's promotion rules never widen an intermediate to float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sectors import BLOCK_BYTES, NUM_SECTORS
from repro_torch.core.timing import DEFAULT_TIMING, DDR4Timing

f32 = np.float32

VDD = 1.2  # volts
CHIPS_PER_RANK = 8

# IDD current figures (amps) for a DDR4-1600 x8 4Gb device.
IDD0 = 55e-3  # one-bank ACT-PRE cycling
IDD2N = 34e-3  # precharge standby
IDD3N = 44e-3  # active standby
IDD4R = 140e-3  # burst read
IDD4W = 130e-3  # burst write
IDD5B = 190e-3  # burst refresh

# --- Fig. 9 calibration constants -------------------------------------------
ACT_ARRAY_ALPHA = 0.24  # sector-count-independent array cost (MWL, decoder)
ACT_ARRAY_BETA = 0.095  # per-sector array cost (LWL drive + sense amps)
ACT_ARRAY_SHARE = 0.191  # array share of total ACT power (rest = periphery)
ACT_SECTOR_LOGIC_OVERHEAD = 0.0026  # +0.26% ACT power from latches/transistors
RD_FIXED_SHARE = 0.20  # burst-length-independent share of READ power
WR_FIXED_SHARE = 0.1931  # burst-length-independent share of WRITE power


def act_array_fraction(num_sectors) -> np.ndarray:
    """DRAM-array activation power for ``num_sectors`` enabled sectors,
    normalized to a full-row (8-sector) activation. Also the tFAW token
    cost (timing.faw_act_cost)."""
    s = np.asarray(num_sectors, f32)
    return f32(ACT_ARRAY_ALPHA) + f32(ACT_ARRAY_BETA) * s


def act_power_fraction(num_sectors, sectored_hw: bool = True) -> np.ndarray:
    """Total ACT power vs. baseline full-row ACT (array + periphery), incl.
    the +0.26% sector latch/transistor switching overhead when the Sectored
    DRAM hardware is present."""
    frac = (f32(1.0 - ACT_ARRAY_SHARE)
            + f32(ACT_ARRAY_SHARE) * act_array_fraction(num_sectors))
    if sectored_hw:
        frac = frac + f32(ACT_SECTOR_LOGIC_OVERHEAD)
    return frac


def rd_power_fraction(num_beats) -> np.ndarray:
    """READ burst power vs. a full 8-beat burst."""
    b = np.asarray(num_beats, f32)
    return (f32(RD_FIXED_SHARE)
            + f32(1.0 - RD_FIXED_SHARE) * b / f32(NUM_SECTORS))


def wr_power_fraction(num_beats) -> np.ndarray:
    b = np.asarray(num_beats, f32)
    return (f32(WR_FIXED_SHARE)
            + f32(1.0 - WR_FIXED_SHARE) * b / f32(NUM_SECTORS))


@dataclasses.dataclass(frozen=True)
class DRAMEnergyModel:
    """Per-operation energies (joules) for one rank of 8 chips."""

    timing: DDR4Timing = DEFAULT_TIMING

    @property
    def e_act_full(self) -> float:
        """Full-row ACT+PRE pair energy: (IDD0 - IDD3N) * tRC * VDD * chips."""
        return (IDD0 - IDD3N) * self.timing.tRC * 1e-9 * VDD * CHIPS_PER_RANK

    @property
    def e_rd_full(self) -> float:
        """Full 8-beat READ burst: (IDD4R - IDD3N) * tBURST * VDD * chips."""
        return (
            (IDD4R - IDD3N) * self.timing.full_burst_time * 1e-9 * VDD * CHIPS_PER_RANK
        )

    @property
    def e_wr_full(self) -> float:
        return (
            (IDD4W - IDD3N) * self.timing.full_burst_time * 1e-9 * VDD * CHIPS_PER_RANK
        )

    @property
    def p_background_active(self) -> float:
        """Active standby power per rank (watts)."""
        return IDD3N * VDD * CHIPS_PER_RANK

    @property
    def p_background_precharged(self) -> float:
        return IDD2N * VDD * CHIPS_PER_RANK

    @property
    def p_refresh(self) -> float:
        """Average refresh power per rank: energy per REF spread over tREFI."""
        e_ref = (IDD5B - IDD2N) * self.timing.tRFC * 1e-9 * VDD * CHIPS_PER_RANK
        return e_ref / (self.timing.tREFI * 1e-9)

    # --- sector-aware per-op energies (float32, as the reference) -----------

    def act_energy(self, num_sectors, sectored_hw: bool = True) -> np.ndarray:
        return f32(self.e_act_full) * act_power_fraction(num_sectors,
                                                         sectored_hw)

    def rd_energy(self, num_beats) -> np.ndarray:
        """READ energy for a VBL burst of ``num_beats`` beats (Fig. 9's
        per-operation power fraction applied to the full-burst energy)."""
        return f32(self.e_rd_full) * rd_power_fraction(num_beats)

    def wr_energy(self, num_beats) -> np.ndarray:
        return f32(self.e_wr_full) * wr_power_fraction(num_beats)


DEFAULT_ENERGY = DRAMEnergyModel()


# --- KV-fetch energy mapping (serving telemetry, Fig. 9 anchors) -------------
#
# KV pages play the paper's *sectors*: one DRAM row holds ``NUM_SECTORS``
# consecutive pages, and a decode step that fetches K of a sequence's P
# valid pages is a Sectored-Activation row access that enables only K
# local-wordline groups. Data movement is charged per 64-byte block at the
# full-burst energy; the ACT component carries the Fig. 9 nonlinearity.

FULL_BURST_BEATS = 8  # DDR4 BL8: beats per full burst; BLOCK_BYTES==8B x 8


def kv_fetch_energy(pages_fetched: float, pages_valid: float, *,
                    page_bytes: float, sectored_hw: bool = True,
                    word_fraction: float = 1.0,
                    model: DRAMEnergyModel = DEFAULT_ENERGY) -> dict[str, float]:
    """Energy (joules) to read ``pages_fetched`` of ``pages_valid`` KV pages.

    Page counts may be fractional: the newest, partially-filled page moves
    only the bytes written so far, but still costs a whole enabled sector
    on the ACT side. ``word_fraction`` is the fraction of a full-width KV
    word each fetched beat carries (1.0 for bf16, 0.5 for per-sector int8
    KV): each block's burst shortens to ``FULL_BURST_BEATS *
    word_fraction`` beats. ``sectored_hw=False`` models the coarse-grained
    baseline: full-row activations, every valid page moved
    (``pages_fetched`` is ignored).

    Returns ``{"act_j", "rd_j", "acts", "sectors"}``.
    """
    if pages_valid <= 0:
        return dict(act_j=0.0, rd_j=0.0, acts=0, sectors=0.0)
    valid_sectors = int(np.ceil(pages_valid))
    rows_valid = (valid_sectors + NUM_SECTORS - 1) // NUM_SECTORS
    blocks_per_page = page_bytes / BLOCK_BYTES
    rd_beats = FULL_BURST_BEATS * float(word_fraction)
    if not sectored_hw:
        act_j = rows_valid * float(model.act_energy(NUM_SECTORS,
                                                    sectored_hw=False))
        rd_j = pages_valid * blocks_per_page * float(model.rd_energy(rd_beats))
        return dict(act_j=act_j, rd_j=rd_j, acts=rows_valid,
                    sectors=float(rows_valid * NUM_SECTORS))
    fetched_sectors = min(int(np.ceil(pages_fetched)), valid_sectors)
    if fetched_sectors <= 0:
        return dict(act_j=0.0, rd_j=0.0, acts=0, sectors=0.0)
    # fetched sectors spread over the valid rows; ACT energy is affine in
    # enabled sectors, so only the (acts, total sectors) pair matters
    acts = min(rows_valid, fetched_sectors)
    act_j = acts * float(model.act_energy(fetched_sectors / acts))
    rd_j = min(float(pages_fetched), float(pages_valid)) * blocks_per_page \
        * float(model.rd_energy(rd_beats))
    return dict(act_j=act_j, rd_j=rd_j, acts=acts,
                sectors=float(fetched_sectors))


def kv_append_energy(token_bytes: float, *,
                     model: DRAMEnergyModel = DEFAULT_ENERGY) -> float:
    """WRITE energy (joules) for appending one token's K+V to the cache;
    identical on every path."""
    return token_bytes / BLOCK_BYTES * float(model.wr_energy(FULL_BURST_BEATS))


# --- processor power model (paper §6.2) --------------------------------------

PROC_DYNAMIC_W = 101.7  # 8-core dynamic power at IPC=4 (McPAT, Table 2)
PROC_STATIC_W = 32.0
PROC_REF_CORES = 8
# CACTI-modeled adders for Sectored DRAM's processor-side structures (§7.5)
SECTOR_PROC_STATIC_FRACTION = 0.0122
SECTOR_PREDICTOR_DYNAMIC_W = 0.35  # per 8 cores, SHT lookups/updates


def processor_power(ipc, n_cores: int, sectored: bool = False) -> np.ndarray:
    """IPC-based processor power model (float32): (IPC/4) * dynamic +
    static, scaled from the 8-core reference configuration."""
    scale = n_cores / PROC_REF_CORES
    dyn = (np.asarray(ipc, f32) / f32(4.0)) * f32(PROC_DYNAMIC_W) * f32(scale)
    sta = PROC_STATIC_W * scale
    if sectored:
        sta = sta * (1.0 + SECTOR_PROC_STATIC_FRACTION)
        dyn = dyn + f32(SECTOR_PREDICTOR_DYNAMIC_W * scale)
    return dyn + f32(sta)
