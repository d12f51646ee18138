"""Synthetic workload trace generation for the Sectored DRAM simulator;
counterpart of the JAX package's ``data/traces.py`` (numpy only, as there).

The paper evaluates 41 workloads (SPEC2006/2017 + DAMOV, Table 3) via
SimPoint traces of 100M instructions. Those traces are not redistributable,
so we model each workload as a *profile* — (LLC MPKI, row-buffer locality,
intra-block word-usage distribution, word-reuse distance distribution,
per-PC pattern stability, write fraction, core CPI) — and generate block
*episodes* from it.

An **episode** is one baseline LLC miss: a cache block enters the hierarchy,
some of its 8 words are referenced during residency (at given instruction
distances from the episode-opening access), dirty words are written back at
eviction. Episodes are exactly the granularity at which the paper's
mechanisms act (the Sector Predictor is trained on L1 residencies, LSQ
Lookahead on instruction distances), so fidelity lives where the claims are.

Calibration anchors from the paper:
  * Table 3 MPKI classes (>=10 high / 1-10 medium / <=1 low),
  * ~45% of coarse-grained traffic is unused words (Fig. 3),
  * basic sectored fetch raises LLC MPKI ~3.08x (Fig. 10),
  * LA16/128/2048 cut the extra misses by 39/65/83%, LA128+SP512 by 82%,
  * 16-core high-MPKI row-hit rate ~18%; libquantum ~62% (§7.3).

Each trace's generator is seeded from the profile's name through
:func:`name_salt`, a CRC-32 of the name. The reference salts it with
``hash(name)``, which Python randomizes per process for a ``str`` unless
``PYTHONHASHSEED`` is set, so its traces change from process to process;
every other draw here is the reference's, in its order, on one generator.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.sectors import NUM_SECTORS

# DRAM geometry (paper Table 2): 1 channel, 4 ranks, 16 banks/rank,
# 32K rows/bank, 8KB rows => 128 blocks/row. Address mapping
# Row-Bank-Rank-Column-Channel (MSB -> LSB).
BLOCKS_PER_ROW = 128
RANKS = 4
BANKS_PER_RANK = 16
NUM_BANKS = RANKS * BANKS_PER_RANK
ROWS_PER_BANK = 32 * 1024


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    suite: str  # spec2006 | spec2017 | damov
    mpki: float  # baseline LLC misses per kilo-instruction
    row_hit: float  # probability an episode continues a sequential run
    words_mean: float  # mean words used per block (1..8)
    words_spread: float  # dispersion of per-PC popcounts
    pattern_stability: float  # P(episode mask == its PC's signature mask)
    p_near: float  # fraction of word reuses in the tight (LSQ-visible) regime
    near_scale: float  # mean instr distance, near regime
    far_scale: float  # mean instr distance, far regime
    write_frac: float  # fraction of used words that are stored to
    cpi_core: float  # non-memory CPI of the core
    n_pcs: int = 96  # distinct miss PCs

    @property
    def mpki_class(self) -> str:
        if self.mpki >= 10:
            return "high"
        if self.mpki > 1:
            return "medium"
        return "low"


def _p(name, suite, mpki, row_hit, wm, ws, stab, pnear, near, far, wf, cpi, n_pcs=96):
    return WorkloadProfile(name, suite, mpki, row_hit, wm, ws, stab, pnear,
                           near, far, wf, cpi, n_pcs)


# --- the paper's 41 workloads (Table 3), profiled ----------------------------
# Parameters follow each workload's published character: graph/pointer codes
# (ligra*, mcf, hashjoin) = irregular, low row locality, few words used;
# streaming FP (lbm, bwaves, libquantum, GemsFDTD) = sequential, most words
# used; low-MPKI integer codes barely touch DRAM.

WORKLOADS: dict[str, WorkloadProfile] = {w.name: w for w in [
    # ---- high MPKI (>=10) ----
    _p("ligraPageRank", "damov", 16.0, 0.14, 2.8, 0.8, 0.93, 0.42, 14, 3750, 0.18, 1.3, 128),
    _p("mcf-2006", "spec2006", 14.0, 0.18, 2.9, 1.0, 0.86, 0.40, 16, 4500, 0.22, 1.5),
    _p("libquantum-2006", "spec2006", 11.0, 0.62, 7.8, 0.4, 0.95, 0.70, 10, 1000, 0.30, 1.0),
    _p("gobmk-2006", "spec2006", 10.0, 0.30, 3.4, 1.2, 0.78, 0.45, 20, 3000, 0.25, 1.4),
    _p("ligraMIS", "damov", 14.0, 0.16, 2.8, 0.9, 0.91, 0.42, 15, 4000, 0.20, 1.3, 128),
    _p("GemsFDTD-2006", "spec2006", 11.0, 0.45, 7.4, 0.7, 0.95, 0.60, 12, 1500, 0.33, 1.1),
    _p("bwaves-2006", "spec2006", 11.5, 0.50, 7.6, 0.6, 0.95, 0.62, 11, 1250, 0.28, 1.1),
    _p("lbm-2006", "spec2006", 12.0, 0.52, 7.8, 0.5, 0.95, 0.65, 10, 1125, 0.45, 1.1),
    _p("lbm-2017", "spec2017", 12.0, 0.52, 7.8, 0.5, 0.95, 0.65, 10, 1125, 0.45, 1.1),
    _p("hashjoinPR", "damov", 13.0, 0.15, 2.7, 0.7, 0.95, 0.38, 18, 5000, 0.15, 1.3, 160),
    # ---- medium MPKI (1-10) ----
    _p("omnetpp-2006", "spec2006", 7.0, 0.25, 1.8, 1.1, 0.80, 0.44, 22, 3500, 0.24, 1.2),
    _p("gcc-2017", "spec2017", 4.5, 0.30, 2.2, 1.3, 0.76, 0.48, 24, 3250, 0.26, 1.1),
    _p("mcf-2017", "spec2017", 9.0, 0.20, 1.6, 1.0, 0.84, 0.42, 18, 4250, 0.22, 1.1),
    _p("cactusADM-2006", "spec2006", 5.0, 0.42, 3.5, 0.9, 0.95, 0.55, 14, 1750, 0.32, 0.9),
    _p("zeusmp-2006", "spec2006", 4.8, 0.45, 3.6, 0.8, 0.95, 0.57, 13, 1625, 0.30, 0.9),
    _p("xalancbmk-2006", "spec2006", 2.4, 0.28, 1.9, 1.2, 0.77, 0.46, 24, 3250, 0.22, 1.2),
    _p("ligraKCore", "damov", 8.5, 0.18, 1.4, 0.9, 0.90, 0.41, 16, 4000, 0.19, 0.9, 128),
    _p("astar-2006", "spec2006", 3.2, 0.26, 1.9, 1.1, 0.79, 0.45, 22, 3500, 0.24, 1.1),
    _p("cactus-2017", "spec2017", 4.6, 0.42, 3.5, 0.9, 0.95, 0.55, 14, 1750, 0.32, 0.9),
    _p("parest-2017", "spec2017", 3.8, 0.38, 3.1, 1.0, 0.92, 0.52, 16, 2000, 0.28, 1.0),
    _p("ligraComponents", "damov", 9.5, 0.17, 1.4, 0.9, 0.91, 0.41, 16, 4000, 0.20, 0.9, 128),
    # ---- low MPKI (<=1) ----
    _p("splash2Ocean", "damov", 0.9, 0.40, 3.3, 1.0, 0.94, 0.55, 14, 1750, 0.30, 0.9),
    _p("tonto-2006", "spec2006", 0.3, 0.35, 2.7, 1.2, 0.86, 0.52, 18, 2250, 0.28, 1.0),
    _p("xz-2017", "spec2017", 0.9, 0.30, 2.3, 1.2, 0.82, 0.48, 20, 2750, 0.26, 1.0),
    _p("wrf-2006", "spec2006", 0.8, 0.42, 3.4, 0.9, 0.95, 0.56, 14, 1750, 0.30, 0.9),
    _p("bzip2-2006", "spec2006", 0.7, 0.32, 2.4, 1.2, 0.83, 0.50, 20, 2500, 0.27, 1.0),
    _p("xalancbmk-2017", "spec2017", 0.9, 0.28, 1.9, 1.2, 0.78, 0.46, 24, 3250, 0.22, 1.2),
    _p("h264ref-2006", "spec2006", 0.4, 0.45, 3.5, 0.9, 0.95, 0.58, 13, 1625, 0.29, 0.9),
    _p("hmmer-2006", "spec2006", 0.2, 0.40, 3.2, 1.0, 0.93, 0.55, 15, 1875, 0.28, 0.9),
    _p("namd-2017", "spec2017", 0.2, 0.42, 3.3, 1.0, 0.94, 0.55, 14, 1750, 0.26, 0.9),
    _p("blender-2017", "spec2017", 0.6, 0.35, 2.8, 1.1, 0.87, 0.52, 18, 2250, 0.27, 1.0),
    _p("sjeng-2006", "spec2006", 0.4, 0.28, 2.0, 1.2, 0.79, 0.46, 22, 3000, 0.24, 1.1),
    _p("perlbench-2006", "spec2006", 0.5, 0.30, 2.2, 1.2, 0.81, 0.48, 21, 2750, 0.26, 1.1),
    _p("x264-2017", "spec2017", 0.3, 0.45, 3.5, 0.9, 0.95, 0.57, 13, 1625, 0.30, 0.9),
    _p("deepsjeng-2017", "spec2017", 0.5, 0.28, 2.0, 1.2, 0.79, 0.46, 22, 3000, 0.24, 1.1),
    _p("gromacs-2006", "spec2006", 0.3, 0.40, 3.1, 1.0, 0.92, 0.54, 15, 1875, 0.28, 0.9),
    _p("gcc-2006", "spec2006", 0.8, 0.30, 2.2, 1.3, 0.76, 0.48, 24, 3250, 0.26, 1.1),
    _p("imagick-2017", "spec2017", 0.2, 0.48, 3.7, 0.8, 0.95, 0.60, 12, 1500, 0.30, 0.9),
    _p("leela-2017", "spec2017", 0.3, 0.28, 2.0, 1.2, 0.78, 0.46, 23, 3125, 0.24, 1.1),
    _p("povray-2006", "spec2006", 0.1, 0.38, 2.9, 1.0, 0.90, 0.53, 17, 2125, 0.27, 1.0),
    _p("calculix-2006", "spec2006", 0.2, 0.40, 3.1, 1.0, 0.92, 0.54, 15, 1875, 0.28, 0.9),
]}

assert len(WORKLOADS) == 41, len(WORKLOADS)

HIGH_MPKI = [w for w in WORKLOADS.values() if w.mpki_class == "high"]
MEDIUM_MPKI = [w for w in WORKLOADS.values() if w.mpki_class == "medium"]
LOW_MPKI = [w for w in WORKLOADS.values() if w.mpki_class == "low"]
assert (len(HIGH_MPKI), len(MEDIUM_MPKI), len(LOW_MPKI)) == (10, 11, 20)


def name_salt(name: str) -> int:
    """A profile's seed salt: stable across processes and hosts."""
    return zlib.crc32(name.encode()) % 2**31


@dataclasses.dataclass
class EpisodeTrace:
    """Vectorized episode stream for one core (arrays of length E)."""

    profile: WorkloadProfile
    n_instructions: int
    pc: np.ndarray  # (E,) int32 miss-PC id
    first_word: np.ndarray  # (E,) int32 offset of the episode-opening access
    used_mask: np.ndarray  # (E,) uint16 words referenced during residency
    dirty_mask: np.ndarray  # (E,) uint16 words stored to
    dist: np.ndarray  # (E, 8) int32 instr distance of each word's first use
    instr_pos: np.ndarray  # (E,) int64 instruction index of episode start
    bank: np.ndarray  # (E,) int32 DRAM bank (rank folded in)
    row: np.ndarray  # (E,) int32 DRAM row
    block: np.ndarray  # (E,) int64 global block id (for sub-rank lanes)
    dep: np.ndarray  # (E,) bool: miss address depends on the previous miss

    @property
    def n_episodes(self) -> int:
        return len(self.pc)


def generate_trace(profile: WorkloadProfile, n_episodes: int, seed: int = 0) -> EpisodeTrace:
    """Generate an episode stream for ``profile``.

    Word-usage: each miss PC owns a signature mask whose popcount is drawn
    around ``words_mean``; an episode uses the signature with prob
    ``pattern_stability``, otherwise a fresh mask (same popcount law) — this
    is what makes the Sector Predictor's accuracy workload-dependent.

    Reuse distances: two-regime mixture (near ~ LSQ-visible tight loops, far
    ~ later reuse during cache residency) — this is what differentiates
    LA16/LA128/LA2048 exactly as in Fig. 10.
    """
    rng = np.random.default_rng(seed * 7919 + name_salt(profile.name))
    E = int(n_episodes)

    # --- which words are used --------------------------------------------
    def draw_popcounts(n):
        pops = rng.normal(profile.words_mean, profile.words_spread, size=n)
        return np.clip(np.round(pops), 1, NUM_SECTORS).astype(np.int32)

    def masks_with_popcount(pops, contiguous_frac=0.6):
        """Random masks with given popcounts; a fraction are contiguous runs
        (struct fields / streaming), the rest scattered. Vectorized."""
        n = len(pops)
        contig = rng.random(n) < contiguous_frac
        starts = np.minimum(rng.integers(0, NUM_SECTORS, size=n),
                            NUM_SECTORS - pops)
        contig_masks = (((1 << pops.astype(np.int64)) - 1) << starts)
        # scattered: select exactly p positions = the p smallest of 8 uniforms
        r = rng.random((n, NUM_SECTORS))
        thresh = np.sort(r, axis=1)[np.arange(n), pops - 1][:, None]
        sel = r <= thresh
        scat_masks = (sel << np.arange(NUM_SECTORS)).sum(axis=1)
        return np.where(contig, contig_masks, scat_masks).astype(np.uint16)

    pc_sig = masks_with_popcount(draw_popcounts(profile.n_pcs))
    # Zipf-ish PC popularity: few hot miss PCs dominate, like real codes.
    pc_weights = 1.0 / np.arange(1, profile.n_pcs + 1) ** 0.9
    pc_weights /= pc_weights.sum()
    pc = rng.choice(profile.n_pcs, size=E, p=pc_weights).astype(np.int32)

    stable = rng.random(E) < profile.pattern_stability
    fresh = masks_with_popcount(draw_popcounts(E))
    used_mask = np.where(stable, pc_sig[pc], fresh).astype(np.uint16)
    used_mask[used_mask == 0] = 1

    # --- first word + reuse distances ------------------------------------
    bits = (used_mask[:, None] >> np.arange(NUM_SECTORS)) & 1  # (E, 8)
    # first word = a uniformly random used word
    r = rng.random(E)[:, None]
    cum = np.cumsum(bits, axis=1)
    total = cum[:, -1:]
    first_idx = (cum > r * total).argmax(axis=1).astype(np.int32)

    near = rng.random((E, NUM_SECTORS)) < profile.p_near
    d_near = rng.geometric(1.0 / profile.near_scale, size=(E, NUM_SECTORS))
    d_far = rng.geometric(1.0 / profile.far_scale, size=(E, NUM_SECTORS))
    dist = np.where(near, d_near, d_far).astype(np.int32)
    dist = np.where(bits.astype(bool), dist, np.int32(2**30))
    dist[np.arange(E), first_idx] = 0

    # --- dirty words ------------------------------------------------------
    dirty = (rng.random((E, NUM_SECTORS)) < profile.write_frac) & bits.astype(bool)
    dirty_mask = (dirty << np.arange(NUM_SECTORS)).sum(axis=1).astype(np.uint16)

    # --- addresses: sequential runs (row locality) vs. random jumps -------
    jump = rng.random(E) >= profile.row_hit
    jump[0] = True
    run_id = np.cumsum(jump)
    rand_blocks = rng.integers(0, ROWS_PER_BANK * NUM_BANKS * BLOCKS_PER_ROW,
                               size=E, dtype=np.int64)
    run_base = rand_blocks[jump][run_id - 1]  # base block of the current run
    offset_in_run = np.arange(E) - np.flatnonzero(jump)[run_id - 1]
    block = run_base + offset_in_run
    # Row-Bank-Rank-Column-Channel mapping (1 channel): sequential blocks walk
    # columns within a row, so runs produce row-buffer hits.
    col = block % BLOCKS_PER_ROW
    rank = (block // BLOCKS_PER_ROW) % RANKS
    bank_in_rank = (block // (BLOCKS_PER_ROW * RANKS)) % BANKS_PER_RANK
    row = (block // (BLOCKS_PER_ROW * RANKS * BANKS_PER_RANK)) % ROWS_PER_BANK
    bank = (rank * BANKS_PER_RANK + bank_in_rank).astype(np.int32)
    del col

    # --- instruction positions -------------------------------------------
    instr_per_miss = 1000.0 / profile.mpki
    gaps = rng.exponential(instr_per_miss, size=E)
    gaps = np.maximum(gaps, 1.0)
    instr_pos = np.cumsum(gaps).astype(np.int64)
    n_instructions = int(instr_pos[-1] + instr_per_miss)

    # Dependent misses (pointer chasing): the lower the row locality, the
    # more likely a miss address is produced by the previous miss's data.
    dep_frac = float(np.clip(0.55 * (1.0 - profile.row_hit) - 0.05, 0.0, 0.6))
    dep = rng.random(E) < dep_frac

    return EpisodeTrace(
        profile=profile,
        n_instructions=n_instructions,
        pc=pc,
        first_word=first_idx,
        used_mask=used_mask,
        dirty_mask=dirty_mask,
        dist=dist,
        instr_pos=instr_pos,
        bank=bank,
        row=row.astype(np.int32),
        block=block.astype(np.int64),
        dep=dep,
    )


def make_mixes(category: str, n_mixes: int = 16, cores: int = 8, seed: int = 0):
    """The paper's multi-programmed mixes: ``n_mixes`` random draws of
    ``cores`` workloads from one MPKI category (§6.1)."""
    pool = {"high": HIGH_MPKI, "medium": MEDIUM_MPKI, "low": LOW_MPKI}[category]
    rng = np.random.default_rng(seed + {"high": 1, "medium": 2, "low": 3}[category])
    mixes = []
    for _ in range(n_mixes):
        mixes.append([pool[i].name for i in rng.integers(0, len(pool), size=cores)])
    return mixes
