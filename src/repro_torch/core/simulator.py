"""End-to-end Sectored DRAM system simulation (paper §6); counterpart of
the JAX package's ``core/simulator.py``, on the host.

Composes the pipeline:

  workload profiles (data.traces)
    -> per-core episode streams
    -> stage 1: LSQ Lookahead + Sector Predictor  (core.predictor, vectorized)
    -> request flattening under a DRAM architecture (core.baselines)
    -> stage 2: multi-core DRAM timing + energy    (core.dram, host loop)
    -> metrics: IPC, speedups, MPKI, DRAM/system energy (core.metrics/power)

``run_system`` is the single entry point of the paper tables
(``launch/paper.py``). Its results are memoized on the workload names, the
architecture, the instruction budget and the seed; ``cache_clear()``
empties the memo.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import baselines, dram, metrics, power, predictor
from repro_torch.data import traces as traces_mod

#: Default per-core instruction budget of a simulated slice. The paper uses
#: 100M-instruction SimPoints; we default to 400k (the statistics that drive
#: every claim -- miss rates, locality, prediction accuracy -- converge within
#: a few tens of thousands of episodes).
DEFAULT_INSTRUCTIONS = 400_000
MIN_EPISODES = 64
WRITEBACK_LAG = 512  # episodes between a block's fill and its eviction
SECTOR_MISS_STALL_FRAC = 0.35  # fraction of sector misses the OoO core cannot hide


@dataclasses.dataclass
class SystemResult:
    """One (workloads x DRAM architecture) simulation."""

    arch: str
    workloads: tuple[str, ...]
    sim: dram.SimResult
    ipc: np.ndarray  # (C,)
    runtime_ps: np.ndarray  # (C,)
    llc_mpki: float  # demand misses (initial + sector misses) per kilo-instr
    n_demand_misses: int
    n_sector_misses: int
    overfetch_words: int
    fetched_words: int
    used_words: int
    proc_energy_nj: float
    dram_energy_nj: float
    system_energy_nj: float
    e_breakdown: dict[str, float]  # ACT / RDWR / background+refresh

    @property
    def mean_ipc(self) -> float:
        return float(np.mean(self.ipc))


def _episodes_for(profile, n_instructions: int) -> int:
    return max(int(profile.mpki * n_instructions / 1000.0), MIN_EPISODES)


def _flatten_core(trace, pred, arch: baselines.DRAMArch):
    """Episode schedule -> time-ordered request arrays for one core."""
    E = trace.n_episodes
    # initial demand misses
    parts = [dict(
        instr=trace.instr_pos,
        mask=pred.m0.astype(np.uint32),
        bank=trace.bank, row=trace.row, block=trace.block,
        wr=np.zeros(E, bool), dep=trace.dep,
        sector_miss=np.zeros(E, bool),
    )]
    # sector misses
    for k in range(pred.extra_masks.shape[1]):
        sel = pred.extra_masks[:, k] != 0
        if not sel.any():
            continue
        d = np.minimum(pred.extra_dists[:, k][sel], 1 << 29).astype(np.int64)
        # A sector miss is partially a *demand* stall: the consuming
        # instruction expected an on-chip hit, so less independent work was
        # scheduled around it (the paper's §8.1 explanation of low-MPKI
        # slowdowns). SECTOR_MISS_STALL_FRAC of them serialize; the OoO
        # window hides the rest.
        n_sel = int(sel.sum())
        smiss_dep = (np.flatnonzero(sel) * 2654435761 % 100
                     < SECTOR_MISS_STALL_FRAC * 100)
        parts.append(dict(
            instr=trace.instr_pos[sel] + d,
            mask=pred.extra_masks[:, k][sel].astype(np.uint32),
            bank=trace.bank[sel], row=trace.row[sel], block=trace.block[sel],
            wr=np.zeros(n_sel, bool), dep=smiss_dep,
            sector_miss=np.ones(n_sel, bool),
        ))
    # writebacks at eviction (episode i evicted around episode i+LAG)
    sel = pred.writeback_mask != 0
    if sel.any():
        evict_idx = np.minimum(np.flatnonzero(sel) + WRITEBACK_LAG, E - 1)
        parts.append(dict(
            instr=trace.instr_pos[evict_idx],
            mask=pred.writeback_mask[sel].astype(np.uint32),
            bank=trace.bank[sel], row=trace.row[sel], block=trace.block[sel],
            wr=np.ones(sel.sum(), bool), dep=np.zeros(sel.sum(), bool),
            sector_miss=np.zeros(sel.sum(), bool),
        ))

    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.argsort(cat["instr"], kind="stable")
    out = {k: v[order] for k, v in cat.items()}
    # Integer core-time deltas between consecutive requests of this core:
    # cum_u = round(instr_pos * CPI * 16/3.6) 1/16-ns units, diffed so
    # rounding never drifts.
    tpi_u = trace.profile.cpi_core * 16.0 / 3.6
    cum_u = np.round(out["instr"].astype(np.float64) * tpi_u).astype(np.int64)
    out["gap_u"] = np.diff(cum_u, prepend=0).astype(np.int32)
    out["tail_u"] = np.int64(
        round((trace.n_instructions - float(out["instr"][-1])) * tpi_u)
    ) if len(out["instr"]) else np.int64(0)
    return out


def build_stream(core_traces, preds, arch: baselines.DRAMArch) -> dram.RequestStream:
    cores = [_flatten_core(t, p, arch) for t, p in zip(core_traces, preds)]
    C = len(cores)
    R = max(len(c["instr"]) for c in cores)

    def pad(key, dtype, fill=0):
        out = np.full((C, R), fill, dtype)
        for i, c in enumerate(cores):
            out[i, : len(c[key])] = c[key]
        return out

    fields = [arch.request_fields(c["mask"], c["wr"], c["block"]) for c in cores]

    def padf(key, dtype, fill=0):
        out = np.full((C, R), fill, dtype)
        for i, f in enumerate(fields):
            out[i, : len(f[key])] = f[key]
        return out

    return dram.RequestStream(
        gap_u=pad("gap_u", np.int32),
        bank=pad("bank", np.int32),
        row=pad("row", np.int32),
        bus_u=padf("bus_u", np.int32),
        cmd_u=padf("cmd_u", np.int32),
        lane=padf("lane", np.int32),
        col_serial_u=padf("col_serial_u", np.int32),
        faw_cost=padf("faw_cost", np.int32, 100),
        e_act_nj=padf("e_act_nj", np.float32),
        e_col_nj=padf("e_col_nj", np.float32),
        is_write=pad("wr", bool),
        dep=pad("dep", bool),
        data_bytes=padf("data_bytes", np.float64),
        n_req=np.array([len(c["instr"]) for c in cores], np.int32),
        tail_u=np.array([c["tail_u"] for c in cores], np.int64),
        n_instructions=np.array(
            [t.n_instructions for t in core_traces], np.int64
        ),
    )


@functools.lru_cache(maxsize=4096)
def _cached_run(workload_names: tuple, arch_name: str, n_instructions: int,
                seed: int) -> "SystemResult":
    arch = baselines.ALL_ARCHS[arch_name]
    profs = [traces_mod.WORKLOADS[n] for n in workload_names]
    core_traces = [
        traces_mod.generate_trace(p, _episodes_for(p, n_instructions),
                                  seed=seed + 1000 * i)
        for i, p in enumerate(profs)
    ]
    preds = [predictor.simulate_prediction(t, arch.policy) for t in core_traces]
    stream = build_stream(core_traces, preds, arch)
    sim = dram.simulate(stream)

    n_demand = sum(t.n_episodes + int(p.n_extra.sum())
                   for t, p in zip(core_traces, preds))
    n_sector = sum(int(p.n_extra.sum()) for p in preds)
    n_instr_total = sum(t.n_instructions for t in core_traces)
    used = sum(int(baselines.popcount_np(t.used_mask.astype(np.uint32)).sum())
               for t in core_traces)
    fetched = sum(int(p.fetched_words.sum()) for p in preds)
    over = sum(int(p.overfetch_words.sum()) for p in preds)

    total_s = sim.total_ps * 1e-12
    p_proc = power.processor_power(
        float(np.mean(sim.ipc)), n_cores=len(profs), sectored=arch.sectored_hw
    )
    proc_nj = float(p_proc) * total_s * 1e9
    dram_nj = sim.dram_energy_nj
    return SystemResult(
        arch=arch.name,
        workloads=workload_names,
        sim=sim,
        ipc=sim.ipc,
        runtime_ps=sim.runtime_ps,
        llc_mpki=metrics.llc_mpki(n_demand, n_instr_total),
        n_demand_misses=n_demand,
        n_sector_misses=n_sector,
        overfetch_words=over,
        fetched_words=fetched,
        used_words=used,
        proc_energy_nj=proc_nj,
        dram_energy_nj=dram_nj,
        system_energy_nj=proc_nj + dram_nj,
        e_breakdown=dict(
            act=sim.e_act_nj,
            rdwr=sim.e_rdwr_nj,
            background=sim.e_background_nj + sim.e_refresh_nj,
        ),
    )


def run_system(workloads, arch: baselines.DRAMArch | str,
               n_instructions: int = DEFAULT_INSTRUCTIONS,
               seed: int = 0) -> SystemResult:
    """Simulate ``workloads`` (one name per core) on DRAM architecture
    ``arch``. Results are memoized."""
    if isinstance(workloads, str):
        workloads = (workloads,)
    arch_name = arch if isinstance(arch, str) else arch.name
    return _cached_run(tuple(workloads), arch_name, n_instructions, seed)


def cache_clear() -> None:
    """Forget every memoized :func:`run_system` result."""
    _cached_run.cache_clear()


def run_homogeneous(workload: str, arch, cores: int,
                    n_instructions: int = DEFAULT_INSTRUCTIONS,
                    seed: int = 0) -> SystemResult:
    """The paper's multi-core scaling runs: the same workload on every core."""
    return run_system((workload,) * cores, arch, n_instructions, seed)


def normalized_weighted_speedup(mix, arch, baseline=baselines.BASELINE,
                                n_instructions: int = DEFAULT_INSTRUCTIONS,
                                seed: int = 0) -> float:
    """Weighted speedup of ``arch`` on ``mix``, normalized to the coarse
    baseline's weighted speedup (Fig. 13 top)."""
    alone = np.array([
        run_system(w, baseline, n_instructions, seed).mean_ipc for w in mix
    ])
    shared_arch = run_system(tuple(mix), arch, n_instructions, seed)
    shared_base = run_system(tuple(mix), baseline, n_instructions, seed)
    ws_arch = metrics.weighted_speedup(shared_arch.ipc, alone)
    ws_base = metrics.weighted_speedup(shared_base.ipc, alone)
    return ws_arch / ws_base
