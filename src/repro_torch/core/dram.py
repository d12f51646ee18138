"""Cycle-approximate multi-core DRAM timing simulator (paper §6.3);
counterpart of the JAX package's ``core/dram.py``.

Stage 2 of the reproduction pipeline: consumes per-core DRAM request streams
(produced by ``core.predictor`` + ``core.simulator`` flattening) and plays
them against a DDR4 model with

* per-bank state machines (open row, column/activate readiness, tRC/tRP/
  tRTP/tWR interactions) over 4 ranks x 16 banks,
* per-rank tFAW **power token buckets** (the Sectored Activation relaxation:
  an ACT of s sectors costs `act_array_fraction(s)` tokens instead of 1.0),
* a shared data bus with Variable Burst Length occupancy (beats * tCK/2),
  optionally split into 8 sub-rank lanes (DGMS, §9). Every shared *rate*
  resource (data bus, command bus, per-rank tFAW power budget, per-rank
  tRRD spacing) is a monotone reservation pointer in issue-time order — a
  leak-free token bucket,
* a closed-loop core model: each core advances by instruction gaps at its
  base CPI, loads contend for 8 MSHRs (ring of outstanding completions),
  writebacks are posted, and dependent misses (pointer chasing) serialize
  on the previous miss.

The requests are processed one at a time in adaptive global order (the
earliest-issuable core goes next, the lowest core index on a tie), as the
reference's scan processes them, in a host loop over the real requests
only. Time is kept in **integer 1/16-ns units**, which the reference holds
in int32: every time stays below ``INF`` = 2**30, and the int32 counters
wrap as there. The two energy sums are float32, added in processing order.
This is a host model: it holds no tensor and takes no device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import power
from repro_torch.core.timing import DEFAULT_TIMING, DDR4Timing

INF = 2**30
UNITS_PER_NS = 16
MSHRS = 8  # per-core miss buffers (paper Table 2)
CTRL_NS = 20.0  # controller + on-chip network round trip
NUM_BANKS = 64
RANKS = 4
NUM_LANES = 8  # data-bus lanes; 1 used normally, 8 for sub-ranked DGMS
BUS_CAP_U = 160  # data-bus token capacity: 2 full 8-beat bursts (1/16 ns)
CMD_CAP_U = 100  # command-bus token capacity: 4 slots

#: requests simulated and seconds spent in :func:`simulate`'s loop since
#: the last :func:`reset_counts` (host-time accounting of the paper tables)
counts = {"requests": 0, "loop_s": 0.0}


def reset_counts() -> None:
    counts.update(requests=0, loop_s=0.0)


def _reserve(ptr: int, now: int, cost: int, cap: int) -> tuple[int, int]:
    """Monotone reservation pointer == leak-free token bucket (rate 1).

    ``ptr`` is the time by which all prior reservations are repaid. A request
    arriving at (monotone) ``now`` with ``cost`` units of resource time is
    granted at ``max(now, ptr - (cap - cost))`` — up to ``cap`` units may be
    outstanding at once, beyond that the grant is rate-limited. Returns
    (grant, new_ptr).
    """
    grant = max(now, ptr - (cap - cost))
    return grant, max(ptr, grant) + cost


def _u(ns: float) -> int:
    v = ns * UNITS_PER_NS
    assert abs(v - round(v)) < 1e-9, ns
    return int(round(v))


def _int32(x: int) -> int:
    """``x`` wrapped to int32, as the reference's counters wrap."""
    return (x + 2**31) % 2**32 - 2**31


@dataclasses.dataclass(frozen=True)
class TimingU:
    """Integer 1/16-ns timing derived from DDR4Timing."""

    tRCD: int
    tRAS: int
    tRC: int
    tRP: int
    tCL: int
    tCWL: int
    tFAW: int
    tRRD: int
    tCCD: int
    tWR: int
    tRTP: int
    tCK: int
    ctrl: int
    faw_cap: int  # reservation capacity (burst absorption), 1/16-ns units

    @classmethod
    def from_timing(cls, t: DDR4Timing = DEFAULT_TIMING) -> "TimingU":
        return cls(
            tRCD=_u(t.tRCD), tRAS=_u(t.tRAS), tRC=_u(t.tRC), tRP=_u(t.tRP),
            tCL=_u(t.tCL), tCWL=_u(t.tCWL), tFAW=_u(t.tFAW),
            tRRD=_u(t.tRRD), tCCD=_u(t.tCCD), tWR=_u(t.tWR),
            tRTP=_u(t.tRTP), tCK=_u(t.tCK), ctrl=_u(CTRL_NS),
            faw_cap=int(round(t.faw_burst_acts * _u(t.tFAW) / t.faw_acts)),
        )

    @property
    def beat(self) -> int:
        return self.tCK // 2


@dataclasses.dataclass
class RequestStream:
    """Padded per-core request arrays, all shaped (C, R) unless noted."""

    gap_u: np.ndarray  # int32 core-time delta since previous request (units)
    bank: np.ndarray  # int32 in [0, 64)
    row: np.ndarray  # int32
    bus_u: np.ndarray  # int32 data-bus occupancy (incl. burst multiplier)
    cmd_u: np.ndarray  # int32 command-bus occupancy
    lane: np.ndarray  # int32 data-bus lane (0 unless sub-ranked)
    col_serial_u: np.ndarray  # int32 extra serialized column time (FGA)
    faw_cost: np.ndarray  # int32 tFAW reservation cost (1/16-ns units)
    e_act_nj: np.ndarray  # float32 activation energy if this request ACTs
    e_col_nj: np.ndarray  # float32 RD/WR burst energy (always paid)
    is_write: np.ndarray  # bool
    dep: np.ndarray  # bool: issue depends on previous request's completion
    data_bytes: np.ndarray  # (C, R) useful bytes moved on the channel
    n_req: np.ndarray  # (C,) int32 valid requests per core
    tail_u: np.ndarray  # (C,) int64 core time after its last request (units)
    n_instructions: np.ndarray  # (C,) int64 instructions in the slice


@dataclasses.dataclass
class SimResult:
    runtime_ps: np.ndarray  # (C,) per-core completion time (picoseconds)
    ipc: np.ndarray  # (C,)
    e_act_nj: float
    e_rdwr_nj: float
    e_background_nj: float
    e_refresh_nj: float
    read_latency_ns: float
    row_hit_rate: float
    faw_stall_frac: float  # tFAW-induced ACT delay / total time
    n_acts: int
    n_requests: int
    bytes_on_bus: float
    total_ps: int
    bus_wait_ns: float = 0.0  # mean per-request data-bus wait
    bank_wait_ns: float = 0.0  # mean per-request bank wait
    conflict_rate: float = 0.0  # row-buffer conflicts / requests

    @property
    def dram_energy_nj(self) -> float:
        return (self.e_act_nj + self.e_rdwr_nj + self.e_background_nj
                + self.e_refresh_nj)


def _f32_sum(values: np.ndarray) -> float:
    """Float32 sum of ``values`` added one by one in order (each add
    rounded to float32, as the reference's scan carry adds)."""
    if len(values) == 0:
        return 0.0
    return float(np.cumsum(values.astype(np.float32), dtype=np.float32)[-1])


def _run(stream: RequestStream, tu: TimingU) -> dict:
    """Play every real request once, in global issue order."""
    C = stream.gap_u.shape[0]
    n_req = [int(n) for n in stream.n_req]
    reqs = []
    for c in range(C):
        n = n_req[c]
        reqs.append(list(zip(*(
            a[c, :n].tolist() for a in (
                stream.gap_u, stream.bank, stream.row, stream.bus_u,
                stream.cmd_u, stream.lane, stream.col_serial_u,
                stream.faw_cost, stream.is_write, stream.dep)))))

    tRCD, tRAS, tRP = tu.tRCD, tu.tRAS, tu.tRP
    tCL, tCWL, tRRD, tCCD = tu.tCL, tu.tCWL, tu.tRRD, tu.tCCD
    tWR, tRTP, ctrl, faw_cap = tu.tWR, tu.tRTP, tu.ctrl, tu.faw_cap
    ptr = [0] * C
    last_issue = [0] * C
    prev_done = [0] * C
    ring = [[0] * MSHRS for _ in range(C)]
    ring_pos = [0] * C
    open_row = [-1] * NUM_BANKS
    col_ready = [0] * NUM_BANKS
    act_ready = [0] * NUM_BANKS
    rrd_ptr = [0] * RANKS
    faw_ptr = [0] * RANKS
    bus_ptr = [0] * NUM_LANES
    cmd_ptr = 0
    lat_ns = loads = acts = hits = faw_ns = bus_ns = bank_ns = conf = 0
    t_max = 0
    miss_at = []  # (core, index) of each ACT, in processing order
    served = []  # (core, index) of each request, in processing order

    def candidate(c):
        """Core ``c``'s earliest issue time (INF once it is done)."""
        p = ptr[c]
        if p >= n_req[c]:
            return INF
        g, _, _, _, _, _, _, _, wr, dp = reqs[c][p]
        t = max(last_issue[c] + g, 0 if wr else ring[c][ring_pos[c]])
        return max(t, prev_done[c] if dp else 0)

    t_cand = [candidate(c) for c in range(C)]
    for _ in range(sum(n_req)):
        t = min(t_cand)
        c = t_cand.index(t)  # the lowest core index on a tie, as argmin
        p = ptr[c]
        g, b, rw, r_bus, r_cmd, r_lane, r_colser, r_cost, r_wr, _ = reqs[c][p]
        served.append((c, p))
        rank = b >> 4
        orow = open_row[b]
        hit = orow == rw
        if hit:
            col_rdy = max(t, col_ready[b])
            bank_wait = max(col_ready[b] - t, 0)
            hits += 1
        else:
            act_earliest = max(t, act_ready[b]) + (tRP if orow >= 0 else 0)
            grant_faw, faw_ptr[rank] = _reserve(faw_ptr[rank], t, r_cost,
                                                faw_cap)
            grant_rrd, rrd_ptr[rank] = _reserve(rrd_ptr[rank], t, tRRD,
                                                2 * tRRD)
            act_t = max(act_earliest, grant_faw, grant_rrd)
            faw_ns += max(max(grant_faw, grant_rrd) - act_earliest, 0) \
                // UNITS_PER_NS
            col_rdy = act_t + tRCD
            bank_wait = max(act_ready[b] - t, 0)
            acts += 1
            conf += orow >= 0
            miss_at.append((c, p))
        grant_cmd, cmd_ptr = _reserve(cmd_ptr, t, r_cmd, CMD_CAP_U)
        col_t = max(col_rdy, grant_cmd)
        data_lat = tCWL if r_wr else tCL
        grant_bus, bus_ptr[r_lane] = _reserve(bus_ptr[r_lane], t, r_bus,
                                              BUS_CAP_U)
        data_start = max(col_t + data_lat + r_colser, grant_bus)
        t_done = data_start + r_bus + ctrl

        open_row[b] = rw
        col_ready[b] = col_t + tCCD + r_colser
        pre_after_col = col_t + (data_lat + r_bus + tWR if r_wr else tRTP)
        act_ready[b] = max(act_ready[b] if hit else act_t + tRAS,
                           pre_after_col)

        ptr[c] = p + 1
        if r_wr:
            last_issue[c] += g
            prev_done[c] = t
        else:
            last_issue[c] = t
            prev_done[c] = t_done
            rpos = ring_pos[c]
            ring[c][rpos] = t_done
            ring_pos[c] = (rpos + 1) % MSHRS
            lat_ns += (t_done - t) // UNITS_PER_NS
            loads += 1
        bus_ns += ((data_start - (col_t + data_lat)) + (col_t - col_rdy)) \
            // UNITS_PER_NS
        bank_ns += bank_wait // UNITS_PER_NS
        if t_done > t_max:
            t_max = t_done
        t_cand[c] = candidate(c)

    # the reference's int32 times: a request issued at INF // 2 or later
    # would be a no-op there, so the run must end well before it
    assert t_max < INF // 2, f"simulated time {t_max} units overflows int32"
    assert all(x < INF // 2 for x in (*last_issue, *act_ready, *col_ready,
                                      *faw_ptr, *rrd_ptr, *bus_ptr, cmd_ptr))
    e_act = _f32_sum(_gather(stream.e_act_nj, miss_at))
    e_col = _f32_sum(_gather(stream.e_col_nj, served))
    return dict(last_issue=last_issue, ring=ring, t_max=t_max,
                acc_e_act=e_act, acc_e_col=e_col, acc_lat_ns=_int32(lat_ns),
                acc_loads=_int32(loads), acc_acts=_int32(acts),
                acc_hits=_int32(hits), acc_faw_ns=_int32(faw_ns),
                acc_bus_ns=_int32(bus_ns), acc_bank_ns=_int32(bank_ns),
                acc_conf=_int32(conf))


def _gather(a: np.ndarray, at: list) -> np.ndarray:
    if not at:
        return a.reshape(-1)[:0]
    cs, ps = zip(*at)
    return a[np.asarray(cs), np.asarray(ps)]


def simulate(stream: RequestStream, timing: DDR4Timing = DEFAULT_TIMING,
             energy: power.DRAMEnergyModel | None = None) -> SimResult:
    """Run the timing simulation and assemble energies/metrics."""
    energy = energy or power.DRAMEnergyModel(timing)
    tu = TimingU.from_timing(timing)
    n_steps = int(np.sum(stream.n_req))
    t0 = time.perf_counter()
    final = _run(stream, tu)
    counts["loop_s"] += time.perf_counter() - t0
    counts["requests"] += n_steps

    C = stream.gap_u.shape[0]
    runtime_ps = np.zeros((C,), np.int64)
    for c in range(C):
        done_u = max(final["last_issue"][c], max(final["ring"][c]))
        runtime_ps[c] = (done_u + int(stream.tail_u[c])) * 1000 // UNITS_PER_NS
    total_ps = final["t_max"] * 1000 // UNITS_PER_NS
    total_ps = max(total_ps, int(runtime_ps.max()) if C else 0)

    # IPC = instructions / cycles; cycle = 1000/3.6 ps (3.6 GHz core clock)
    cycle_ps = 1000.0 / 3.6
    ipc = stream.n_instructions / np.maximum(runtime_ps / cycle_ps, 1.0)

    total_s = total_ps * 1e-12
    e_bg = (energy.p_background_active * RANKS) * total_s * 1e9
    e_ref = energy.p_refresh * RANKS * total_s * 1e9
    n_loads = max(final["acc_loads"], 1)
    valid_mask = (np.arange(stream.bus_u.shape[1])[None, :]
                  < stream.n_req[:, None])
    bytes_on_bus = float(np.sum(stream.data_bytes * valid_mask))
    return SimResult(
        runtime_ps=runtime_ps,
        ipc=ipc,
        e_act_nj=final["acc_e_act"],
        e_rdwr_nj=final["acc_e_col"],
        e_background_nj=float(e_bg),
        e_refresh_nj=float(e_ref),
        read_latency_ns=float(final["acc_lat_ns"]) / n_loads,
        row_hit_rate=float(final["acc_hits"]) / max(n_steps, 1),
        faw_stall_frac=float(final["acc_faw_ns"]) * UNITS_PER_NS
        / max(final["t_max"], 1),
        n_acts=final["acc_acts"],
        n_requests=n_steps,
        bytes_on_bus=bytes_on_bus,
        total_ps=total_ps,
        bus_wait_ns=float(final["acc_bus_ns"]) / max(n_steps, 1),
        bank_wait_ns=float(final["acc_bank_ns"]) / max(n_steps, 1),
        conflict_rate=float(final["acc_conf"]) / max(n_steps, 1),
    )
