"""The paper's figures and Table 4 from the port's DRAM simulator.

    python -m repro_torch.launch.paper [--tables fig3,fig9,...]
        [--n-instr N] [--mixes M]

One function per paper artifact; each returns a list of CSV rows
``name,us_per_call,derived``, where ``derived`` holds the model's value
beside the paper's. By default it runs every table but fig11 and fig15 (the
slower multi-core scans). The simulator is a host model (numpy), so this
runs on the CPU wherever it is started.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import area, dram, power, predictor
from repro_torch.core import simulator as sim
from repro_torch.core.baselines import popcount_np
from repro_torch.data import traces

#: Instruction budget per run. The paper uses 100M-instruction SimPoints;
#: statistics converge far earlier in the synthetic model.
N_INSTR = 200_000
N_MIXES = 6  # paper: 16


def timed(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, (time.time() - t0) * 1e6


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.0f},{derived}"


def high_mixes(n=N_MIXES, cores=8, seed=0):
    return traces.make_mixes("high", n_mixes=n, cores=cores, seed=seed)


def ws_and_energy(mix, arch, n_instr=N_INSTR):
    ws = sim.normalized_weighted_speedup(mix, sim.baselines.ALL_ARCHS[arch],
                                         n_instructions=n_instr)
    r = sim.run_system(tuple(mix), arch, n_instructions=n_instr)
    b = sim.run_system(tuple(mix), "baseline", n_instructions=n_instr)
    return ws, r.dram_energy_nj / b.dram_energy_nj, r, b


# ---------------------------------------------------------------- Fig. 3
def fig3_motivation():
    """Coarse vs fine DRAM access/activation energy across all 41 workloads.

    Paper: coarse access energy 1.27x fine; coarse activation 1.04x fine;
    +45% data movement.
    """
    e = power.DRAMEnergyModel()
    coarse = fine = coarse_a = fine_a = words_c = words_f = 0.0
    us = 0.0
    for prof in traces.WORKLOADS.values():
        # traffic-weighted: each workload contributes in proportion to its
        # DRAM access count (MPKI), as a whole-suite energy total does.
        n_ep = max(int(prof.mpki * 200), 64)
        tr, dt = timed(traces.generate_trace, prof, n_ep, 0)
        us += dt
        used = popcount_np(tr.used_mask.astype(np.uint32))
        coarse += float(np.sum(e.rd_energy(np.full_like(used, 8))))
        fine += float(np.sum(e.rd_energy(used)))
        coarse_a += float(np.sum(e.act_energy(np.full_like(used, 8), False)))
        fine_a += float(np.sum(e.act_energy(used, True)))
        words_c += 8.0 * len(used)
        words_f += float(used.sum())
    return [
        csv_row("fig3.access_energy_coarse_over_fine", us,
                f"{coarse / fine:.3f} (paper 1.27)"),
        csv_row("fig3.act_energy_coarse_over_fine", us,
                f"{coarse_a / fine_a:.3f} (paper 1.04)"),
        csv_row("fig3.data_movement_increase", us,
                f"{words_c / words_f - 1:.2%} (paper 45%)"),
    ]


# ---------------------------------------------------------------- Fig. 9
def fig9_power():
    """ACT/RD/WR power for 8/4/2/1 sectors, normalized to baseline."""
    rows = []
    for s in (8, 4, 2, 1):
        (a, us) = timed(lambda: float(power.act_power_fraction(s)))
        rows.append(csv_row(
            f"fig9.act_power_{s}sector", us,
            f"{a:.4f} (paper {'0.873' if s == 1 else '<=1.0026'})"))
    rows.append(csv_row(
        "fig9.act_array_power_1sector", 0,
        f"{float(power.act_array_fraction(1)):.3f} (paper 0.335)"))
    rows.append(csv_row(
        "fig9.rd_power_1sector", 0,
        f"{float(power.rd_power_fraction(1)):.3f} (paper 0.300)"))
    rows.append(csv_row(
        "fig9.wr_power_1sector", 0,
        f"{float(power.wr_power_fraction(1)):.3f} (paper 0.294)"))
    rows.append(csv_row(
        "fig9.sector_logic_act_overhead", 0,
        f"{power.ACT_SECTOR_LOGIC_OVERHEAD:.4f} (paper 0.0026)"))
    return rows


# ---------------------------------------------------------------- Fig. 10
def fig10_mpki():
    """LLC MPKI under Basic / LA / SP / LA+SP fetch policies, all 41
    workloads. Paper: Basic 3.08x baseline; LA16/128/2048 cut the extra
    misses by 39/65/83%; LA128-SP512 by 82%."""
    policies = [predictor.BASIC, predictor.LA16, predictor.LA128,
                predictor.LA2048, predictor.SP512, predictor.LA128_SP512]
    extra = {p.name: [] for p in policies}
    ratio_basic = []
    for prof in traces.WORKLOADS.values():
        tr = traces.generate_trace(prof, 6000, seed=3)
        per = {p.name: float(predictor.simulate_prediction(tr, p).n_extra.mean())
               for p in policies}
        for k, v in per.items():
            extra[k].append(v)
        ratio_basic.append(1.0 + per["basic"])
    rows = [csv_row("fig10.basic_mpki_ratio", 0,
                    f"{np.mean(ratio_basic):.2f}x (paper 3.08x)")]
    base = np.array(extra["basic"])
    targets = {"LA16": "39%", "LA128": "65%", "LA2048": "83%", "SP512": "-",
               "LA128-SP512": "82%"}
    for p, target in targets.items():
        red = float(np.mean(1.0 - np.array(extra[p]) / np.maximum(base, 1e-9)))
        rows.append(csv_row(f"fig10.extra_miss_reduction_{p}", 0,
                            f"{red:.1%} (paper {target})"))
    return rows


# ---------------------------------------------------------------- Fig. 11/12
def fig11_scaling(n_instr=N_INSTR):
    """Parallel speedup + system energy scaling, 1-16 cores, representative
    high/medium/low workloads."""
    rows = []
    for wname in ["ligraPageRank", "libquantum-2006", "omnetpp-2006",
                  "bzip2-2006"]:
        base1 = sim.run_system(wname, "baseline", n_instr)
        for cores in (4, 16):
            rb = sim.run_homogeneous(wname, "baseline", cores, n_instr)
            rs = sim.run_homogeneous(wname, "sectored", cores, n_instr)
            ps_b = float(base1.runtime_ps[0]) / float(rb.runtime_ps.max())
            ps_s = float(base1.runtime_ps[0]) / float(rs.runtime_ps.max())
            en = rs.system_energy_nj / rb.system_energy_nj
            rows.append(csv_row(
                f"fig11.{wname}.{cores}core", 0,
                f"pspeedup {ps_s / max(ps_b, 1e-9):.3f}x sysenergy {en:.3f}"))
    return rows


# ---------------------------------------------------------------- Fig. 13
def fig13_mixes(n_mixes=N_MIXES, n_instr=N_INSTR, cores=8):
    """Weighted speedup + DRAM energy vs baseline for SD and the four prior
    works, high-MPKI 8-core mixes. Paper: SD 1.17x/-20% (up to -33%);
    FGA 0.57x; PRA ~1.06x; HalfDRAM ~1.31x; DGMS 0.77x; chop 0.95x/-18%."""
    paper = {"sectored": "1.17/-20%", "fga": "0.57", "pra": "1.06",
             "halfdram": "1.31", "burst-chop": "0.95/-18%", "dgms": "0.77"}
    mixes = high_mixes(n_mixes, cores)
    rows = []
    for arch, target in paper.items():
        ws, en = [], []
        for mix in mixes:
            w, e, _, _ = ws_and_energy(mix, arch, n_instr)
            ws.append(w)
            en.append(e)
        rows.append(csv_row(
            f"fig13.{arch}", 0,
            f"WS {np.mean(ws):.3f} E {np.mean(en):.3f} "
            f"minE {np.min(en):.3f} (paper {target})"))
    return rows


# ---------------------------------------------------------------- Fig. 14
def fig14_breakdown(n_mixes=4, n_instr=N_INSTR, cores=8):
    """DRAM energy breakdown (ACT / RDWR / background) + system energy.
    Paper: RD/WR energy -51%, ACT energy -6%, system energy -14%."""
    act_r, rdwr_r, sys_r = [], [], []
    for mix in high_mixes(n_mixes, cores):
        rs = sim.run_system(tuple(mix), "sectored", n_instr)
        rb = sim.run_system(tuple(mix), "baseline", n_instr)
        act_r.append(rs.e_breakdown["act"] / rb.e_breakdown["act"])
        rdwr_r.append(rs.e_breakdown["rdwr"] / rb.e_breakdown["rdwr"])
        sys_r.append(rs.system_energy_nj / rb.system_energy_nj)
    return [
        csv_row("fig14.rdwr_energy", 0, f"{np.mean(rdwr_r):.3f} (paper 0.49)"),
        csv_row("fig14.act_energy", 0, f"{np.mean(act_r):.3f} (paper 0.94)"),
        csv_row("fig14.system_energy", 0,
                f"{np.mean(sys_r):.3f} (paper 0.86)"),
    ]


# ---------------------------------------------------------------- Fig. 15
def fig15_dynamic(n_mixes=3, n_instr=N_INSTR, cores=8):
    """Dynamically turning Sectored DRAM off for non-memory-intensive mixes
    (§8.1): ON when the measured memory-intensity proxy (baseline read
    latency, standing in for read-queue occupancy) exceeds a threshold."""
    rows = []
    for cat in ["high", "medium", "low"]:
        on, dyn = [], []
        for mix in traces.make_mixes(cat, n_mixes=n_mixes, cores=cores,
                                     seed=0):
            ws_on, _, _, rb = ws_and_energy(mix, "sectored", n_instr)
            # occupancy proxy: queueing-heavy baseline => turn SD on
            intense = rb.sim.read_latency_ns > 80.0
            dyn.append(ws_on if intense else 1.0)
            on.append(ws_on)
        rows.append(csv_row(
            f"fig15.{cat}", 0,
            f"alwaysON {np.mean(on):.3f} dynamic {np.mean(dyn):.3f} "
            f"(paper: dynamic >= 1.0 for med/low)"))
    return rows


# ---------------------------------------------------------------- Table 4
def tab4_area():
    chip_mm2 = area.sectored_dram_chip_overhead() * area.ChipArea().total
    return [
        csv_row("tab4.sd_bank_overhead", 0,
                f"{area.sectored_dram_bank_overhead():.4f} (paper 0.0226)"),
        csv_row("tab4.sd_chip_overhead", 0,
                f"{area.sectored_dram_chip_overhead():.4f} (paper 0.0172)"),
        csv_row("tab4.sd_chip_mm2", 0, f"{chip_mm2:.3f} (paper 0.39)"),
        csv_row("tab4.sd_16sector", 0,
                f"{area.finer_granularity_chip_overhead():.4f} (paper 0.0178)"),
        csv_row("tab4.halfdram", 0,
                f"{area.halfdram_chip_overhead():.4f} (paper 0.026)"),
        csv_row("tab4.halfpage", 0,
                f"{area.halfpage_chip_overhead():.4f} (paper 0.052)"),
        csv_row("tab4.processor", 0,
                f"{area.processor_overhead():.4f} (paper 0.0122)"),
    ]


ALL_TABLES = {
    "fig3": fig3_motivation,
    "fig9": fig9_power,
    "fig10": fig10_mpki,
    "fig11": fig11_scaling,
    "fig13": fig13_mixes,
    "fig14": fig14_breakdown,
    "fig15": fig15_dynamic,
    "tab4": tab4_area,
}
DEFAULT_TABLES = tuple(n for n in ALL_TABLES if n not in ("fig11", "fig15"))
#: the tables that simulate DRAM systems, and the sizes each one takes
SIZED = {"fig11": ("n_instr",), "fig13": ("n_instr", "n_mixes", "cores"),
         "fig14": ("n_instr", "n_mixes", "cores"),
         "fig15": ("n_instr", "n_mixes", "cores")}


def run_table(name: str, n_instr: int = N_INSTR, n_mixes: int | None = None,
              cores: int = 8) -> dict:
    """One table's rows with its host seconds and the DRAM requests it
    simulated (0 where every run it needs is already memoized)."""
    sizes = dict(n_instr=n_instr, n_mixes=n_mixes, cores=cores)
    kw = {k: sizes[k] for k in SIZED.get(name, ()) if sizes[k] is not None}
    dram.reset_counts()
    t0 = time.perf_counter()
    rows = ALL_TABLES[name](**kw)
    seconds = time.perf_counter() - t0
    req, loop_s = dram.counts["requests"], dram.counts["loop_s"]
    return dict(table=name, rows=rows, seconds=seconds, requests=req,
                us_per_request=seconds * 1e6 / req if req else None,
                loop_us_per_request=loop_s * 1e6 / req if req else None)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default=",".join(DEFAULT_TABLES),
                    help=f"comma-separated, of {', '.join(ALL_TABLES)}")
    ap.add_argument("--n-instr", type=int, default=N_INSTR,
                    help="instructions per core and run")
    ap.add_argument("--mixes", type=int, default=None,
                    help="mixes per mix table (default: fig13 6, fig14 4, "
                         "fig15 3)")
    args = ap.parse_args(argv)
    names = [n for n in args.tables.split(",") if n]
    unknown = sorted(set(names) - set(ALL_TABLES))
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from {list(ALL_TABLES)}")
    out = []
    for name in names:
        res = run_table(name, args.n_instr, args.mixes)
        print(f"--- {name} ({res['seconds']:.1f} s, {res['requests']} DRAM "
              f"requests) ---", flush=True)
        for row in res["rows"]:
            print(" ", row, flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
