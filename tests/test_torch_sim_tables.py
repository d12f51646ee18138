"""The port's paper tables (``repro_torch.launch.paper``) against the
reference's ``benchmarks/paper_tables.py``, row for row, character for
character (the timing column aside); the area model (Table 4) exactly; and
the end-to-end contracts of the reference's ``test_core_system.py``,
``test_system.py`` and ``test_core_power_area.py``, held by the port.

Fig. 3, 9, 10 and Table 4 run both sides in full. Fig. 11 and Fig. 15 need
many multi-core runs, whose equality ``test_torch_sim_system.py`` shows
architecture by architecture; here the reference's own table code runs on
the port's simulator, which holds the port's rows to the reference's
formulas and formats (``chip_smoke.py``'s ``paper_sim`` phase pins every
table at its full size to the reference's rows).
"""

import numpy as np
import pytest
from _sim_oracle import assert_same, salted_reference  # noqa: F401

from benchmarks import common as jcommon
from benchmarks import paper_tables as jtables
from repro.core import area as jarea
from repro_torch.core import area
from repro_torch.core import simulator as sim
from repro_torch.data import traces
from repro_torch.launch import paper
from repro_torch.runtime import sectored_decode


def _name_and_derived(rows):
    return [r.split(",", 2)[::2] for r in rows]


@pytest.mark.usefixtures("salted_reference")
@pytest.mark.parametrize("table", ["fig3", "fig9", "fig10", "tab4"])
def test_table_rows_equal(table):
    ref = dict(jtables.ALL_TABLES)[table]()
    got = paper.ALL_TABLES[table]()
    assert _name_and_derived(ref) == _name_and_derived(got)


@pytest.mark.parametrize("table", ["fig11", "fig15"])
def test_multicore_table_logic_equal(table, monkeypatch):
    """The reference's Fig. 11 / Fig. 15 code over the port's simulator (at
    20k instructions, one mix per category) gives the port's rows."""
    n = 20_000
    monkeypatch.setattr(jtables, "sim", sim)
    monkeypatch.setattr(jcommon, "sim", sim)
    monkeypatch.setattr(jcommon, "N_INSTR", n)
    monkeypatch.setattr(jcommon.ws_and_energy, "__defaults__", (n,))
    if table == "fig11":
        ref, got = jtables.fig11_scaling(), paper.fig11_scaling(n)
    else:
        ref, got = jtables.fig15_dynamic(1), paper.fig15_dynamic(1, n)
    assert _name_and_derived(ref) == _name_and_derived(got)


AREA_FNS = ["sectored_dram_bank_overhead", "sectored_dram_chip_overhead",
            "finer_granularity_chip_overhead", "halfdram_chip_overhead",
            "halfpage_chip_overhead", "fga_chip_overhead",
            "pra_chip_overhead", "processor_overhead"]


def test_area_equal():
    """Every Table 4 function and component area, bit for bit."""
    for fn in AREA_FNS:
        assert_same(getattr(jarea, fn)(), getattr(area, fn)(), fn)
    assert_same(jarea.finer_granularity_chip_overhead(16),
                area.finer_granularity_chip_overhead(16))
    for cls in ("BankArea", "ChipArea", "ProcessorArea"):
        assert_same(getattr(jarea, cls)(), getattr(area, cls)(), cls)
        assert_same(getattr(jarea, cls)().total, getattr(area, cls)().total)
    assert_same(jarea.ProcessorArea().cache_kib, area.ProcessorArea().cache_kib)


def test_tab4_area_anchors():
    assert area.sectored_dram_bank_overhead() == pytest.approx(0.0226, abs=0.001)
    assert area.sectored_dram_chip_overhead() == pytest.approx(0.0172, abs=0.001)
    assert area.halfdram_chip_overhead() == pytest.approx(0.026, abs=0.002)
    assert area.halfpage_chip_overhead() == pytest.approx(0.052, abs=0.003)
    assert area.processor_overhead() == pytest.approx(0.0122, abs=0.002)
    assert (area.sectored_dram_chip_overhead()
            < area.halfdram_chip_overhead()
            < area.halfpage_chip_overhead())


def test_sec82_finer_granularity():
    assert area.finer_granularity_chip_overhead() == pytest.approx(
        0.0178, abs=0.001)


# The Fig. 9 / Fig. 14 power anchors of the reference's
# test_core_power_area.py hold for the port because its power model equals
# the reference's bit for bit (tests/test_torch_telemetry.py).


def test_cli_prints_tables(capsys):
    out = paper.main(["--tables", "fig9,tab4"])
    assert [r["table"] for r in out] == ["fig9", "tab4"]
    text = capsys.readouterr().out
    assert "--- fig9 (" in text and "tab4.sd_chip_mm2,0,0.378 (paper 0.39)" in text
    assert paper.DEFAULT_TABLES == ("fig3", "fig9", "fig10", "fig13", "fig14",
                                    "tab4")
    with pytest.raises(SystemExit):
        paper.main(["--tables", "fig12"])


def test_run_table_counts_requests():
    sim.cache_clear()
    res = paper.run_table("fig14", n_instr=5_000, n_mixes=1, cores=2)
    assert res["requests"] > 0 and res["us_per_request"] > 0
    again = paper.run_table("fig14", n_instr=5_000, n_mixes=1, cores=2)
    assert again["requests"] == 0 and again["rows"] == res["rows"]  # memo
    sim.cache_clear()


# ------------------------- end-to-end contracts (the reference's bands)
N = 120_000  # the reference's instruction budget for its direction asserts


@pytest.fixture(scope="module")
def high_mix():
    return tuple(traces.make_mixes("high", n_mixes=1, cores=8, seed=0)[0])


def test_sectored_beats_baseline_on_high_mix(high_mix):
    rb = sim.run_system(high_mix, "baseline", N)
    rs = sim.run_system(high_mix, "sectored", N)
    assert rs.mean_ipc > rb.mean_ipc
    assert rs.dram_energy_nj < 0.92 * rb.dram_energy_nj


def test_sectored_moves_fewer_bytes(high_mix):
    rb = sim.run_system(high_mix, "baseline", N)
    rs = sim.run_system(high_mix, "sectored", N)
    assert rs.sim.bytes_on_bus < 0.6 * rb.sim.bytes_on_bus


def test_fga_and_dgms_lose(high_mix):
    rb = sim.run_system(high_mix, "baseline", N)
    for arch in ("fga", "dgms"):
        assert sim.run_system(high_mix, arch, N).mean_ipc < rb.mean_ipc


def test_low_mpki_mixes_roughly_neutral():
    mix = tuple(traces.make_mixes("low", n_mixes=1, cores=8, seed=0)[0])
    rb = sim.run_system(mix, "baseline", N)
    rs = sim.run_system(mix, "sectored", N)
    assert rs.mean_ipc > 0.9 * rb.mean_ipc


def test_basic_mpki_inflation_band():
    ratios = [sim.run_system(w, "sectored-basic", N).llc_mpki
              / sim.run_system(w, "baseline", N).llc_mpki
              for w in ["mcf-2006", "omnetpp-2006", "bzip2-2006", "lbm-2006"]]
    assert 2.0 < float(np.mean(ratios)) < 5.0


def test_energy_breakdown_rdwr_dominates_savings(high_mix):
    rb = sim.run_system(high_mix, "baseline", N)
    rs = sim.run_system(high_mix, "sectored", N)
    rdwr_ratio = rs.e_breakdown["rdwr"] / rb.e_breakdown["rdwr"]
    assert rdwr_ratio < 0.72
    assert rdwr_ratio < rs.e_breakdown["act"] / rb.e_breakdown["act"]


def test_writeback_energy_pra_saves_on_writes(high_mix):
    rb = sim.run_system(high_mix, "baseline", N)
    assert sim.run_system(high_mix, "pra", N).sim.e_rdwr_nj < rb.sim.e_rdwr_nj


def test_all_paper_archs_run():
    for name in sim.baselines.ALL_ARCHS:
        r = sim.run_system("omnetpp-2006", name, 60_000)
        assert r.dram_energy_nj > 0
        assert np.isfinite(r.mean_ipc)


def test_sectored_dram_end_to_end_story():
    """Fewer bytes, less DRAM energy and more IPC on a memory-intensive
    8-core run; the serving side saves the same kind of bytes."""
    mix = ("ligraPageRank",) * 8
    rb = sim.run_system(mix, "baseline", N)
    rs = sim.run_system(mix, "sectored", N)
    assert rs.sim.bytes_on_bus < rb.sim.bytes_on_bus
    assert rs.dram_energy_nj < rb.dram_energy_nj
    assert rs.mean_ipc > rb.mean_ipc
    assert sectored_decode.bytes_saved_fraction(32768) > 0.8


def test_overfetch_tracked():
    r = sim.run_system("lbm-2006", "sectored", 60_000)
    assert r.fetched_words >= r.used_words - r.n_sector_misses
    assert r.overfetch_words >= 0
