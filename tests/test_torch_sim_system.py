"""The port's system simulation against the reference, exactly: traces,
request streams, ``run_system`` for all 13 evaluated architectures, the
normalized weighted speedup, and the Fig. 13/14 rows at a reduced size.

The reference seeds its traces with ``hash(name)``, randomized per process;
here it seeds them with the port's ``name_salt`` (``_sim_oracle.salted``),
and the last test shows the port's traces do not depend on the process's
hash seed. Every comparison is exact: integers and arrays by value and
dtype, floats bit for bit, rows character for character.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _sim_oracle import assert_same, f32_bits, salted_module  # noqa: F401

from benchmarks import common as jcommon
from benchmarks import paper_tables as jtables
from repro.core import baselines as jbaselines
from repro.core import predictor as jpred
from repro.core import simulator as jsim
from repro.data import traces as jtraces
from repro_torch.core import baselines, predictor
from repro_torch.core import simulator as psim
from repro_torch.data import traces
from repro_torch.launch import paper

pytestmark = pytest.mark.usefixtures("salted_module")

ROOT = Path(__file__).resolve().parent.parent
N = 20_000  # instructions per core and run
CORES = 4


@pytest.fixture(scope="module")
def mix(salted_module):  # noqa: F811
    mixes = jtraces.make_mixes("high", n_mixes=1, cores=CORES, seed=0)
    assert mixes == traces.make_mixes("high", n_mixes=1, cores=CORES, seed=0)
    return tuple(mixes[0])


def test_profiles_and_mixes_equal():
    assert list(jtraces.WORKLOADS) == list(traces.WORKLOADS)
    for name, prof in jtraces.WORKLOADS.items():
        assert_same(prof, traces.WORKLOADS[name], name)
    for cls in ("HIGH_MPKI", "MEDIUM_MPKI", "LOW_MPKI"):
        assert ([p.name for p in getattr(jtraces, cls)]
                == [p.name for p in getattr(traces, cls)])
    for cat in ("high", "medium", "low"):
        assert (jtraces.make_mixes(cat, n_mixes=5, cores=8, seed=2)
                == traces.make_mixes(cat, n_mixes=5, cores=8, seed=2))


@pytest.mark.parametrize("name,n,seed", [
    ("ligraPageRank", 700, 0), ("libquantum-2006", 300, 3),
    ("omnetpp-2006", 64, 1000), ("bzip2-2006", 500, 7)])
def test_generate_trace_equal(name, n, seed):
    """Under the stable salt the reference draws the port's trace: every
    array equal in value and dtype."""
    assert_same(jtraces.generate_trace(jtraces.WORKLOADS[name], n, seed),
                traces.generate_trace(traces.WORKLOADS[name], n, seed))


@pytest.mark.parametrize("arch", ["sectored", "dgms", "pra", "fga"])
def test_build_stream_equal(arch, mix):
    """Flattening into the padded (C, R) request stream: every field equal,
    under the architectures whose fields differ most (sectored masks,
    sub-rank lanes, dirty-word writebacks, serialized columns)."""
    def stream_of(tr_mod, pred_mod, sim_mod, base_mod):
        cores = [tr_mod.generate_trace(tr_mod.WORKLOADS[w],
                                       sim_mod._episodes_for(
                                           tr_mod.WORKLOADS[w], N),
                                       seed=1000 * i)
                 for i, w in enumerate(mix)]
        a = base_mod.ALL_ARCHS[arch]
        preds = [pred_mod.simulate_prediction(t, a.policy) for t in cores]
        return sim_mod.build_stream(cores, preds, a)

    assert_same(stream_of(jtraces, jpred, jsim, jbaselines),
                stream_of(traces, predictor, psim, baselines))


def test_architectures_equal():
    assert list(jbaselines.ALL_ARCHS) == list(baselines.ALL_ARCHS)
    for name, arch in jbaselines.ALL_ARCHS.items():
        assert_same(arch, baselines.ALL_ARCHS[name], name)
    for k in ("DEFAULT_INSTRUCTIONS", "MIN_EPISODES", "WRITEBACK_LAG",
              "SECTOR_MISS_STALL_FRAC"):
        assert getattr(jsim, k) == getattr(psim, k), k


@pytest.mark.parametrize("arch", list(jbaselines.ALL_ARCHS))
def test_run_system_equal(arch, mix):
    """One reduced 4-core high mix on each of the 13 architectures: the
    SystemResult (its SimResult, IPCs, counts and energies) equal in every
    field, the f32 energy sums as bits."""
    ref = jsim.run_system(mix, arch, N)
    got = psim.run_system(mix, arch, N)
    assert_same(ref, got)
    assert f32_bits(ref.sim.e_act_nj) == f32_bits(got.sim.e_act_nj)
    assert f32_bits(ref.sim.e_rdwr_nj) == f32_bits(got.sim.e_rdwr_nj)
    assert psim.run_system(mix, arch, N) is got  # memoized


@pytest.mark.parametrize("arch", ["sectored", "halfdram"])
def test_normalized_weighted_speedup_equal(arch, mix):
    ref = jsim.normalized_weighted_speedup(
        mix, jbaselines.ALL_ARCHS[arch], n_instructions=N)
    got = psim.normalized_weighted_speedup(
        mix, baselines.ALL_ARCHS[arch], n_instructions=N)
    assert_same(ref, got)


def test_mix_table_rows_equal(monkeypatch):
    """Fig. 13 and Fig. 14 over one reduced 4-core high mix: the reference's
    rows (its table code, with its sizes set to these) equal the port's
    character for character, the timing column aside."""
    monkeypatch.setattr(jcommon, "N_INSTR", N)
    monkeypatch.setattr(jcommon.ws_and_energy, "__defaults__", (N,))
    monkeypatch.setattr(jcommon.high_mixes, "__defaults__", (1, CORES, 0))
    ref = jtables.fig13_mixes(1) + jtables.fig14_breakdown(1)
    got = (paper.fig13_mixes(1, N, CORES)
           + paper.fig14_breakdown(1, N, CORES))
    assert [r.split(",", 2)[::2] for r in ref] \
        == [r.split(",", 2)[::2] for r in got]


_TRACE_SCRIPT = """
import hashlib, sys
sys.path.insert(0, "src")
from repro_torch.data import traces
h = hashlib.sha256()
for name in ("mcf-2006", "lbm-2017", "povray-2006"):
    tr = traces.generate_trace(traces.WORKLOADS[name], 300, seed=2)
    for a in (tr.pc, tr.used_mask, tr.dirty_mask, tr.dist, tr.instr_pos,
              tr.bank, tr.row, tr.block, tr.dep):
        h.update(a.tobytes())
print(h.hexdigest())
"""


def test_traces_do_not_depend_on_the_hash_seed():
    """The reference's ``hash(name)`` salt changes with PYTHONHASHSEED; the
    port's does not: two processes with different hash seeds draw the same
    arrays."""
    digests = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True)
        digests.append(out.stdout.strip())
    assert len(digests[0]) == 64 and digests[0] == digests[1]
