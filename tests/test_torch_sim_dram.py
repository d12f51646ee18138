"""Stage 2 of the port's DRAM simulator (``core/dram.py``) against the
reference's, exactly: the cases of the reference's ``test_core_dram.py``
and random multi-core streams, every ``SimResult`` field equal and the
float32 energy sums compared as bits; no tolerance. Also that file's
contracts, held by the port.

The test files of this simulator each hold fewer tests than
``test_kernels_fused.py``: pytest-xdist's ``loadfile`` schedule hands out
the largest files first, and that file's known worker crash is recovered
only while it is its worker's first file (``ROADMAP.md`` queue 3).
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _sim_oracle import assert_same, f32_bits

from repro.core import dram as jdram
from repro_torch.core import dram
from repro_torch.core.timing import DEFAULT_TIMING as T

R_PAD = 64  # requests per core in the padded layout build_stream makes


def stream(mod, cores, n_instr=10_000, pad=R_PAD):
    """A RequestStream of ``mod`` from per-core lists of request dicts (the
    reference's ``test_core_dram.stream``, for several cores), padded to
    ``pad`` requests a core."""
    C = len(cores)
    R = max(pad, max(len(r) for r in cores))
    keys = dict(gap_u=("gap", 160, np.int32), bank=("bank", 0, np.int32),
                row=("row", 0, np.int32), bus_u=("bus", 40, np.int32),
                cmd_u=("cmd", 40, np.int32), lane=("lane", 0, np.int32),
                col_serial_u=("colser", 0, np.int32),
                faw_cost=("faw", 100, np.int32),
                e_act_nj=("e_act", 1.0, np.float32),
                e_col_nj=("e_col", 1.0, np.float32),
                is_write=("wr", False, bool), dep=("dep", False, bool),
                data_bytes=("bytes", 64.0, np.float64))
    arrs = {}
    for field, (key, default, dtype) in keys.items():
        a = np.zeros((C, R), dtype)
        for c, reqs in enumerate(cores):
            a[c, :len(reqs)] = [r.get(key, default) for r in reqs]
        arrs[field] = a
    return mod.RequestStream(
        **arrs, n_req=np.array([len(r) for r in cores], np.int32),
        tail_u=np.arange(C, dtype=np.int64) * 7,
        n_instructions=np.full(C, n_instr, np.int64))


def both(cores, **kw):
    """The reference's and the port's SimResult on one stream; they must be
    equal in every field, with the f32 energies compared as bits."""
    ref = jdram.simulate(stream(jdram, cores, **kw))
    got = dram.simulate(stream(dram, cores, **kw))
    assert_same(ref, got)
    assert f32_bits(ref.e_act_nj) == f32_bits(got.e_act_nj)
    assert f32_bits(ref.e_rdwr_nj) == f32_bits(got.e_rdwr_nj)
    return got


def _energies(n, seed):
    rng = np.random.default_rng(seed)
    return rng.random(n).astype(np.float32) * 40, rng.random(n).astype(
        np.float32) * 7


CASES = {
    "single_request": [[dict()]],
    "row_hit": [[dict(row=0), dict(row=0, gap=10_000)]],
    "conflict": [[dict(row=0), dict(row=1, gap=10_000)]],
    "conflict_chain": [[dict(row=i, gap=1) for i in range(8)]],
    "vbl_full": [[dict(row=0, bus=80, gap=1) for _ in range(64)]],
    "vbl_short": [[dict(row=0, bus=10, gap=1) for _ in range(64)]],
    "faw_full": [[dict(bank=i % 16, row=5, gap=1, faw=100)
                  for i in range(16)]],
    "faw_relaxed": [[dict(bank=i % 16, row=5, gap=1, faw=34)
                     for i in range(16)]],
    "independent": [[dict(bank=i, gap=1) for i in range(8)]],
    "dep": [[dict(bank=i, gap=1, dep=True) for i in range(8)]],
    "writes": [[dict(wr=True, bank=0, row=i, gap=1) for i in range(12)]
               + [dict(bank=16, row=0, gap=1)]],
    # identical cores: every pick is a tie, taken by the lowest core index
    "multicore_tie": [[dict(bank=b, row=b, gap=40) for b in (0, 17, 0, 33)]
                      for _ in range(3)],
    "lanes_and_fga": [[dict(bank=(3 * i + c) % 64, row=i % 3, lane=(i + c) % 8,
                            colser=5 * (i % 2), bus=80, gap=20, wr=i % 5 == 0)
                       for i in range(30)] for c in range(4)],
}


@pytest.mark.parametrize("case", CASES)
def test_dram_cases_equal(case):
    """The cases of the reference's ``test_core_dram.py`` (and two multi-core
    ones), each a stream both simulators play: every SimResult field equal,
    the float32 energy sums bit for bit (here with ragged f32 energies)."""
    cores = [[dict(r, e_act=a, e_col=b)
              for r, a, b in zip(reqs, *_energies(len(reqs), c))]
             for c, reqs in enumerate(CASES[case])]
    both(cores)


def test_padding_changes_nothing():
    """The padded (C, R) layout is the stream's own: more padding gives the
    same result."""
    cores = CASES["lanes_and_fga"]
    assert_same(dram.simulate(stream(dram, cores, pad=30)),
                dram.simulate(stream(dram, cores, pad=100)))


REQUEST = st.tuples(st.integers(0, 63), st.integers(0, 50), st.booleans(),
                    st.integers(1, 8), st.integers(0, 400), st.booleans(),
                    st.integers(0, 7))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.lists(REQUEST, min_size=1, max_size=40), min_size=1,
                max_size=4),
       st.sampled_from([100, 34, 60]))
def test_random_streams_equal(cores, faw):
    """Random 1-4-core streams (banks, rows, writes, burst lengths, gaps,
    dependences, lanes): the port equals the reference in every field."""
    reqs = [[dict(bank=b, row=r, wr=w, bus=10 * beats, gap=g, dep=d, lane=ln,
                  faw=faw) for (b, r, w, beats, g, d, ln) in core]
            for core in cores]
    reqs = [[dict(q, e_act=a, e_col=e) for q, a, e in zip(
        core, *_energies(len(core), i))] for i, core in enumerate(reqs)]
    res = both(reqs)
    assert res.n_requests == sum(len(c) for c in reqs)


def _one(reqs):
    return dram.simulate(stream(dram, [reqs]))


def test_single_request_latency_exact():
    res = _one([dict()])
    assert res.read_latency_ns == pytest.approx(
        T.tRCD + T.tCL + 40 / 16.0 + dram.CTRL_NS, abs=1.5)


def test_row_hit_faster_than_conflict():
    same_row = _one(CASES["row_hit"][0])
    conflict = _one(CASES["conflict"][0])
    assert same_row.row_hit_rate == pytest.approx(0.5)
    assert conflict.row_hit_rate == 0.0
    assert same_row.read_latency_ns < conflict.read_latency_ns


def test_conflict_pays_trp_and_tras():
    assert _one(CASES["conflict_chain"][0]).total_ps / 1000.0 >= 7 * T.tRC


def test_vbl_shorter_bursts_reduce_bus_pressure():
    full, short = _one(CASES["vbl_full"][0]), _one(CASES["vbl_short"][0])
    assert short.total_ps < full.total_ps
    assert short.read_latency_ns < full.read_latency_ns


def test_faw_reservation_limits_act_rate():
    full, relaxed = _one(CASES["faw_full"][0]), _one(CASES["faw_relaxed"][0])
    assert full.faw_stall_frac > relaxed.faw_stall_frac
    assert full.total_ps >= relaxed.total_ps


def test_dep_serializes():
    assert _one(CASES["dep"][0]).total_ps > _one(CASES["independent"][0]).total_ps


def test_writes_do_not_block_core():
    """The read targets another rank (bank 16): the write backlog on rank 0
    must not delay it."""
    assert _one(CASES["writes"][0]).read_latency_ns < 120


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 63), st.integers(0, 50),
                          st.booleans(), st.integers(1, 8)),
                min_size=1, max_size=40))
def test_random_streams_invariants(rs):
    res = _one([dict(bank=b, row=r, wr=w, bus=10 * beats, gap=50)
                for (b, r, w, beats) in rs])
    assert res.total_ps > 0
    assert res.dram_energy_nj > 0
    assert 0.0 <= res.row_hit_rate <= 1.0
    assert res.n_acts + int(res.row_hit_rate * res.n_requests) \
        <= res.n_requests + 1
    assert np.isfinite(res.ipc).all()
