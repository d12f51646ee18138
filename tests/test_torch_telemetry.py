"""The port's DRAM energy and timing model, command timeline, audit,
meter and adaptive policy vs the JAX reference, on the CPU.

Every number here comes from host counters, so the oracle is exact:

* ``core/power`` and ``core/timing`` equal the reference bit for bit over
  grids of sectors, beats and pages (the reference computes in float32
  with weakly typed Python constants; the port casts each one);
* ``obs/commands`` and ``obs/audit`` give equal records on scripted
  schedules, shared groups included;
* ``WaveMeter`` reports equal fields over a scripted run (prefill, waves,
  eviction and resume, a warm prefix, background on and off);
* ``attn_mass_captured`` and ``AdaptiveSectorPolicy`` decide alike, and
  the port's ``(L, slots, Hkv, P)`` slot view gives the reference's mass;
* the serving benches' smoke sessions reproduce the committed
  ``BENCH_latency.json`` / ``BENCH_energy.json`` counter-only legs
  exactly, and the adaptive legs equal a reference run made here;
* the full-width schedule ``chip_smoke.py`` replays on the card gives the
  reference meter's joules and ``dram_ns``;
* the CLI prints the same energy table as the reference's.
"""

import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import small_models
from _torch_port import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as jconfigs
from repro.core import metrics as jmetrics
from repro.core import power as jpower
from repro.core import timing as jtiming
from repro.launch import serve as jlaunch
from repro.obs import audit as jaudit
from repro.obs import commands as jcommands
from repro.runtime import sectored_decode as jsd
from repro.serve import AdaptiveSectorPolicy as JAdaptive
from repro.serve import ServeSession as JServeSession
from repro.serve import Request as JRequest
from repro.telemetry import meters as jmeters
from repro_torch import configs
from repro_torch.core import metrics, power, timing
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import FlightRecorder, audit, commands
from repro_torch.runtime import sectored_decode
from repro_torch.serve import (AdaptiveSectorPolicy, AlwaysDense,
                               AlwaysSectored, Request, ServeSession)
from repro_torch.telemetry import MeteredBackend, meters

ROOT = Path(__file__).resolve().parent.parent
BASELINES = ROOT / "benchmarks" / "baselines"

SECTORS = np.arange(0.0, 8.25, 0.25)  # 0-8 in quarter steps
BEATS = np.concatenate([np.arange(1.0, 9.0), np.arange(0.0, 8.25, 0.25)])


def bits(x) -> np.ndarray:
    """float32 values as their bit patterns (equality = bitwise)."""
    a = np.asarray(x)
    assert a.dtype == np.float32, a.dtype
    return a.view(np.uint32)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the smoke script's host schedule replay, policy log and adaptive
# settings (it imports no torch, JAX or card at module level)
chip_smoke = _load_chip_smoke()


# -- 1. power and timing, bitwise --------------------------------------------


@pytest.mark.parametrize("name,grid", [
    ("act_array_fraction", SECTORS), ("rd_power_fraction", BEATS),
    ("wr_power_fraction", BEATS)])
def test_power_fractions_bitwise(name, grid):
    ref, port = getattr(jpower, name), getattr(power, name)
    np.testing.assert_array_equal(bits(port(grid)), bits(ref(grid)))
    for x in grid:  # the meter calls them on Python scalars
        assert bits(port(float(x))) == bits(ref(float(x)))


@pytest.mark.parametrize("sectored_hw", [True, False])
def test_act_power_and_energies_bitwise(sectored_hw):
    np.testing.assert_array_equal(
        bits(power.act_power_fraction(SECTORS, sectored_hw)),
        bits(jpower.act_power_fraction(SECTORS, sectored_hw)))
    pm, jm = power.DEFAULT_ENERGY, jpower.DEFAULT_ENERGY
    for prop in ("e_act_full", "e_rd_full", "e_wr_full",
                 "p_background_active", "p_background_precharged",
                 "p_refresh"):
        assert getattr(pm, prop) == getattr(jm, prop), prop
    for s in [*SECTORS, 7 / 3, 5 / 3, 13 / 6]:  # fetched/acts ratios
        assert bits(pm.act_energy(s, sectored_hw)) == bits(
            jm.act_energy(s, sectored_hw)), s
    np.testing.assert_array_equal(bits(pm.rd_energy(BEATS)),
                                  bits(jm.rd_energy(BEATS)))
    np.testing.assert_array_equal(bits(pm.wr_energy(BEATS)),
                                  bits(jm.wr_energy(BEATS)))


# pages valid / fetched, with fractional newest pages
VALID = [0.0, 0.0078125, 0.5, 1.0, 1.25, 3.0078125, 4.0625, 5.5, 8.0,
         9.25, 16.0, 17.9921875, 24.0]
FETCHED = [0.0, 0.25, 1.0, 2.5, 4.0078125, 5.0, 9.0, 30.0]


@pytest.mark.parametrize("word_fraction", [1.0, 0.5])
@pytest.mark.parametrize("sectored_hw", [True, False])
def test_kv_fetch_and_append_energy_equal(sectored_hw, word_fraction):
    for page_bytes in (32768.0, 262144.0):  # smoke and yi-6b pages
        for valid in VALID:
            for fetched in FETCHED:
                kw = dict(page_bytes=page_bytes, sectored_hw=sectored_hw,
                          word_fraction=word_fraction)
                assert power.kv_fetch_energy(fetched, valid, **kw) == \
                    jpower.kv_fetch_energy(fetched, valid, **kw), \
                    (fetched, valid, kw)
        assert power.kv_append_energy(page_bytes / 128) == \
            jpower.kv_append_energy(page_bytes / 128)
    assert power.FULL_BURST_BEATS == jpower.FULL_BURST_BEATS


@pytest.mark.parametrize("sectored", [False, True])
def test_processor_power_bitwise(sectored):
    ipc = np.arange(0.0, 4.25, 0.25)
    for cores in (1, 4, 8, 12):
        np.testing.assert_array_equal(
            bits(power.processor_power(ipc, cores, sectored)),
            bits(jpower.processor_power(ipc, cores, sectored)))


def test_timing_bitwise():
    t, jt = timing.DEFAULT_TIMING, jtiming.DEFAULT_TIMING
    assert dataclasses.asdict(t) == dataclasses.asdict(jt)
    assert t.full_burst_time == jt.full_burst_time
    np.testing.assert_array_equal(bits(t.burst_time(BEATS)),
                                  bits(jt.burst_time(BEATS)))
    assert timing.faw_token_rate(t) == jtiming.faw_token_rate(jt)
    cost = power.act_array_fraction(SECTORS)
    np.testing.assert_array_equal(bits(timing.faw_act_cost(cost)),
                                  bits(jtiming.faw_act_cost(cost)))
    rng = np.random.default_rng(3)
    n = 257
    tokens = (rng.random(n) * 4).astype(np.float32)
    last = (rng.random(n) * 100).astype(np.float32)
    now = last + (rng.random(n) * 30).astype(np.float32)
    cost = rng.choice(np.asarray(cost), n).astype(np.float32)
    for a, b in zip(timing.faw_wait(tokens, now, last, cost, t),
                    jtiming.faw_wait(tokens, now, last, cost, jt)):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_metrics_equal():
    for j, n in ((1.5e-3, 7), (0.0, 0), (2.0, -1)):
        assert metrics.dram_energy_per_token(j, n) == \
            jmetrics.dram_energy_per_token(j, n)
    runs = ([1e-3, 2e-3, 0.5e-3], [3, 5, 1])
    assert metrics.aggregate_energy_per_token(*runs) == \
        jmetrics.aggregate_energy_per_token(*runs)
    assert metrics.parallel_speedup(10.0, np.array([4.0, 5.0])) == \
        jmetrics.parallel_speedup(10.0, np.array([4.0, 5.0]))
    assert metrics.weighted_speedup([1, 2], [2, 2]) == \
        jmetrics.weighted_speedup([1, 2], [2, 2])
    assert metrics.llc_mpki(5, 1000) == jmetrics.llc_mpki(5, 1000)


# -- 2. commands and audit ---------------------------------------------------


def _geometries(word_fraction=1.0, total_pages=8, n_layers=2):
    kw = dict(page_size=128, total_pages=total_pages,
              page_kv_bytes=32768.0, n_layers=n_layers,
              kv_word_fraction=word_fraction)
    return meters.KVGeometry(**kw), jmeters.KVGeometry(**kw)


SCHEDULES = {
    "sectored": dict(sectored=True, k_pages=4,
                     slots=[(0, 0, 519), (1, 1, 600)]),
    "narrow_partial": dict(sectored=True, k_pages=2,
                           slots=[(0, 5, 130), (2, 6, 127), (3, 7, 1023)]),
    "dense": dict(sectored=False, k_pages=None,
                  slots=[(0, 0, 0), (1, 3, 767), (2, 4, 1100)]),
    "shared": dict(sectored=True, k_pages=3,
                   slots=[(0, 0, 700), (1, 1, 520), (2, 2, 260)],
                   shared_groups=[{"slots": [0, 1], "shared_tokens": 512},
                                  {"slots": [2], "shared_tokens": 128},
                                  {"slots": [3, 4], "shared_tokens": 0}]),
    "shared_three": dict(sectored=True, k_pages=9,
                         slots=[(0, 0, 1000), (1, 1, 1010), (2, 2, 999)],
                         shared_groups=[{"slots": [0, 1, 2],
                                         "shared_tokens": 300}]),
}


def _records(cmds):
    return [c.to_record() for c in cmds]


def _timeline(tl):
    return tl.to_record(ledger=tl.ledger(), fetch_j=tl.fetch_j,
                        energy_j=tl.energy_j)


@pytest.mark.parametrize("word_fraction", [1.0, 0.5])
@pytest.mark.parametrize("sectored_hw", [True, False])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_wave_commands_and_replay_equal(schedule, sectored_hw,
                                        word_fraction):
    g, jg = _geometries(word_fraction)
    kw = dict(SCHEDULES[schedule], sectored_hw=sectored_hw)
    cmds = commands.wave_commands(g, **kw)
    jcmds = jcommands.wave_commands(jg, **kw)
    assert cmds and _records(cmds) == _records(jcmds)
    tl, jtl = commands.replay(cmds), jcommands.replay(jcmds)
    assert _timeline(tl) == _timeline(jtl)
    by_slot = commands.replay_by_slot(cmds)
    jby_slot = jcommands.replay_by_slot(jcmds)
    assert {s: _timeline(t) for s, t in by_slot.items()} == \
        {s: _timeline(t) for s, t in jby_slot.items()}
    ref, jref = commands.with_refresh(tl), jcommands.with_refresh(jtl)
    assert _timeline(ref) == _timeline(jref)
    assert commands.background_energy(ref) == \
        jcommands.background_energy(jref)


@pytest.mark.parametrize("sectored_hw", [True, False])
def test_prefill_commands_equal(sectored_hw):
    g, jg = _geometries()
    for prompt_len, cached in ((1, 0), (127, 0), (128, 0), (520, 0),
                               (520, 256), (520, 519), (1023, 2000),
                               (0, 0)):
        kw = dict(prompt_len=prompt_len, cached_tokens=cached, rid=3,
                  sectored_hw=sectored_hw)
        cmds = commands.prefill_commands(g, **kw)
        jcmds = jcommands.prefill_commands(jg, **kw)
        assert _records(cmds) == _records(jcmds), kw
        assert _timeline(commands.replay(cmds)) == \
            _timeline(jcommands.replay(jcmds))
    empty = commands.replay([])
    assert _timeline(empty) == _timeline(jcommands.replay([]))
    assert commands.with_refresh(empty) is empty


def test_slot_and_issue_spans_equal():
    for beats in BEATS:
        assert commands.column_slot_ns(beats) == \
            jcommands.column_slot_ns(beats)
    for n_acts in (0.0, 0.5, 1.0, 3.0, 17.25, 400.0):
        for tokens in (0.0, 0.3, 1.0, 5.5, 90.0):
            assert commands.act_issue_span_ns(n_acts, tokens) == \
                jcommands.act_issue_span_ns(n_acts, tokens)


def test_audit_equal():
    meter = dict(act_j=1.0e-6, rd_j=3.0e-6, wr_j=0.0)
    close = dict(act_j=1.0e-6 * (1 + 1e-12), rd_j=3.0e-6, wr_j=1e-31)
    assert audit.reconcile(meter, close, where="w") == \
        jaudit.reconcile(meter, close, where="w")
    ledger = audit.reconcile(meter, close)
    assert audit.max_rel_err(ledger) == jaudit.max_rel_err(ledger) > 0
    assert audit.max_rel_err({}) == jaudit.max_rel_err({}) == 0.0
    for a, b in ((1.0, 1.0 + 1e-9), (0.0, 0.0), (1e-31, 0.0), (2.0, -2.0)):
        assert audit.rel_err(a, b) == jaudit.rel_err(a, b)
    assert audit.AUDIT_REL_TOL == jaudit.AUDIT_REL_TOL
    for bad in (dict(act_j=1.0e-6, rd_j=3.1e-6, wr_j=0.0),
                dict(act_j=1.0e-6, rd_j=3.0e-6)):
        with pytest.raises(audit.AuditError) as got:
            audit.reconcile(meter, bad, where="wave 3")
        with pytest.raises(jaudit.AuditError) as want:
            jaudit.reconcile(meter, bad, where="wave 3")
        assert str(got.value) == str(want.value)


# -- 3. WaveMeter, scripted ----------------------------------------------------


def _tables(rng, shape):
    t = rng.random(shape).astype(np.float32)
    t[..., 3:] *= 0.1
    return t


def _drive(mod, geometry, *, background, sectored_hw, tables):
    """One scripted run: prefills (cold, overlapped, warm prefix), sectored
    and dense waves with attention-mass views, a shared group, an
    eviction and the resumed re-prefill."""
    m = mod.WaveMeter(geometry, background=background,
                      sectored_hw=sectored_hw)
    m.record_prefill(0, 519)
    m.record_prefill(1, 300, overlapped=True)
    m.record_wave(sectored=True, k_pages=3,
                  slots=[(0, 0, 519), (1, 1, 300)], wall_s=0.002,
                  state_views={0: (tables[0], 519), 1: (tables[1], 300)})
    m.record_wave(sectored=False, k_pages=None,
                  slots=[(0, 0, 520), (1, 1, 301)], wall_s=0.001)
    m.record_eviction(1, kv_tokens=302, kv_pages=3)
    m.record_prefill(2, 520, cached_tokens=256)
    m.record_wave(sectored=True, k_pages=2,
                  slots=[(0, 0, 521), (2, 2, 520)],
                  shared_groups=[{"slots": [0, 2], "shared_tokens": 256}],
                  state_views={0: (tables[0], 521), 2: (tables[2], 520)})
    m.record_prefill(1, 302, resumed=True)
    for step in range(3):
        m.record_wave(sectored=True, k_pages=5,
                      slots=[(0, 0, 522 + step), (1, 1, 302 + step),
                             (2, 2, 521 + step)],
                      state_views={s: (tables[s], p) for s, p in
                                   ((0, 522 + step), (1, 302 + step),
                                    (2, 521 + step))})
    return m


@pytest.mark.parametrize("sectored_hw", [True, False])
@pytest.mark.parametrize("background", [False, True])
def test_wave_meter_report_equal(background, sectored_hw):
    g, jg = _geometries(word_fraction=0.5)
    rng = np.random.default_rng(5)
    # slot 1's view is 4-D (L, 1, Hkv, P), as the reference stacks slots
    tables = [_tables(rng, (2, 2, 8)), _tables(rng, (2, 1, 2, 8)),
              _tables(rng, (2, 2, 8))]
    m = _drive(meters, g, background=background, sectored_hw=sectored_hw,
               tables=tables)
    jm = _drive(jmeters, jg, background=background,
                sectored_hw=sectored_hw, tables=tables)
    report, jreport = m.report(), jm.report()
    assert report == jreport
    assert report["audit_checks"] == 10 and report["evictions"] == 1
    assert report["ema"]["attn_mass"] < 1.0  # the views were used
    assert m.per_request == jm.per_request
    assert m.recorder.window() == jm.recorder.window()
    assert _timeline(m.last_timeline) == _timeline(jm.last_timeline)
    assert {r: _timeline(t) for r, t in m.prefill_timelines.items()} == \
        {r: _timeline(t) for r, t in jm.prefill_timelines.items()}
    assert (m.energy_j, m.decode_j, m.background_j) == \
        (jm.energy_j, jm.decode_j, jm.background_j)


def test_kv_geometry_equal():
    for name in ("yi-6b", "qwen3-32b"):
        for red in (False, True):
            cfg, jcfg = configs.get(name), jconfigs.get(name)
            if red:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            kw = dict(seq_len=2048, page_size=128, total_pages=24,
                      kv_word_fraction=0.5)
            assert dataclasses.asdict(
                meters.KVGeometry.from_model_cfg(cfg, **kw)) == \
                dataclasses.asdict(
                    jmeters.KVGeometry.from_model_cfg(jcfg, **kw))


# -- 4. attention mass, the adaptive policy, the slot view ------------------


def test_attn_mass_captured_equal():
    rng = np.random.default_rng(9)
    table = _tables(rng, (3, 2, 12))
    table[1, 1] = 0.0  # a head with no observed mass
    for position in (0, 127, 128, 700, 1535, 5000):
        for k in (1, 2, 3, 5, 12, 40):
            assert meters.attn_mass_captured(table, position, 128, k) == \
                jmeters.attn_mass_captured(table, position, 128, k)


EMA_SCRIPT = [None, 0.9, 0.85, 0.66, 0.5, 0.2, 0.1, 0.1, 0.61, 0.95, 0.95,
              0.95, 0.95, 0.3]


@pytest.mark.parametrize("signal,settings", [
    ("attn_mass", {}),
    ("attn_mass", dict(target_coverage=0.5, deadband=0.15,
                       frac_step=1 / 6, min_frac=1 / 6, init_frac=2 / 6,
                       max_frac=0.5)),
    ("sector_coverage", dict(merge_demands=False))])
def test_adaptive_policy_decides_alike(signal, settings):
    rec, jrec = types.SimpleNamespace(ema={}), types.SimpleNamespace(ema={})
    pol = AdaptiveSectorPolicy(rec, signal=signal, **settings)
    jpol = JAdaptive(jrec, signal=signal, **settings)
    for i, value in enumerate(EMA_SCRIPT):
        for r in (rec, jrec):
            r.ema = ({} if value is None else
                     # attn_mass falls back to sector_coverage until a
                     # mass estimate exists
                     {"sector_coverage": value} if i < 3
                     else {"sector_coverage": 1.0, signal: value})
        d, jd = pol.decide(0.5, {}), jpol.decide(0.5, {})
        assert dataclasses.asdict(d) == dataclasses.asdict(jd), i
    with pytest.raises(ValueError):
        AdaptiveSectorPolicy(rec, init_frac=0.01)


def test_slot_view_gives_the_reference_mass():
    """The port's wave buffer holds the SHT as (L, slots, Hkv, P); the
    reference stacks slots first. Slot s's view must be table[:, s]."""
    L, S, H, P = 3, 4, 2, 8
    gen = torch.Generator().manual_seed(2)
    table = torch.rand((L, S, H, P), generator=gen)
    position = torch.tensor([700, 1000, 0, 900], dtype=torch.int32)
    fake = types.SimpleNamespace(batched=types.SimpleNamespace(
        table=table, position=position))
    views = ServeSession._meter_state_views(fake, [0, 1, 3])
    stacked = table.numpy().transpose(1, 0, 2, 3)[:, :, None]  # (S,L,1,H,P)
    assert sorted(views) == [0, 1, 3]
    mass = {}
    for s, (view, pos) in views.items():
        assert view.shape == (L, H, P) and int(pos) == int(position[s])
        assert not np.shares_memory(view, table.numpy())  # a host copy
        mass[s] = meters.attn_mass_captured(view, int(pos), 128, 2)
        assert mass[s] == jmeters.attn_mass_captured(
            stacked[s][:, 0], int(pos), 128, 2)
    # the reference's slot-first index on the port's layout is a layer
    assert all(0 < mass[s] < 1 for s in (0, 1, 3))
    wrong = meters.attn_mass_captured(table.numpy()[1], 1000, 128, 2)
    assert wrong != mass[1]


# -- 5. the serving benches' smoke sessions ------------------------------------

SMOKE_SEQ_LEN = 768
SMOKE_PROMPT = 520
SMOKE_NEW = 24
BENCHES = {"latency": 0.5, "energy": 0.7}  # their static fractions


def _adaptive(cls, recorder, bench):
    """The benches' adaptive policy, capped at the bench's static
    fraction (``serve_latency``'s settings are ``chip_smoke.ADAPTIVE``)."""
    return cls(recorder, **dict(chip_smoke.ADAPTIVE, max_frac=BENCHES[bench]))


def _smoke_requests(make, vocab):
    rng = np.random.default_rng(0)
    return [make(rid, rng.integers(0, vocab, size=SMOKE_PROMPT)
                 .astype(np.int32), max_new_tokens=SMOKE_NEW)
            for rid in range(2)]


@pytest.fixture(scope="module")
def smoke():
    """The benches' smoke model, the port's three backends sharing one
    prefill cache (prefill is the exact dispatch step whatever the
    kernel), and the reference's dispatch backend for the adaptive
    legs."""
    jcfg, cfg, jparams, params = small_models()
    # the benches' smoke config
    assert jcfg == jconfigs.get("yi-6b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, head_dim=32)
    prefills = {}
    backends = {}
    for kernel in ("dispatch", "fused", "fused_q8"):
        b = sectored_decode.make_serving_fns(
            cfg, params=params, seq_len=SMOKE_SEQ_LEN, min_topk=1,
            kernel=kernel, device="cpu")
        prefill = b.prefill_fn

        def cached(tokens, prefill=prefill):
            key = np.asarray(tokens).tobytes()
            if key not in prefills:
                prefills[key] = prefill(tokens)
            logits, state = prefills[key]
            return logits.clone(), state.clone()
        b.prefill_fn = cached
        backends[kernel] = b
    jinner = jsd.make_serving_fns(jcfg, params=jparams,
                                  seq_len=SMOKE_SEQ_LEN, min_topk=1)
    return dict(cfg=cfg, backends=backends, jinner=jinner, runs={})


def _port_leg(smoke, bench, leg):
    """One drained metered port session of a bench leg (cached)."""
    key = ("port", bench, leg)
    if key in smoke["runs"]:
        return smoke["runs"][key]
    frac = BENCHES[bench]
    inner = smoke["backends"][{"fused": "fused", "quantized": "fused_q8"}
                              .get(leg, "dispatch")]
    backend = MeteredBackend(inner, sectored_hw=leg != "dense")
    policy = chip_smoke.LoggedPolicy(
        AlwaysDense() if leg == "dense"
        else _adaptive(AdaptiveSectorPolicy, backend.meter.recorder, bench)
        if leg == "adaptive" else AlwaysSectored(topk_frac=frac))
    sess = ServeSession(backend, max_batch=2, policy=policy)
    handles = [sess.submit(r) for r in
               _smoke_requests(Request, smoke["cfg"].vocab)]
    sess.run_until_drained()
    assert all(h.done for h in handles)
    smoke["runs"][key] = (backend.meter, policy.fracs, handles)
    return smoke["runs"][key]


def _reference_adaptive(smoke, bench):
    key = ("reference", bench)
    if key not in smoke["runs"]:
        backend = jmeters.MeteredBackend(smoke["jinner"])
        policy = chip_smoke.LoggedPolicy(
            _adaptive(JAdaptive, backend.meter.recorder, bench))
        sess = JServeSession(backend, max_batch=2, policy=policy)
        handles = [sess.submit(r) for r in
                   _smoke_requests(JRequest, smoke["cfg"].vocab)]
        sess.run_until_drained()
        assert all(h.done for h in handles)
        smoke["runs"][key] = (backend.meter, policy.fracs)
    return smoke["runs"][key]


def _per_token(report):
    tokens = report["tokens"]
    decode_tokens = max(tokens - report["prefill_events"], 1)
    return dict(
        dram_ns_per_token=(report["dram_ns"] + report["prefill_dram_ns"])
        / tokens,
        decode_dram_ns_per_token=report["dram_ns"] / decode_tokens,
        j_per_token=metrics.dram_energy_per_token(report["energy_j"],
                                                  tokens),
        decode_j_per_token=metrics.dram_energy_per_token(report["decode_j"],
                                                         tokens))


@pytest.mark.parametrize("bench,leg", [
    ("latency", "dense"), ("latency", "static"), ("latency", "fused"),
    ("latency", "quantized"), ("energy", "dense"), ("energy", "static"),
    ("energy", "quantized")])
def test_bench_leg_matches_committed_baseline(smoke, bench, leg):
    meter, _, _ = _port_leg(smoke, bench, leg)
    report = meter.report()
    got = _per_token(report)
    base = json.loads((BASELINES / f"BENCH_{bench}.json").read_text())
    assert base["static_frac"] == BENCHES[bench]
    keys = (("dram_ns_per_token", "decode_dram_ns_per_token")
            if bench == "latency" else ("j_per_token", "decode_j_per_token"))
    for k in keys:
        assert got[k] == base[k][leg], (k, got[k], base[k][leg])
    assert report["audit_checks"] > 0 and report["audit_max_rel_err"] <= 1e-9
    assert report["tokens"] == 2 * SMOKE_NEW


def test_fused_leg_counts_what_static_counts(smoke):
    """Kernel choice is invisible to the DRAM model: fused == static."""
    static, _, hs = _port_leg(smoke, "latency", "static")
    fused, _, hf = _port_leg(smoke, "latency", "fused")
    report, want = fused.report(), static.report()
    for k in ("dram_ns", "prefill_dram_ns", "energy_j", "tokens"):
        assert report[k] == want[k], k
    assert [h.peek() for h in hf] == [h.peek() for h in hs]


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_adaptive_leg_matches_reference_run(smoke, bench, capsys):
    meter, fracs, _ = _port_leg(smoke, bench, "adaptive")
    jmeter, jfracs = _reference_adaptive(smoke, bench)
    assert fracs == jfracs
    assert len(set(fracs)) > 1  # the policy did adapt
    report, jreport = meter.report(), jmeter.report()
    for k in ("energy_j", "decode_j", "dram_ns", "prefill_dram_ns",
              "tokens", "pages_fetched", "acts", "audit_checks"):
        assert report[k] == jreport[k], k
    assert [r["k_pages"] for r in meter.recorder.window()] == \
        [r["k_pages"] for r in jmeter.recorder.window()]
    # the float signal itself is a tolerance, not an identity: the
    # attention masses come from bf16 models on two stacks (measured
    # 5.5e-5; the SHT tolerance of test_torch_sectored_decode)
    masses = [(r["attn_mass"], j["attn_mass"]) for r, j in
              zip(meter.recorder.window(), jmeter.recorder.window())]
    worst = max(abs(a - b) for a, b in masses)
    with capsys.disabled():
        print(f"\nadaptive ({bench}): topk_frac per wave {fracs}; "
              f"dram_ns/token {_per_token(report)['dram_ns_per_token']}, "
              f"J/token {_per_token(report)['j_per_token']}; largest "
              f"per-wave attn_mass difference port vs reference {worst}")
    assert worst < 2e-3


def test_session_meter_equals_the_host_schedule(smoke):
    """The schedule ``chip_smoke.py`` replays on the host is what the
    session meters: FIFO admits every request before the first wave, no
    stop token, ``total_pages`` is the backend's ``pages``."""
    for leg, frac in (("static", 0.5), ("dense", None)):
        meter = _port_leg(smoke, "latency", leg)[0]
        backend = smoke["backends"]["dispatch"]
        k = (None if frac is None
             else backend.k_for(frac) + backend.probe_pages_for(
                 backend.k_for(frac)))
        replayed = chip_smoke.schedule_meter(
            meters, backend.kv_geometry(), [SMOKE_PROMPT] * 2,
            [k] * (SMOKE_NEW - 1), sectored_hw=leg != "dense")
        assert backend.kv_geometry().total_pages == backend.pages
        for key in ("energy_j", "dram_ns", "prefill_dram_ns", "tokens"):
            assert replayed.report()[key] == meter.report()[key], (leg, key)


# -- 6. the chip_smoke.py schedule at full yi-6b width -------------------------

# the reference meter's figures for this schedule (energy to 6 digits)
CHIP_EXPECTED = {  # flavor: (energy J, decode dram_ns, prefill dram_ns)
    "fused": (0.179429, 164352618.75, 32030885.0),
    "fused_q8": (0.118956, 82330218.75, 32030885.0),
    "coarse": (0.251907, 242995818.75, 32030885.0),
}


@pytest.mark.parametrize("flavor", sorted(CHIP_EXPECTED))
def test_chip_smoke_schedule_matches_reference_meter(flavor):
    wf = 0.5 if flavor == "fused_q8" else 1.0
    kw = dict(seq_len=2048, page_size=128, total_pages=24,
              kv_word_fraction=wf)
    g = meters.KVGeometry.from_model_cfg(configs.get("yi-6b"), **kw)
    jg = jmeters.KVGeometry.from_model_cfg(jconfigs.get("yi-6b"), **kw)
    schedule = dict(prompt_lengths=list(chip_smoke.PROMPT_LENGTHS),
                    k_per_wave=[4 + 1] * chip_smoke.WAVES,
                    sectored_hw=flavor != "coarse")
    m = chip_smoke.schedule_meter(meters, g, **schedule)
    jm = chip_smoke.schedule_meter(jmeters, jg, **schedule)
    assert m.report() == jm.report()
    report = m.report()
    energy, decode_ns, prefill_ns = CHIP_EXPECTED[flavor]
    assert round(report["energy_j"], 6) == energy
    assert report["dram_ns"] == decode_ns
    assert report["prefill_dram_ns"] == prefill_ns
    assert report["tokens"] == 64
    assert report["audit_checks"] == 19 and report["audit_max_rel_err"] == 0


# -- 7. the CLI ------------------------------------------------------------------


def _energy_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("waves=", "pages fetched", "DRAM energy",
                                "modeled DRAM time", "energy audit",
                                "  rid="))]


@pytest.mark.parametrize("policy", ["sectored", "adaptive"])
def test_cli_energy_table_on_cpu(capsys, policy):
    args = ["--arch", "yi-6b", "--reduced", "--requests", "3",
            "--max-new-tokens", "3", "--max-batch", "2", "--true-sectored",
            "--policy", policy, "--telemetry"]
    stats = launch_serve.main(args + ["--fused-kernel", "--device", "cpu"])
    port = capsys.readouterr().out
    assert stats["completed"] == 3 and "-- telemetry" in port
    lines = _energy_lines(port)
    assert any(line.startswith("DRAM energy") and "uJ/token" in line
               for line in lines)
    assert any("ns/token (modeled from counters" in line for line in lines)
    if policy == "sectored":
        # counters only: the same table as the reference's (the wall
        # time and the kernel are not in it)
        jlaunch.main(args)
        ref = capsys.readouterr().out
        strip = [line.split("| wall=")[0] for line in lines]
        want = [line.split("| wall=")[0] for line in _energy_lines(ref)]
        assert strip == want


def test_cli_trace_out_and_background(tmp_path, capsys):
    out = tmp_path / "trace.jsonl"
    launch_serve.main(["--arch", "yi-6b", "--reduced", "--requests", "2",
                       "--max-new-tokens", "3", "--true-sectored",
                       "--policy", "sectored", "--telemetry", "--bg-energy",
                       "--trace-out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert " bg=" in text and "wrote per-wave trace" in text
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows and all("dram_ns" in r and "bg_j" in r for r in rows)


def test_build_session_meters_the_backend():
    _, cfg, _, params = small_models()
    sess = launch_serve.build_session(cfg, params, true_sectored=True,
                                      policy="adaptive", seq_len=384,
                                      device="cpu")
    assert sess.meter is not None
    assert isinstance(sess.policy, AdaptiveSectorPolicy)
    assert sess.policy.recorder is sess.meter.recorder
    with pytest.raises(ValueError):
        launch_serve.build_policy("adaptive")
    # the flight recorder is ported; so is the mesh, which a process
    # started alone can hold at one rank only
    obs = FlightRecorder()
    traced = launch_serve.build_session(cfg, params, true_sectored=True,
                                        telemetry=True, obs=obs,
                                        seq_len=384, device="cpu")
    assert traced.obs is obs and obs.meter is traced.meter
    with pytest.raises(ValueError, match="needs 2 devices"):
        launch_serve.build_session(cfg, params, true_sectored=True,
                                   telemetry=True, mesh="2",
                                   seq_len=384, device="cpu")
    for kernel, fraction in (("fused", 1.0), ("fused_q8", 0.5)):
        backend = sectored_decode.make_serving_fns(
            cfg, params=params, seq_len=384, kernel=kernel, device="cpu")
        geometry = backend.kv_geometry()
        assert geometry.kv_word_fraction == fraction
        assert geometry.total_pages == backend.pages
