"""The end-to-end metrics' arithmetic on synthetic timelines: the window's
tokens, the censored time to first token, and a stall that has to move
the time per output token."""

import numpy as np
import pytest

from portbench import serving, spec, trace


class Handle:
    def __init__(self, n):
        self.n = n

    def peek(self):
        return list(range(self.n))


def req(prompt, max_new, submit_t, admit, n, end=None):
    r = serving.Req(0, np.zeros(prompt, np.int32), max_new, submit_t,
                    Handle(n), admit=admit, end=end)
    return r


def read(name, record):
    return spec.reader(name)(record)


def record_of(reqs, ends, t_open, t_close):
    serve = serving._window_numbers(reqs, ends, t_open, t_close)
    return dict(window_s=t_close - t_open, serve=serve)


def test_tokens_and_ttft_with_censoring():
    ends = [0.0, 1.0, 2.0, 3.0, 4.0]  # step k ends at k seconds
    reqs = [
        # set-up request, tokens at steps 0 (two) .. 3: 3 inside (1, 4]
        req(4, 5, -1.0, admit=0, n=5, end=3),
        # submitted in the window at 1.0, first token at step 2 (2.0)
        req(4, 9, 1.0, admit=2, n=4),
        # submitted at 3.0, no token by the close: counts at 4.0
        req(4, 9, 3.0, admit=None, n=0),
        # submitted at the close itself: not in the window
        req(4, 9, 4.0, admit=None, n=0),
    ]
    rec = record_of(reqs, ends, 0.0, 4.0)
    assert rec["serve"]["output_tokens"] == 3 + 4
    assert sorted(rec["serve"]["ttft_s"]) == [1.0, 1.0]
    assert read("output_tokens_per_s", rec) == pytest.approx(7 / 4)
    assert read("ttft_p95_ms", rec) == pytest.approx(1000.0)


def test_a_stall_moves_tpot():
    def run(stall):
        # every tenth step stalls by 0.5 s (an admission's prefill, say)
        steps = [0.02 + (0.5 if stall and k % 10 == 5 else 0.0)
                 for k in range(50)]
        ends = list(np.cumsum(steps))
        reqs = [req(4, 1000, -1.0, admit=0, n=51) for _ in range(4)]
        return read("tpot_p95_ms", record_of(reqs, ends, ends[0],
                                             ends[-1]))
    calm, stalled = run(False), run(True)
    assert calm == pytest.approx(20.0)
    assert stalled > calm + 5


def test_tpot_counts_every_gap_once_and_no_empty_one():
    ends = [0.0, 1.0, 1.5, 3.5, 4.0]  # steps of 1.0, 0.5, 2.0 and 0.5 s
    reqs = [
        # tokens 1 and 2 at step 0, 3 .. 6 at steps 1 .. 4: four gaps,
        # one of them (step 1's) from a token before the window
        req(4, 9, -1.0, admit=0, n=6),
        # admitted at step 3: tokens 1 and 2 share it (no gap), token 3
        # at step 4 ends one gap
        req(4, 9, 3.0, admit=3, n=3),
    ]
    rec = record_of(reqs, ends, 0.5, 4.0)
    assert sorted(map(tuple, rec["serve"]["gaps"])) == [
        (0.5, 1), (0.5, 2), (2.0, 1)]
    # the gaps 0.5, 2.0, 0.5, 0.5: numpy's linear p95
    assert read("tpot_p95_ms", rec) == pytest.approx(
        1e3 * float(np.percentile([0.5, 2.0, 0.5, 0.5], 95)))


def test_counter_and_span_readers():
    rec = dict(window_s=10.0, serve=dict(
        stats=dict(decode_steps=30, waves=4), max_batch=8),
        spans=dict(prefill_device_s=2.0, prefill_tokens=100,
                   wave_device_s=6.0, n_waves=4, wave_flops=989e12 * 0.6,
                   window_s=10.0))
    assert read("batch_occupancy", rec) == pytest.approx(100 * 30 / 32)
    assert read("prefill_ms_per_token", rec) == pytest.approx(20.0)
    assert read("prefill_device_share", rec) == pytest.approx(20.0)
    assert read("wave_ms", rec) == pytest.approx(1500.0)
    assert read("decode_mfu", rec) == pytest.approx(10.0)
    assert read("host_gap_share", rec) == pytest.approx(20.0)


def test_trace_readers_find_nothing_off_the_card():
    rec = dict(window_s=1.0, serve=dict(stats=dict(decode_steps=1, waves=1),
                                        max_batch=1),
               spans=dict(prefill_device_s=None, prefill_tokens=3,
                          wave_device_s=None, n_waves=1, wave_flops=1.0,
                          window_s=1.0))
    for name in ("prefill_ms_per_token", "prefill_device_share", "wave_ms",
                 "decode_mfu", "host_gap_share", "paged_attn_roofline"):
        assert read(name, rec) is None


def test_paged_roofline_reads_the_kernel():
    rec = dict(profile=dict(paged_bound_s=0.5, ops={
        "void sectored_paged_cluster_kernel<bf16>": 2.0, "gemm": 9.0}))
    assert read("paged_attn_roofline", rec) == pytest.approx(25.0)


def test_profile_reduce_busy_gaps_and_names():
    p = trace.Profile.__new__(trace.Profile)
    p.t0, p.t1 = 0.0, 1e-6
    events = [(0, 100, "k1", True), (50, 150, "k2", True),
              (300, 400, "k1", True), (0, 1000, "step", False),
              (160, 350, "wave", False), (0, 1000, "wave", True)]
    p._events = lambda: iter(events)
    r = p.reduce()
    assert r["busy_s"] == pytest.approx(250e-9)
    assert r["calls"] == {"k1": 2, "k2": 1}
    assert r["ops"]["k1"] == pytest.approx(200e-9)
    # the gap 150..300 begins inside "step" only ("wave" starts at 160)
    assert r["idle_gaps"] == [["step", pytest.approx(150e-9)]]
