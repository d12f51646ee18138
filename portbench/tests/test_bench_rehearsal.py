"""A CPU rehearsal of every cell at a small size: the whole run but the
look for a chip, with the program's plain kernels. The run comes out
correct; the control (the reference in float8 in the program's place)
and each fault a serving cell can have, planted under the timed path,
come out not correct.

Readings at this size (sizes below, several seeds): a sound run's logit
gap 0.004-0.010 and table gap under 0.002; the control's logit gap
0.12-0.19. The limits here sit between them; the cells' own limits
(``limits/<cell>.json``) were set on the card at the cells' sizes.
"""

import pytest
import torch

from portbench import run, spec
from portbench.reference import compare

SMALL = {
    "llama": dict(hidden_size=128, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=256,
                  vocab_size=256, num_hidden_layers=2),
    "rwkv6": dict(hidden_size=128, head_size=32, intermediate_size=256,
                  vocab_size=256, num_hidden_layers=2),
}
# short answers, and for the long-answer mix contexts past the five
# pages a sectored wave reads, so that the predictor picks pages
MIX = {
    "yi-6b.decode": {"clients": 2, "serving": {"max_batch": 2},
                     "output_len": {"dist": "loguniform", "lo": 600,
                                    "hi": 640}},
    "rwkv6-1.6b.decode": {"clients": 8, "serving": {"max_batch": 8},
                          "output_len": {"dist": "loguniform", "lo": 40,
                                         "hi": 120}},
    "yi-6b.chat": {"output_len": {"dist": "loguniform", "lo": 8,
                                  "hi": 40}},
}
SECONDS = {"yi-6b.decode": 25.0, "rwkv6-1.6b.decode": 3.0,
           "yi-6b.chat": 4.0}
LIMITS = {"logit_gap": 0.05}
# the windows leave room for a loaded machine: a rehearsal needs finished
# requests, and the answers of the long-answer mix take some 600 waves


def rehearse(cell, traced=False, control=False, seed=2 ** 31 + 5):
    torch.manual_seed(0)
    arch = spec.find_cell(cell).config["architecture"]
    return run.run_cell(cell, seed, SECONDS[cell], traced, device="cpu",
                        shrink=SMALL[arch], mix_over=MIX[cell],
                        control=control, limits=LIMITS)


@pytest.mark.parametrize("cell", list(MIX))
def test_cell_runs_correct(cell):
    res = rehearse(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.find_cell(cell).end_to_end}
    assert res["attempted"] > 0
    rec = res["record"]
    assert rec["check"]["requests"] > 0
    if spec.find_cell(cell).config["serving"]["true_sectored"]:
        assert rec["check"]["table_gap"] < 0.01


def test_traced_run_reads_the_counters():
    res = rehearse("yi-6b.chat", traced=True)
    assert res["correct"]
    # off the card only the counter has something to read
    assert set(res["metrics"]) == {"batch_occupancy"}
    assert res["metrics"]["batch_occupancy"]["value"] == pytest.approx(100.0)


@pytest.mark.parametrize("cell", list(MIX))
def test_control_is_not_correct(cell):
    res = rehearse(cell, control=True)
    check = res["record"]["check"]
    assert check["logit_gap"] <= LIMITS["logit_gap"]
    # the control is judged by the run's own comparison, in the
    # program's stead
    assert set(res["checks"]) == {"control_logit_gap"}
    assert not res["correct"], res["checks"]


def _faulty_waves(monkeypatch, fault):
    from repro_torch.runtime.graphs import clone_tree, copy_tree_
    from repro_torch.serve import session

    wave_for = session.ServeSession._wave_for

    def broken(self, fn, sampled=False):
        wave = wave_for(self, fn, sampled)

        def run_wave(state, token, rows):
            if fault == "state":  # the step leaves its state as it was
                kept = clone_tree(state)
                tok = wave(state, token, rows)
                copy_tree_(state, kept)
                return tok
            tok = wave(state, token, rows)  # a token altered
            return (tok + 1) % self.backend.vocab
        return run_wave
    monkeypatch.setattr(session.ServeSession, "_wave_for", broken)


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("cell", ["yi-6b.decode", "rwkv6-1.6b.decode"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _faulty_waves(monkeypatch, fault)
    res = rehearse(cell)
    assert not res["correct"], res["checks"]


def test_sample_takes_the_longest():
    finished = [dict(served=[0] * n) for n in (5, 50, 7, 9, 11)]
    for seed in (1, 2, 3):
        chosen = compare.sample(finished, seed, 3)
        assert len(chosen[0]["served"]) == 50 and len(chosen) == 3
    assert compare.sample([], 1, 3) == []


@pytest.mark.cuda
def test_card_rehearsal(card):
    res = run.run_cell("yi-6b.chat", 2 ** 31 + 9, 4.0, True, device="cuda",
                       shrink=SMALL["llama"], mix_over=MIX["yi-6b.chat"],
                       limits=LIMITS)
    assert res["correct"]
    assert "wave_ms" in res["metrics"] and "profile" in res["record"]
