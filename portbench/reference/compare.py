"""The comparisons that decide a serving cell's ``correct``.

A sample of the requests the run finished, drawn from the seed with the
longest among them, is run through the plain reference once, teacher
forced over each prompt and its served tokens. The number compared is
the widest gap by which a served token's logit lies below the
reference's best logit at that position (greedy decoding serves the
program's best, so a sound program's gaps are rounding-sized, and a
wrong token, cache, page or state opens them wide); beside it the mean
gap over those positions, steadier where rounding alone opens wide
gaps (RWKV6 at depth: ``limits/<cell>.json`` says which numbers a cell
compares). On the sectored path
a second number is the widest gap between the program's sector-history
table and the reference's own (``llama.py`` says why the reference reads
its pages from the program's table).

The control (``control=True``) is the same reference in float8 e4m3, put
in the program's place: at each position the token it puts first is
scored by the float32 reference in the same way. The benchmark's own
runs do not run it; the calibration of the limit does.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact_matmuls
from portbench.reference.precision import F32, FP8

def sample(finished: list, seed: int, n: int) -> list:
    """``n`` of the finished requests (dicts with ``served``): the one
    that served most tokens, then others drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: (-len(finished[i]["served"]), i))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 3])
    rng.shuffle(rest)
    return [finished[i] for i in [order[0], *rest[:n - 1]]]


def sequences(reqs: list) -> list:
    """Each request as the reference takes it: prompt and served tokens
    but the last, the prompt length, which steps ran sectored (the
    prompt's scan never; a decode position as its wave did) and, on the
    sectored path, the program's table after each decode position
    (``tables``: one per wave, NaN before them)."""
    out = []
    for r in reqs:
        prompt = np.asarray(r["prompt"], np.int64)
        served = np.asarray(r["served"], np.int64)
        tokens = np.concatenate([prompt, served[:-1]])
        sect = np.zeros(len(tokens), bool)
        sect[len(prompt):] = np.asarray(r["wave_sectored"], bool)
        seq = dict(tokens=tokens, prompt_len=len(prompt), sectored=sect,
                   served=served)
        waves = r.get("tables")
        if waves is not None:
            tables = torch.full((len(tokens), *waves.shape[1:]),
                                float("nan"), device=waves.device)
            tables[len(prompt):] = waves
            seq["tables"] = tables
        out.append(seq)
    return out


def served_gaps(forward, params, shapes: dict, reqs: list, seq_len: int,
                *, control: bool = False) -> dict:
    """``{"logit_gap": widest gap of the served tokens, "mean_gap": their
    mean gap, "positions": n}`` (and ``table_gap`` on the sectored path)
    from the architecture's reference ``forward``, and, with
    ``control``, the same of the tokens the float8 reference puts first
    (and of its table), prefixed ``control_``."""
    exact_matmuls()
    seqs = sequences(reqs)
    ctrl = None
    with torch.no_grad():
        if control:
            ctrl = [np.zeros(len(q["served"]), np.int64) for q in seqs]

            def take(b, p0, logits):
                j = p0 - (seqs[b]["prompt_len"] - 1)
                ctrl[b][j:j + len(logits)] = torch.argmax(
                    logits, dim=-1).cpu().numpy()
            extra = forward(params, shapes, seqs, seq_len, FP8, take)
            ctrl_extra = {f"control_{k}": v for k, v in extra.items()}
        widest = {"logit_gap": 0.0, "control_logit_gap": 0.0,
                  "positions": 0, "mean_gap": 0.0, "control_mean_gap": 0.0}

        def judge(b, p0, logits):
            q = seqs[b]
            j = p0 - (q["prompt_len"] - 1)
            n = len(logits)
            best = torch.amax(logits, dim=-1)

            def gaps(tokens):
                idx = torch.as_tensor(tokens[j:j + n], device=logits.device)
                return best - logits.gather(1, idx[:, None])[:, 0]

            g = gaps(q["served"])
            widest["logit_gap"] = max(widest["logit_gap"], float(g.max()))
            widest["mean_gap"] += float(g.sum())
            if ctrl is not None:
                cg = gaps(ctrl[b])
                widest["control_logit_gap"] = max(
                    widest["control_logit_gap"], float(cg.max()))
                widest["control_mean_gap"] += float(cg.sum())
            widest["positions"] += n
        widest.update(forward(params, shapes, seqs, seq_len, F32, judge))
    n = max(widest["positions"], 1)
    widest["mean_gap"] /= n
    widest["control_mean_gap"] /= n
    if ctrl is None:
        del widest["control_logit_gap"], widest["control_mean_gap"]
    else:
        widest.update(ctrl_extra)
    return widest
