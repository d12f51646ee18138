"""The serving driver: a closed loop of clients over one ``ServeSession``.

The session is the program's own (``launch/serve.py:build_session``:
FIFO scheduler, vectorized fused waves, greedy decoding, the default
hysteresis policy), over the benchmark's weights. Each client keeps one
request in flight and submits its next one as soon as the last
finishes, with no think time. Set-up submits every client's first
request and runs the first step, which admits them all (capturing the
prefill graph and building the kernels) and runs the first wave
(capturing it); the window opens then, with every slot decoding, and
runs ``session.step()`` until ``seconds`` have passed.

Every request joins every wave from its admission to its end (there is
no page pool, so no preemption), so token ``j`` of a request admitted at
step ``s`` is produced by step ``s`` (``j`` = 1, the prefill's, and 2,
the first wave's) or ``s + j - 2``; the time of a token is the end of
that step, when the host hands it out. The driver checks this against
the handles' token counts at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import spec, trace, weights, yardstick
from portbench.reference import compare, predictor
from portbench.traffic import Traffic


@dataclasses.dataclass
class Req:
    index: int
    prompt: np.ndarray
    max_new: int
    submit_t: float
    handle: object
    admit: int | None = None  # the step of its first token
    end: int | None = None  # the step of its last token, once done
    slot: int | None = None  # the wave slot it decodes in

    def token_step(self, j: int) -> int:
        """The step that produced token ``j`` (1-based)."""
        return self.admit + max(0, j - 2)


class TableLog:
    """The wave buffer's sector-history table after every step, copied
    on the device (one small copy a step), for the reference to follow
    the program's page choices (``reference/llama.py``)."""

    def __init__(self, chunk: int = 64):
        self.chunk = chunk
        self.chunks: list = []
        self.n = 0

    def record(self, table: torch.Tensor) -> None:
        c, i = divmod(self.n, self.chunk)
        if c == len(self.chunks):
            self.chunks.append(torch.empty((self.chunk, *table.shape),
                                           dtype=table.dtype,
                                           device=table.device))
        self.chunks[c][i].copy_(table)
        self.n += 1

    def rows(self, slot: int, k0: int, k1: int) -> torch.Tensor:
        """``slot``'s tables after steps ``k0 .. k1`` (L, G, P each)."""
        return torch.stack([self.chunks[k // self.chunk][k % self.chunk][
            :, slot] for k in range(k0, k1 + 1)])


def clients_of(mix: dict, opts: dict) -> int:
    n = mix.get("clients", "max_batch")
    return int(opts["max_batch"] if n == "max_batch" else n)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, shrink: dict | None = None,
        control: bool = False) -> dict:
    from repro_torch.launch.serve import build_session
    from repro_torch.serve import Request

    shrink = shrink or {}
    mix = cell.mix
    if mix.get("loop", "closed") != "closed":
        raise ValueError(f"the serving driver runs closed loops, not "
                         f"{mix['loop']!r}")
    opts = spec.serving_options(cell)
    arch = spec.arch(cell.config)
    conf = dict(cell.config, **shrink)
    cfg = arch.program_config(conf)
    s = arch.shapes(conf)
    marks = [("start", time.time())]
    params = weights.make(s, seed, device,
                          dtype=getattr(torch, cell.config["torch_dtype"]))
    n_clients = clients_of(mix, opts)
    seq_len = int(mix["seq_len"])
    marks.append(("weights", time.time()))
    sess = build_session(
        cfg, params, max_batch=int(opts["max_batch"]), scheduler="fifo",
        vectorized=True, true_sectored=bool(opts["true_sectored"]),
        seq_len=seq_len, kernel=opts.get("kernel", "dispatch"),
        policy=opts.get("policy", "hysteresis"), device=device)
    spans = trace.Spans(device) if traced else None
    if traced:
        backend = sess.backend
        backend.prefill_fn = spans.wrap("admit/prefill", backend.prefill_fn,
                                        info=lambda t: int(t.shape[-1]))
        wave_for = sess._wave_for
        sess._wave_for = lambda fn, sampled=False: spans.wrap(
            "wave", wave_for(fn, sampled))
    traffic = Traffic(mix, cfg.vocab, seed, deck_size=n_clients)
    tables = TableLog() if opts["true_sectored"] else None
    reqs: list[Req] = []
    keys: set[bytes] = set()

    def submit(now: float) -> Req:
        r = traffic.take()
        key = r.prompt[:128].tobytes()
        if key in keys:  # the demand merge would join them: not this mix
            raise RuntimeError(f"request {r.index} repeats a prompt")
        keys.add(key)
        h = sess.submit(Request(r.index, r.prompt,
                                 max_new_tokens=r.max_new_tokens))
        req = Req(r.index, r.prompt, r.max_new_tokens, now, h)
        reqs.append(req)
        return req

    clients = [submit(time.perf_counter()) for _ in range(n_clients)]
    pending = list(clients)
    ends: list[float] = []
    sectored: list[bool] = []
    profile = None
    if traced and torch.device(device).type == "cuda":
        # the profiler's trace covers the window's last seconds, the
        # spans' numbers the part before it, which it does not slow
        profile = trace.Profile()
        prof_s = float(mix["trace"]["seconds"])

    def one_step() -> float:
        before = sess.stats["sectored_waves"]
        if spans is not None:
            with spans.span("step"):
                sess.step()
        else:
            sess.step()
        t = time.perf_counter()
        k = len(ends)
        ends.append(t)
        sectored.append(sess.stats["sectored_waves"] > before)
        ctx = (spans.span("client") if spans
               else contextlib.nullcontext())
        with ctx:
            if tables is not None:
                tables.record(sess.batched.table)
            for r in list(pending):
                if r.handle.peek():
                    r.admit = k
                    r.slot = next((i for i, h in enumerate(sess.slots)
                                   if h is r.handle), None)
                    pending.remove(r)
            for c, r in enumerate(clients):
                if r.handle.done:
                    r.end = k
                    clients[c] = submit(t)
                    pending.append(clients[c])
        return t

    marks.append(("session", time.time()))
    one_step()  # set-up: every client admitted, the first wave run
    marks.append(("first_step", time.time()))
    if profile is not None:
        profile.warm()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t_open = time.perf_counter()
    setup_s = time.time() - t_start
    marks.append(("open", t_start + setup_s))
    # where set-up went: process start to the driver, then each part
    setup_parts = dict(before_driver_s=marks[0][1] - t_start, **{
        f"{name}_s": t1 - t0
        for (_, t0), (name, t1) in zip(marks, marks[1:])})
    stats0 = dict(sess.stats)
    first_window_step = len(ends)
    while True:
        t = one_step()
        if t - t_open >= seconds:
            break
        if profile is not None and profile.t0 is None \
                and t - t_open >= seconds - prof_s:
            profile.start()
    if profile is not None and profile.t0 is not None:
        profile.stop()
    t_close = ends[-1]
    stats1 = dict(sess.stats)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    _check_schedule(reqs, len(ends))

    serve = _window_numbers(reqs, ends, t_open, t_close)
    serve["stats"] = {k: stats1[k] - stats0[k] for k in stats1}
    step_ms = np.diff(np.asarray([t_open, *ends[first_window_step:]])) * 1e3
    serve["step_ms"] = dict(p50=float(np.percentile(step_ms, 50)),
                            p90=float(np.percentile(step_ms, 90)),
                            max=float(step_ms.max()),
                            by_fifth=[float(c.mean()) for c in
                                      np.array_split(step_ms, 5)])
    serve["max_batch"] = int(opts["max_batch"])
    record = dict(setup_s=setup_s, setup_parts=setup_parts,
                  window_s=t_close - t_open, serve=serve,
                  attempted=sum(t_open <= r.submit_t < t_close
                                for r in reqs))
    if traced:
        t_spans = (profile.t0 if profile is not None
                   and profile.t0 is not None else t_close)
        record["spans"] = _span_numbers(
            spans, reqs, ends, sectored, first_window_step, t_open, t_spans,
            arch, s, opts, seq_len)
        if profile is not None and profile.t0 is not None:
            t0 = time.perf_counter()
            record["profile"] = profile.reduce()
            record["profile"]["reduce_s"] = time.perf_counter() - t0
            record["profile"]["paged_bound_s"] = _paged_bound(
                reqs, ends, sectored, profile, s, opts, seq_len)

    finished = [dict(prompt=r.prompt, served=r.handle.peek(),
                     wave_sectored=[sectored[r.admit + j - 1]
                                    for j in range(1, r.max_new)],
                     tables=(tables.rows(r.slot, r.admit, r.end)
                             if tables is not None and r.max_new > 1
                             else None))
                for r in reqs if r.end is not None]
    # the program's state goes before the reference runs
    del sess, clients, pending, reqs, one_step, submit, tables
    if spans is not None:
        del backend, wave_for
        spans.records.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    chosen = compare.sample(finished, seed, int(mix["check"]["requests"]))
    t0 = time.perf_counter()
    if chosen:
        gaps = compare.served_gaps(arch.forward, params, s, chosen,
                                   seq_len, control=control)
    else:
        gaps = dict(logit_gap=float("inf"), positions=0)
    gaps["requests"] = len(chosen)
    gaps["served_tokens"] = sum(len(r["served"]) for r in chosen)
    gaps["reference_s"] = time.perf_counter() - t0
    record["check"] = gaps
    return dict(record=record, peak=peak)




def _check_schedule(reqs: list, n_steps: int) -> None:
    """Every request's token count is the one its admission step and the
    steps since imply (see the module docstring)."""
    for r in reqs:
        n = len(r.handle.peek())
        if r.admit is None:
            want = 0
        elif r.end is not None:
            want = r.max_new
            if r.token_step(n) != r.end:
                raise RuntimeError(f"request {r.index}: last token at step "
                                   f"{r.end}, not {r.token_step(n)}")
        else:
            want = min(r.max_new, 2 + (n_steps - 1 - r.admit))
        if n != want:
            raise RuntimeError(f"request {r.index}: {n} tokens where the "
                               f"schedule gives {want}")


def _window_numbers(reqs: list, ends: list, t_open: float,
                    t_close: float) -> dict:
    """Output tokens of the window, each window request's time to its
    first token (the window's end where none came), and every gap
    between two consecutive tokens of a request that both lie in the
    window. Tokens 3 onwards each end one step after the token before
    (see the module docstring), so a gap is the length of the step that
    produced its later token: ``gaps`` holds, for each such step, its
    length and the number of gaps it ends. Token 2 comes in the step of
    token 1 (the prefill's), a gap of none, which is left out."""
    out_tokens, ttft = 0, []
    ending = np.zeros(len(ends), np.int64)
    for r in reqs:
        n = len(r.handle.peek())
        times = [ends[r.token_step(j)] for j in range(1, n + 1)]
        out_tokens += sum(t_open < t <= t_close for t in times)
        if t_open <= r.submit_t < t_close:
            ttft.append((times[0] if times else t_close) - r.submit_t)
        if n >= 3:  # tokens 3 .. n: steps admit + 1 .. admit + n - 2
            ending[r.admit + 1:r.admit + n - 1] += 1
    gaps = [[ends[k] - ends[k - 1], int(ending[k])]
            for k in range(1, len(ends))
            if ending[k] and t_open < ends[k - 1] and ends[k] <= t_close]
    return dict(output_tokens=out_tokens, ttft_s=ttft, gaps=gaps)


def _counts_at(reqs: list, k: int) -> list:
    """Tokens each request in step ``k``'s wave holds, the new one
    included."""
    return [len(r.prompt) + (k - r.admit) + 1 for r in reqs
            if r.admit is not None and r.admit <= k <= r.admit + r.max_new - 2]


def _pages_read(opts: dict, seq_len: int) -> int | None:
    """Pages a sectored wave reads per row, None off the sectored path."""
    if not opts["true_sectored"]:
        return None
    k, probe, _ = predictor.budget(seq_len)
    return k + probe


def _span_numbers(spans, reqs, ends, sectored, first, t_open, t_end, arch,
                  s, opts, seq_len) -> dict:
    """The spans' numbers over the steps that ended in ``(t_open,
    t_end]``: prefill calls, waves, and the waves' model FLOPs."""
    prefill = spans.between("admit/prefill", t_open, t_end)
    waves = spans.records["wave"]
    if len(waves) != len(ends):
        raise RuntimeError(f"{len(waves)} waves in {len(ends)} steps")
    pages = _pages_read(opts, seq_len)
    flops, wave_s = 0.0, 0.0
    last = first
    for k in range(first, len(ends)):
        if ends[k] > t_end:
            break
        last = k + 1
        for c in _counts_at(reqs, k):
            read = (yardstick.attended(c, pages)
                    if pages is not None and sectored[k] else c)
            flops += arch.decode_flops(s, read)
        ev = waves[k][2]
        if ev is not None:
            wave_s += ev[0].elapsed_time(ev[1]) / 1e3
    cuda = bool(prefill) and prefill[0][0] is not None
    return dict(
        n_prefills=len(prefill),
        prefill_tokens=sum(p for _, p in prefill),
        prefill_device_s=sum(x for x, _ in prefill) if cuda else None,
        n_waves=last - first,
        wave_device_s=wave_s if spans.cuda else None,
        wave_flops=flops,
        window_s=(ends[last - 1] if last > first else t_open) - t_open)


def _paged_bound(reqs, ends, sectored, profile, s, opts, seq_len):
    """The least time of the paged-attention calls of the profiled waves
    (each layer's call alike), None where no wave calls the kernel."""
    pages = _pages_read(opts, seq_len)
    if pages is None or opts.get("kernel", "dispatch") == "dispatch":
        return None
    total = 0.0
    for k, t in enumerate(ends):
        if profile.t0 < t <= profile.t1 and sectored[k]:
            nbytes, ops = yardstick.paged_call(
                _counts_at(reqs, k), s["kv_heads"],
                s["heads"] // s["kv_heads"], s["head_dim"], pages)
            total += yardstick.bound(nbytes, ops)["seconds"] * s["layers"]
    return total
