"""Serving launcher of the port (counterpart of the JAX package's
``launch/serve.py``).

``python -m repro_torch.launch.serve --arch yi-6b --reduced
[--true-sectored [--fused-kernel [--kv-quant]]] [--temperature T ...]``

* without ``--true-sectored`` — the dense path: slots hold the model's
  DecodeState, prefill is ``model.prefill`` (one forward pass) and every
  wave runs ``model.decode_step``;
* ``--true-sectored`` — slots hold SectoredState: exact mode (every valid
  page) when the policy says dense, predictor top-k when it says
  sectored, with the shared-prefix demand OR-merge before each fetch;
* ``--fused-kernel`` (needs ``--true-sectored``) — narrow sectored steps
  read and attend their pages in the CUDA kernel
  (``csrc/sectored_attention_paged.cu``); ``--kv-quant`` feeds it
  per-sector int8 KV.

``--telemetry`` wraps the backend in a ``MeteredBackend``: every prefill
and wave is charged on the host against the paper's DDR4 power model and
replayed through its command timeline, and an end-of-run table prints
DRAM joules per token and modeled DRAM ns per token (model outputs, not
measurements of the card). ``--trace-out`` dumps the per-wave trace as
JSONL; ``--bg-energy`` adds the modeled background/refresh component.
``--policy adaptive`` runs the coverage-driven ``AdaptiveSectorPolicy``
over the meter's recorder (implies ``--telemetry``).

``--temperature`` > 0 samples every ``--sample-every``'th request (the
rest stay greedy and share its waves) with ``--top-k`` / ``--top-p`` and
the seed ``--seed + rid``, printed as a provenance column; the sampler
runs on the device inside the wave.

``--scheduler overlap`` prefills queued prompts while the decode wave is
in flight (``overlapped_prefills`` counts them) with paged-KV admission;
``--engine looped`` runs the per-slot reference wave. ``--kv-pages N``
bounds the resident KV pages (``--kv-page-size`` tokens each): admission
waits when the pool is full and growth preempts the youngest requests,
which resume by re-prefill. ``--prefix-cache`` (needs
``--true-sectored``) seeds admissions from earlier prompts' cached
states and prefills only the suffix; ``--shared-prefix N`` prepends N
common tokens to every prompt so it hits. ``--obs`` attaches the flight
recorder (spans on the virtual step clock, a metrics table at the end),
``--obs-trace-out`` / ``--obs-perfetto-out`` export its spans as JSONL /
Perfetto JSON, and ``--obs-commands`` (with ``--telemetry``) adds each
metered wave's DRAM command timeline.

Runs on the GPU, where decode waves (and the sectored prefill steps)
replay captured CUDA graphs, unless ``--device cpu`` is given; the dense
prefill runs eagerly, its shapes following the prompt. Parameters are
random, from a seeded generator. The mesh is a later slice of the port.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import metrics
from repro_torch.kernels import backend as kbackend
from repro_torch.models import model
from repro_torch.obs import (FlightRecorder, MetricsRegistry, write_jsonl,
                             write_perfetto)
from repro_torch.runtime import sectored_decode
from repro_torch.runtime.graphs import Step
from repro_torch.sample import SamplerSpec
from repro_torch.serve import (AdaptiveSectorPolicy, AlwaysDense,
                               AlwaysSectored, FifoScheduler,
                               HysteresisPolicy, KVPagePool, OverlapScheduler,
                               PrefixCache, Request, ServeSession,
                               ServingBackend)
from repro_torch.telemetry import MeteredBackend
from repro_torch.telemetry.meters import KVGeometry

POLICIES = {"hysteresis": HysteresisPolicy, "dense": AlwaysDense,
            "sectored": AlwaysSectored}


class DenseBackend(ServingBackend):
    """The dense DecodeState data path (the reference's ``build_backend``
    without ``--true-sectored``), for every family: prefill is
    ``model.prefill``, decode is ``model.decode_step``, and for uniform
    attention stacks the "sectored" step is that same decode (the
    policy's toggle then changes nothing but the stats); an
    attention-free or hybrid stack has no sectored step, as in the
    reference.

    On the card (``graphs=True``) the decode step and the session's waves
    over it replay captured CUDA graphs in one memory pool, where the
    reference jits them; prefill runs eagerly, its shapes following the
    prompt (the reference's jit retraces per length). ``graphs=False``
    runs everything eagerly; a CPU backend always does.
    """

    def __init__(self, cfg, params, *, sectored: bool = True, device=None,
                 graphs: bool = True):
        self.device = kbackend.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.graphs = graphs and self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None

        def step_(state, token):
            return model.decode_step_(params, cfg, state, token)
        decode = Step(step_, graphs=self.graphs, pool=self.pool)
        sectored = sectored and not cfg.attn_free and not cfg.layer_pattern
        super().__init__(self._prefill, decode, decode if sectored else None,
                         vocab=cfg.vocab, device=self.device)

    def token_capacity(self, prompt_len: int) -> int | None:
        """The most tokens (prompt plus generated) a request's state
        holds: a hybrid's local-attention cache rows, None where the
        state grows with the prompt's padding. Past its rows the
        reference's one-hot append silently writes nothing, so the
        session refuses such a request at submit."""
        if self.cfg.uniform_layers or self.cfg.attn_free:
            return None
        return model.local_cache_rows(self.cfg, prompt_len)

    def _prefill(self, tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                 device=self.device)
        return model.prefill(self.params, self.cfg, tokens)


def build_backend(cfg, params, *, sectored=True, true_sectored=False,
                  seq_len=256, kernel="dispatch", device=None, graphs=True):
    """The data path: SectoredState-backed (``true_sectored``) or the
    dense :class:`DenseBackend`.

    ``kernel`` picks the sectored decode flavor: ``"dispatch"`` (gather +
    attend in torch), ``"fused"`` (the CUDA kernel) or ``"fused_q8"``
    (the kernel over per-sector int8 KV). On the card the steps, waves and
    sectored prefill replay captured CUDA graphs; ``graphs=False`` runs
    them eagerly.
    """
    if true_sectored and (cfg.attn_free or cfg.layer_pattern):
        raise ValueError(
            f"--true-sectored needs uniform attention layers; arch "
            f"{cfg.name!r} is attention-free or hybrid. Drop the flag to "
            f"serve it on the dense path.")
    if kernel != "dispatch" and not true_sectored:
        raise ValueError(
            "--fused-kernel/--kv-quant need --true-sectored (the dense "
            "DecodeState backend has no paged KV for the kernel to steer)")
    if not true_sectored:
        return DenseBackend(cfg, params, sectored=sectored, device=device,
                            graphs=graphs)
    backend = sectored_decode.make_serving_fns(cfg, params=params,
                                               seq_len=seq_len, kernel=kernel,
                                               device=device, graphs=graphs)
    if not sectored:
        backend.sectored_fn = None
    return backend


def build_policy(name, recorder=None):
    """Shipped SectorPolicy lineup (``--policy``); ``adaptive`` needs the
    meter's TraceRecorder as its coverage source."""
    if name == "adaptive":
        if recorder is None:
            raise ValueError("adaptive policy needs telemetry "
                             "(pass --telemetry / a recorder)")
        return AdaptiveSectorPolicy(recorder)
    return POLICIES[name]()


def build_session(cfg, params, *, max_batch=4, sectored=True,
                  scheduler="fifo", vectorized=True, true_sectored=False,
                  seq_len=256, telemetry=False, policy="hysteresis",
                  mesh=None, bg_energy=False, page_pool=None,
                  prefix_cache=None, obs=None, kernel="dispatch",
                  device=None, graphs=True) -> ServeSession:
    """A ServeSession over the port's backend, on ``device`` (None = GPU).
    On the GPU its waves and prefill replay captured CUDA graphs;
    ``graphs=False`` runs them eagerly. ``telemetry`` (implied by
    ``policy="adaptive"``) meters the backend; ``scheduler`` is "fifo" or
    "overlap"; ``vectorized=False`` runs the looped wave."""
    if mesh is not None:
        raise NotImplementedError("the mesh is a later slice of the port")
    backend = build_backend(cfg, params, sectored=sectored,
                            true_sectored=true_sectored, seq_len=seq_len,
                            kernel=kernel, device=device, graphs=graphs)
    if telemetry or policy == "adaptive":
        # the dense backend carries no kv_geometry(); derive one from the
        # model config so the meter can convert counters to joules
        geometry = (None if true_sectored else KVGeometry.from_model_cfg(
            cfg, seq_len=seq_len, page_size=sectored_decode.PAGE_SIZE))
        backend = MeteredBackend(backend, geometry=geometry,
                                 background=bg_energy)
        if policy == "adaptive" and backend.k_for(None) is None:
            # without a per-k backend the adaptive fraction would be a
            # silent no-op reported as adaptive results — refuse loudly
            raise ValueError(
                "--policy adaptive needs a backend that resolves topk_frac "
                "to a page budget; add --true-sectored")
        pol = build_policy(policy, backend.meter.recorder)
    else:
        pol = build_policy(policy)
    sched = OverlapScheduler() if scheduler == "overlap" else FifoScheduler()
    return ServeSession(backend, max_batch=max_batch, scheduler=sched,
                        policy=pol, vectorized=vectorized,
                        page_pool=page_pool, prefix_cache=prefix_cache,
                        obs=obs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--engine", choices=["vectorized", "looped"],
                    default="vectorized",
                    help="vectorized: one wave over all slots; looped: the "
                         "per-slot reference wave")
    ap.add_argument("--scheduler", choices=["fifo", "overlap"],
                    default="fifo",
                    help="fifo: blocking admission; overlap: prefill "
                         "double-buffered against the in-flight wave")
    ap.add_argument("--true-sectored", action="store_true",
                    help="serve on SectoredState (exact/top-k paths + "
                         "shared-prefix demand merge)")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="with --true-sectored: read and attend the "
                         "selected pages in the CUDA kernel")
    ap.add_argument("--kv-quant", action="store_true",
                    help="with --fused-kernel: per-sector int8 KV, "
                         "dequantized inside the kernel (tolerance-gated)")
    ap.add_argument("--telemetry", action="store_true",
                    help="meter every wave against the DRAM power model "
                         "and print an end-of-run energy/coverage table")
    ap.add_argument("--policy", default="hysteresis",
                    choices=[*POLICIES, "adaptive"],
                    help="SectorPolicy; adaptive = coverage-driven topk_frac "
                         "(implies --telemetry)")
    ap.add_argument("--trace-out", default=None,
                    help="with --telemetry: dump the per-wave trace JSONL "
                         "here")
    ap.add_argument("--obs", action="store_true",
                    help="attach the flight recorder: per-request span "
                         "tracing on the virtual step clock plus a serving "
                         "metrics table at the end (token streams, "
                         "logprobs and joules are the same with it on or "
                         "off)")
    ap.add_argument("--obs-trace-out", default=None, metavar="PATH",
                    help="with --obs: export the span trace as JSONL")
    ap.add_argument("--obs-perfetto-out", default=None, metavar="PATH",
                    help="with --obs: export the span trace as Chrome/"
                         "Perfetto trace_event JSON")
    ap.add_argument("--obs-commands", action="store_true",
                    help="with --obs and --telemetry: record every metered "
                         "wave's and prefill's DRAM command timeline; the "
                         "Perfetto export grows a 'dram commands' track and "
                         "--obs-trace-out a sibling .commands.jsonl file")
    ap.add_argument("--bg-energy", action="store_true",
                    help="with --telemetry: add the modeled background/"
                         "refresh energy component (derived from the "
                         "timing model, never wall-clock)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 (default) = greedy. "
                         "> 0 samples every --sample-every'th request")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base RNG seed; request rid samples with seed "
                         "(--seed + rid), printed as the provenance column")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="sample every Nth request, leave the rest greedy "
                         "(mixed batches share one fused wave)")
    ap.add_argument("--stop-token", type=int, action="append", default=None,
                    metavar="ID", dest="stop_tokens",
                    help="EOS contract: a request finishes the moment it "
                         "emits this token id (repeatable, up to 8)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="KV page pool capacity (pages); admission waits "
                         "when full and growth preempts the youngest "
                         "requests, which resume by re-prefill. Default: "
                         "unbounded")
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="tokens per pool page (default: the sectored "
                         "runtime's page of 128)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request radix prefix cache: seed admissions "
                         "from earlier prompts' cached states and prefill "
                         "only the suffix (needs --true-sectored)")
    ap.add_argument("--prefix-cache-pages", type=int, default=64,
                    help="prefix cache capacity in KV pages (LRU over "
                         "unreferenced entries; default 64)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend N common tokens to every prompt so "
                         "--prefix-cache hits (0 = independent prompts)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.sample_every < 1:
        ap.error("--sample-every must be >= 1")
    if args.temperature == 0 and (args.top_k or args.top_p < 1.0
                                  or args.seed or args.sample_every != 1):
        # a filter/seed/stride without a temperature would silently
        # decode greedy: refuse instead of faking a sampling run
        ap.error("--top-k/--top-p/--seed/--sample-every need "
                 "--temperature > 0 (temperature 0 is greedy decoding)")
    if (args.obs_trace_out or args.obs_perfetto_out) and not args.obs:
        ap.error("--obs-trace-out/--obs-perfetto-out need --obs (there is "
                 "no span trace to export without the flight recorder)")
    if args.obs_commands and not args.obs:
        ap.error("--obs-commands needs --obs (the command track rides on "
                 "the flight recorder)")
    if args.obs_commands and not (args.telemetry
                                  or args.policy == "adaptive"):
        ap.error("--obs-commands needs --telemetry (the command timeline "
                 "is synthesized from the meter's counters)")
    if args.kv_page_size is not None and args.kv_pages is None:
        ap.error("--kv-page-size needs --kv-pages (an unbounded pool has "
                 "no page granularity to configure)")
    if args.kv_quant and not args.fused_kernel:
        ap.error("--kv-quant needs --fused-kernel (dequant runs inside "
                 "the fused kernel; the dispatch path reads full-width)")
    if args.fused_kernel and not args.true_sectored:
        ap.error("--fused-kernel needs --true-sectored (the dense backend "
                 "has no paged KV for the kernel to steer)")
    if args.prefix_cache and not args.true_sectored:
        ap.error("--prefix-cache needs --true-sectored (the dense backend "
                 "has no prefix-seeding hooks)")
    if args.shared_prefix and not args.prefix_cache:
        ap.error("--shared-prefix needs --prefix-cache (shared tokens "
                 "without a cache would just be re-prefilled every time)")

    device = kbackend.resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model.init_params(cfg, seed=0, device=device)
    kernel = ("fused_q8" if args.kv_quant
              else "fused" if args.fused_kernel else "dispatch")
    telemetry = args.telemetry or args.policy == "adaptive"
    # the cache's page quantum follows the pool's, so shared and private
    # pages account in the same currency (the session checks it)
    page_kwargs = ({} if args.kv_page_size is None
                   else dict(page_size=args.kv_page_size))
    page_pool = (KVPagePool(args.kv_pages, **page_kwargs)
                 if args.kv_pages is not None else None)
    prefix_cache = (PrefixCache(args.prefix_cache_pages, **page_kwargs)
                    if args.prefix_cache else None)
    obs = (FlightRecorder(MetricsRegistry(), commands=args.obs_commands)
           if args.obs else None)
    sess = build_session(cfg, params, max_batch=args.max_batch,
                         scheduler=args.scheduler,
                         vectorized=args.engine == "vectorized",
                         true_sectored=args.true_sectored,
                         telemetry=telemetry, policy=args.policy,
                         bg_energy=args.bg_energy, page_pool=page_pool,
                         prefix_cache=prefix_cache, obs=obs, kernel=kernel,
                         device=device)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab,
                          size=args.shared_prefix).astype(np.int32)
    handles = []
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=8 + rid % 5).astype(np.int32)
        if args.shared_prefix:
            prompt = np.concatenate([shared, prompt])
        sampler = None
        if args.temperature > 0 and rid % args.sample_every == 0:
            # seed = --seed + rid, printed below, so any one stream can
            # be replayed alone
            sampler = SamplerSpec(temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.seed + rid)
        handles.append(sess.submit(Request(
            rid, prompt, max_new_tokens=args.max_new_tokens,
            sampler=sampler, stop_tokens=tuple(args.stop_tokens or ()))))
    stats = sess.run_until_drained()
    if not all(h.done for h in handles):
        raise RuntimeError("session drained with unfinished requests")
    pool_tag = ("" if sess.page_pool is None
                else f"preemptions={stats['preemptions']} "
                     f"kv_peak_pages={sess.page_pool.peak_pages} ")
    prefix_tag = ""
    if sess.prefix_cache is not None:
        c = sess.prefix_cache
        prefix_tag = (f"prefix_hits={c.stats['hits']}/"
                      f"{c.stats['hits'] + c.stats['misses']} "
                      f"(rate={c.hit_rate:.2f}) "
                      f"prefix_hit_tokens={c.stats['hit_tokens']} "
                      f"shared_pages_held={c.held_pages} "
                      f"cow_copies={c.stats['cow_copies']} "
                      f"prefix_evictions={c.stats['evictions']} ")
    print(f"arch={cfg.name} device={device} kernel={kernel} "
          f"engine={args.engine} scheduler={args.scheduler} "
          f"completed={stats['completed']} "
          f"decode_steps={stats['decode_steps']} waves={stats['waves']} "
          f"sectored_steps={stats['sectored_steps']} "
          f"merged_slots={stats['merged_slots']} "
          f"overlapped_prefills={stats['overlapped_prefills']} "
          f"eos_stops={stats['eos_stops']} {pool_tag}{prefix_tag}"
          f"kv_bytes_saved_at_32k="
          f"{sectored_decode.bytes_saved_fraction(32768):.2f}")
    if args.temperature > 0:
        print_seed_provenance(handles, base_seed=args.seed)
    if telemetry:
        print_energy_report(sess, handles, trace_out=args.trace_out)
    if obs is not None:
        print_obs_report(obs, trace_out=args.obs_trace_out,
                         perfetto_out=args.obs_perfetto_out)
    return stats


def print_seed_provenance(handles, *, base_seed: int, limit: int = 16) -> None:
    """Per-request seed provenance: how each stream's RNG identity was
    derived, so any one of them can be replayed alone."""
    print(f"-- sampling (base seed {base_seed}; per-request seed = "
          f"base + rid) ------------------")
    for h in handles[:limit]:
        spec = h.request.sampler
        desc = spec.describe() if spec is not None else "greedy"
        print(f"  rid={h.rid:3d} sampler={desc:28s} tokens={len(h.peek())}")
    if len(handles) > limit:
        print(f"  ... {len(handles) - limit} more requests")


def print_energy_report(sess, handles, *, trace_out=None) -> None:
    """End-of-run energy/coverage table from the session's WaveMeter (the
    reference's table; joules and DRAM time are DDR4-model outputs from
    host counters, not measurements of the device)."""
    meter = sess.meter
    report = meter.report()
    tokens = report["tokens"]
    ema = report["ema"]
    print("-- telemetry ---------------------------------------------------")
    print(f"waves={report['waves']} (sectored={report['sectored_waves']} "
          f"dense={report['dense_waves']}) tokens={tokens} "
          f"demand_merges={report['demand_merges']}")
    print(f"pages fetched/valid: {report['pages_fetched']:.1f}/"
          f"{report['pages_valid']:.1f} "
          f"(coverage={report['sector_coverage']:.3f}, "
          f"EMA={ema.get('sector_coverage', float('nan')):.3f}, "
          f"attn-mass EMA={ema.get('attn_mass', float('nan')):.3f})")
    bg = ""
    if report["bg_j"] or report["ref_j"]:
        bg = (f" bg={report['bg_j'] * 1e3:.3f} "
              f"refresh={report['ref_j'] * 1e3:.3f}")
    per_token = metrics.dram_energy_per_token(report["energy_j"], tokens)
    print(f"DRAM energy: {report['energy_j'] * 1e3:.3f} mJ "
          f"(act={report['act_j'] * 1e3:.3f} rd={report['rd_j'] * 1e3:.3f} "
          f"wr={report['wr_j'] * 1e3:.3f} "
          f"prefill={report['prefill_j'] * 1e3:.3f}{bg}) "
          f"| {per_token * 1e6:.3f} uJ/token "
          f"| wall={report['wall_s']:.3f}s")
    if report.get("prefix_hit_tokens") or report.get("shared_act_j"):
        shared_mj = (report["shared_act_j"] + report["shared_rd_j"]) * 1e3
        print(f"prefix reuse: {report['prefix_hit_tokens']} prompt tokens "
              f"served from cache; shared-fetch amortization credited "
              f"{shared_mj:.3f} mJ across co-readers")
    total_ns = report["dram_ns"] + report["prefill_dram_ns"]
    print(f"modeled DRAM time: {total_ns * 1e-3:.3f} us "
          f"(decode={report['dram_ns'] * 1e-3:.3f} "
          f"prefill={report['prefill_dram_ns'] * 1e-3:.3f}) "
          f"| {total_ns / tokens if tokens else 0.0:.1f} ns/token "
          f"(modeled from counters, not wall-clock)")
    if report["audit_checks"]:
        print(f"energy audit: {report['audit_checks']} reconciliations, "
              f"max rel err {report['audit_max_rel_err']:.3e} "
              f"(tolerance 1e-9)")
    for h in handles[:8]:
        t = h.telemetry
        uj = metrics.dram_energy_per_token(t["energy_j"], t["tokens"]) * 1e6
        print(f"  rid={h.rid:3d} tokens={t['tokens']:4d} "
              f"energy={t['energy_j'] * 1e6:9.3f} uJ ({uj:.3f} uJ/tok)")
    if len(handles) > 8:
        print(f"  ... {len(handles) - 8} more requests")
    if trace_out:
        path = meter.recorder.to_jsonl(trace_out)
        print(f"wrote per-wave trace: {path}")


def print_obs_report(obs, *, trace_out=None, perfetto_out=None) -> None:
    """Flight-recorder summary: the metrics snapshot table plus optional
    span-trace exports (JSONL and/or Perfetto; command-timeline records,
    when traced, ride along as a .commands.jsonl sibling and a dedicated
    Perfetto track)."""
    spans = obs.spans()
    commands = obs.command_records if obs.trace_commands else None
    print("-- flight recorder ---------------------------------------------")
    tag = (f" command_records={len(commands)}" if commands is not None
           else "")
    print(f"steps={obs.step} spans={len(spans)}{tag}")
    print(MetricsRegistry.render(obs.snapshot()))
    if trace_out:
        path = write_jsonl(spans, trace_out)
        print(f"wrote span trace: {path}")
        if commands is not None:
            cmd_path = write_jsonl(
                commands, str(trace_out) + ".commands.jsonl")
            print(f"wrote command trace: {cmd_path}")
    if perfetto_out:
        path = write_perfetto(spans, perfetto_out, commands=commands)
        print(f"wrote perfetto trace: {path} "
              f"(open in ui.perfetto.dev or chrome://tracing)")


if __name__ == "__main__":
    main()
