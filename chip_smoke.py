"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--quick]

From the root of a checkout: builds the port's CUDA kernels from
``src/repro_torch/csrc`` with nvcc, then runs these phases, each printing
one JSON line:

1. card — ``nvidia-smi`` name and power limit; build — seconds, the
   ``-Xptxas -v`` lines of every source (registers, shared memory,
   spills) and the count of ``HGMMA`` (``wgmma``) instructions in the
   flash library's SASS (``cuobjdump``; "not available" without it);
2. kernels — each kernel (paged sectored attention, bf16 and int8) vs its
   plain PyTorch version on the same CUDA tensors at the yi-6b serving
   shapes, at the mask edges, at K = P = 24 with ragged lengths (the
   cluster's largest slice) and at K = 1 with one valid token, with its
   time, the plain version's time, one PyTorch yardstick call and the
   card's bound; and at qwen3-moe's shapes (rep = 16, P = 16, K = 5,
   ragged lengths), timed too;
   ops — the ``repro_torch.kernels.ops`` path: head-major sectored
   attention (f32, bf16), VBL gather and causal flash attention (bf16,
   f32) called once each at realistic sizes with every launch counter at
   0 just before and read just after (each must be > 0), then each kernel
   vs its plain version over a sweep (VBL bitwise) and timed like the
   paged kernel;
3. main path — ``build_session`` serving 4 requests of ~768-token
   prompts at full yi-6b width (32 layers, random bf16 weights from a
   seeded generator) with the fused kernel and with int8 KV
   (``fused_q8``), each twice in one call: its prefill steps and decode
   waves as replays of captured CUDA graphs (the default on the card),
   metered (``build_session(telemetry=True)``, the CLI's
   ``--telemetry``), then eagerly (``graphs=False``) and unmetered,
   reusing the first run's prefill states (prefill does not depend on the
   kernel). Graph and eager must give bitwise equal token streams,
   logprobs and final wave buffers, so metering changes none of them; the
   prefill graph is held bitwise against, and timed beside, one prompt
   prefilled eagerly. Each run reports ms per wave, tokens/s, prefill s
   and peak memory; launch counters, which replays advance by the
   launches their capture holds, must equal n_layers x sectored waves.
   The exact (prefill) step and the fused wave run under torch.profiler
   eagerly and replayed (device time by kernel, the device's idle share;
   each wave must run the paged kernel once per layer, in a non-zero
   time); one wave from the final state compares fused with dispatch (and
   reports fused_q8's logprob error); the 4 requests served with
   ``dispatch`` give the greedy streams the fused ones are compared with
   (the first divergence, if any, with its logit gaps); two more metered
   graph runs over the ``fused`` backend: coarse-grained DRAM
   (``sectored_hw=False``) and ``AdaptiveSectorPolicy`` with the
   reference ``serve_latency`` bench's settings; then the ``metering``
   line: for ``fused``, ``fused_q8``, coarse and adaptive, J/token,
   modeled DRAM ns/token (decode and prefill ``dram_ns``), sector
   coverage, the attention-mass EMA, the double-entry audit and the
   meter's host ms per wave (its wave descriptor with the table copy,
   and ``record_wave``), and the adaptive leg's per-wave ``topk_frac``
   and graph captures. Each metered run must equal, in ``energy_j``,
   ``dram_ns``, ``prefill_dram_ns`` and ``tokens``, a fresh meter driven
   on the host with the schedule it ran (:func:`schedule_meter`); the
   audit must stay within 1e-9; J/token and ns/token must order
   fused_q8 < fused < coarse. Joules and ``dram_ns`` are outputs of the
   DDR4 model on host counters, not measurements of the card. Then the
   reference's int8 gate (fused_q8 vs dispatch logprob error
   <= LOGPROB_TOL, teacher-forced) on the reduced config it is defined
   for;
3b. the serving layer at full width (the first 16 of the 32 layers),
   metered, graphs on —
   ``batch_invariance``: one exact step for the same row at batch 1 and
   at batch 4, bitwise or its largest differences;
   ``serve_layer_exact`` (leg A, ``AlwaysDense`` over the fused backend,
   4 prompts of one shared page plus distinct tails, 24 new tokens across
   the 256-token boundary): FIFO without a pool (the oracle), overlap
   with a preempting page pool, and overlap with the pool, a prefix cache
   and the flight recorder; every request bitwise the oracle's before its
   first preemption and after it too when the card is batch-invariant,
   else parting only at a near tie (TIE_ULPS) with logprobs within
   LOGIT_TOL; the cold run preempts, the warm one hits 3 times, preempts
   less and meters fewer prefill joules;
   ``serve_layer_fused`` (leg B, the fused kernel under ``AlwaysSectored``,
   6 prompts of 4 shared pages plus distinct tails, half sampled, 24 new
   tokens across the 768-token boundary, overlap, pool, cache): served
   with the recorder (and command timelines) on and off, tokens,
   logprobs, per-request joules and ``dram_ns`` and the meter's totals
   bitwise equal, each meter equal to the host replay of the schedule it
   was driven with (resumed and warm prefills included), the paged kernel
   launched n_layers times a wave; cold and warm prefill device ms, wave
   ms, hits, preemptions, peak memory and the Perfetto file's size;
3c. the other model families —
   ``moe_sectored`` (leg C): qwen3-moe-235b-a22b at full width, 8 of its
   94 layers (the experts of all 94 would need 454 GB), ``seq_len`` 1024,
   4 greedy prompts of 700-720 tokens, 16 new tokens, ``fused`` and
   ``dispatch`` under ``AlwaysSectored``, each with graphs (metered) and
   eagerly from one set of prefilled states: graph == eager bitwise;
   in the fused eager run every fused attention call held to dispatch on
   the same inputs (ATTN_REL_TOL, ATTN_TABLE_TOL); every routing flip between
   the two eager runs shown to come from rounding (inputs within
   FLIP_INPUT_ULPS at a request's first flip, a router near tie, a
   capacity drop beside an earlier row's flip) and the logits within
   LOGIT_TOL before each request's first flip; meters equal to their
   host replays; the paged kernel (rep = 16) launched once a layer a
   wave; every recorded MoE call held to a plain per-assignment f32 MoE
   on the same rows (MOE_REF_TOL, the same assignments kept), with the
   capacity's dropped assignments per layer;
   ``dense_families`` (leg D): rwkv6-1.6b and recurrentgemma-2b at full
   width and depth on the dense path, 4 greedy prompts of 500-600
   tokens, 16 new tokens, with graphs and eagerly (bitwise), and the
   first prompt's prefill state held to a token-by-token chain of the
   eager decode step, lengths and position equal: at full depth every
   layer within tol + slope x layer (DEPTH_SLOPE), again with f32
   weights and state (the witness that the bf16 gap is rounding; every
   layer within WITNESS_TOL), and on the first pattern of layers
   (REC_TOL, KV_TOL, greedy streams parting only at a near tie);
4. cli — ``repro_torch.launch.serve.main`` (reduced config): with
   ``--telemetry`` (it prints the energy table); with the serving layer's
   flags (``--scheduler overlap --kv-pages --prefix-cache --shared-prefix
   --obs --obs-commands --engine looped``), which must preempt; the dense
   path sampling; qwen3-moe with ``--true-sectored --fused-kernel``,
   rwkv6 and recurrentgemma on the dense path, on the card by default.

Then a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without that line. Without CUDA, or without the repository around this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same data sheet
TPU_KERNEL = "src/repro/kernels/sectored_attention.py:283"
KERNEL_SOURCE = "src/repro_torch/csrc/sectored_attention_paged.cu"
# the paged kernel's name in a profile (one cluster launch per call)
PAGED_KERNEL = "sectored_paged_cluster_kernel"
# the kernels of the kernels.ops path: (CUDA source, Pallas call replaced)
OPS_KERNELS = {
    "sectored_attention": ("src/repro_torch/csrc/sectored_attention.cu",
                           "src/repro/kernels/sectored_attention.py:206"),
    "vbl_gather": ("src/repro_torch/csrc/vbl_gather.cu",
                   "src/repro/kernels/vbl_gather.py:63"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86"),
}

# kernel vs plain on the same CUDA tensors: f32 outputs of size ~1.
# bf16 flavor: sums in another order move e by f32 ulps, which can flip
# bf16(e) by one bf16 ulp (2**-8 relative) on a few weights and move out
# by up to 2**-8 * e * |v| (|v| < 5 here); int8 flavor keeps e in f32.
KERNEL_TOL = {"bf16": {"out": 2e-2, "mass": 1e-5},
              "int8": {"out": 1e-4, "mass": 1e-5}}
# full-width serving: fused vs dispatch bf16 logits (|logit| up to ~8,
# bf16 ulp 0.03 there) after 32 layers of the attention difference above
LOGIT_TOL = 0.25
TABLE_TOL = 1e-3  # SHT entries are EMA masses in [0, 1]
# kernels.ops path, kernel vs plain on the same CUDA tensors. Head-major
# sectored attention: f32 arithmetic on both sides for either input dtype
# (bf16 upcasts exactly, e stays f32), sums in another order, outputs of
# size ~1. Flash: the reference's own allclose tolerances (rtol = atol,
# tests/test_kernels.py); in bf16 both sides round an f32 result, at most
# one bf16 ulp (2**-8 relative) apart. VBL gather moves bits: bitwise.
HEAD_MAJOR_TOL = 1e-5
FLASH_TOL = {"f32": 2e-5, "bf16": 2e-2}

# the paged kernel at leg C's shapes (qwen3-moe, seq_len 1024)
MOE_KERNEL_CASE = dict(B=4, Hkv=4, rep=16, hd=128, page=128, P=16, K=5)

# the main path's schedule: 4 prompts, 16 tokens each (the prefill's and
# 15 waves'), all 4 admitted before the first wave
PROMPT_LENGTHS = (768, 770, 790, 800)
NEW_TOKENS = 16
WAVES = NEW_TOKENS - 1
# the adaptive leg: the reference serve_latency bench's settings
ADAPTIVE = dict(target_coverage=0.5, deadband=0.15, frac_step=1 / 6,
                min_frac=1 / 6, init_frac=2 / 6, max_frac=0.5)
AUDIT_TOL = 1e-9  # the reference's double-entry audit tolerance
# the sampled leg: requests 0 and 2 sample with these, 1 and 3 are greedy
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# the card's draws vs the CPU's: bits and uniforms bitwise; the Gumbel
# noise may differ by an ulp of each log, so a token may differ only where
# the two highest perturbed scores lie within this many ulps
GUMBEL_ULPS = 4
RNG_SEEDS = (0, 1, 3, 2**31, 2**32 - 1)
RNG_POSITIONS = (0, 1, 2, 127, 4095)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_lines(build) -> dict:
    """The ``-Xptxas -v`` lines of each source this process built: entry
    function, registers, shared memory, stack and spills."""
    keys = ("Compiling entry", "registers", "spill", "smem")
    return {name: [line.strip() for line in log.splitlines()
                   if any(k in line for k in keys)]
            for name, log in build.build_logs.items()}


def hgmma_count(build):
    """How many ``HGMMA`` (``wgmma``) instructions the flash library's
    SASS holds, from ``cuobjdump -sass``; "not available" where the
    toolkit has no ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "not available"
    lib = build._target("flash_attention")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        return "not available"
    return sum("HGMMA" in line for line in sass.stdout.splitlines())


# -- timing ------------------------------------------------------------------


def time_ms(fn, torch, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events around each call).

    A 1 GiB write runs before each call: the 50 MB L2 then holds none of
    the inputs, as a decode step finds its KV pages, and the card is
    still busy with it (about 0.3 ms) while the host enqueues ``fn``, so
    the host's overhead of one wrapper call does not show as idle time
    between the events (a chain of many small ops, like a plain version,
    still shows it: that is what it costs)."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2: kernels vs plain -------------------------------------------------


def make_case(torch, gen, *, B, Hkv, rep, hd, page, P, K, lengths,
              shared=False, head_major=False, dtype=None):
    """q, K/V pages, page_idx and length: page-major pages in bf16 (the
    serving layout) or, with ``head_major``, (B, Hkv, P, page, hd) pages
    in ``dtype``."""
    dev = gen.device
    dtype = dtype or torch.bfloat16
    shape = (B, Hkv, P, page, hd) if head_major else (B, P, page, Hkv, hd)
    q = torch.randn((B, Hkv, rep, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    heads = 1 if shared else Hkv
    rows = []
    for b in range(B):
        # like the predictor: the page being written, then others that
        # hold valid tokens, ascending
        n_valid = min(P, (lengths[b] - 1) // page + 1)
        for _ in range(heads):
            perm = torch.randperm(P, generator=gen, device=dev)
            order = torch.cat([perm[perm < n_valid], perm[perm >= n_valid]])
            cur = torch.tensor([n_valid - 1], device=dev)
            rest = order[order != n_valid - 1][:K - 1]
            rows.append(torch.sort(torch.cat([cur, rest])).values)
    idx = torch.stack(rows).reshape(B, heads, K).to(torch.int32)
    return q, kp, vp, idx, length


def case_bytes_ops(case, flavor, scales):
    """Least bytes and operations for one call: each input read once
    (only the selected pages' valid tokens of K and V), each output
    written once; 4*rep*hd operations per valid token (QK and PV)."""
    q, kp, _, idx, length = case
    B, Hkv, rep, hd = q.shape
    page = kp.shape[2]
    K = idx.shape[-1]
    starts = idx.long().expand(B, Hkv, K) * page
    valid = (length.long()[:, None, None] - starts).clamp(0, page)
    tokens = int(valid.sum())
    kv_item = 2 if flavor == "bf16" else 1
    nbytes = (q.numel() * 2 + idx.numel() * 4 + length.numel() * 4
              + 2 * tokens * hd * kv_item
              + (2 * B * Hkv * K * 4 if scales else 0)
              + B * Hkv * rep * hd * 4 + B * Hkv * K * 4)
    ops = 4 * rep * hd * tokens
    return nbytes, ops


def kernel_phase(torch, sa, qkv, dev="cuda", timed=True):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    serving = dict(B=4, Hkv=4, rep=8, hd=128, page=128, P=24, K=5)
    cases = {
        "serving": dict(serving, lengths=[769, 800, 700, 896]),
        "shared_heads": dict(serving, lengths=[769, 800, 700, 896],
                             shared=True),
        "ragged": dict(serving, lengths=[1, 130, 2000, 3072]),
        "k_page_minus_1": dict(serving, lengths=[5 * 128 - 1] * 4),
        "k_page": dict(serving, lengths=[5 * 128] * 4),
        "k_page_plus_1": dict(serving, lengths=[5 * 128 + 1] * 4),
        "k_eq_p": dict(serving, P=5, lengths=[640, 600, 129, 1]),
        # K = P = 24 at ragged lengths: the cluster's largest slice (8
        # blocks of 384 token slots)
        "k_eq_p_24_ragged": dict(serving, K=24, lengths=[1, 1000, 2049, 3072]),
        "k1_len1": dict(serving, K=1, lengths=[1, 1, 1, 1]),
        # qwen3-moe's 64 query heads over 4 KV heads (rep = 16, the whole
        # 16-row mma tile) at leg C's pages: P = 16 padded pages, k = 4 +
        # 1 probe, ragged lengths of its waves and at the mask edges
        "moe_rep16": dict(MOE_KERNEL_CASE, lengths=[701, 709, 716, 733]),
        "moe_rep16_ragged": dict(MOE_KERNEL_CASE, lengths=[1, 129, 1000,
                                                           2048]),
    }
    results, worst = [], {"bf16": 0.0, "int8": 0.0}
    timing = {}
    for name, spec in cases.items():
        case = make_case(torch, gen, **spec)
        q, kp, vp, idx, length = case
        for flavor in ("bf16", "int8"):
            if flavor == "int8":
                kq, ks = qkv.quantize_pages(kp)
                vq, vs = qkv.quantize_pages(vp)
                args = (q, kq, vq, idx, length)
                kw = dict(k_scale=ks, v_scale=vs)
            else:
                args, kw = (q, kp, vp, idx, length), {}
            out, mass = sa.sectored_attention_paged(*args, **kw)
            if timed:
                torch.cuda.synchronize()
            ref_out, ref_mass = sa.sectored_attention_paged_ref(*args, **kw)
            err_out = float((out - ref_out).abs().max())
            err_mass = float((mass - ref_mass).abs().max())
            tol = KERNEL_TOL[flavor]
            ok = (err_out <= tol["out"] and err_mass <= tol["mass"]
                  and bool(torch.isfinite(out).all()))
            worst[flavor] = max(worst[flavor], err_out, err_mass)
            results.append(dict(case=name, flavor=flavor, err_out=err_out,
                                err_mass=err_mass, ok=ok))
            if not ok:
                fail(f"kernel {flavor} disagrees with its plain version "
                     f"on case {name}: out err {err_out}, mass err "
                     f"{err_mass} (tolerance {tol})")
            if name in ("serving", "moe_rep16") and timed:
                key = flavor if name == "serving" else f"{flavor}_rep16"
                timing[key] = time_flavor(torch, sa, case, flavor, args, kw)
    return results, worst, timing


def time_flavor(torch, sa, case, flavor, args, kw):
    import torch.nn.functional as F
    ms = time_ms(lambda: sa.sectored_attention_paged(*args, **kw), torch)
    plain_ms = time_ms(
        lambda: sa.sectored_attention_paged_ref(*args, **kw), torch)
    library_ms = None
    if flavor == "bf16":
        # yardstick: one SDPA call over the already gathered pages (no
        # gather, no per-page mass) — timed here, never used by the port
        q, kp, vp, idx, length = case
        B, Hkv, rep, hd = q.shape
        page = kp.shape[2]
        pages = idx.expand(B, Hkv, idx.shape[-1])
        k_sel = sa.gather_pages(kp, pages).reshape(B, Hkv, -1, hd)
        v_sel = sa.gather_pages(vp, pages).reshape(B, Hkv, -1, hd)
        pos = (pages.long()[..., None] * page
               + torch.arange(page, device="cuda")).reshape(B, Hkv, 1, -1)
        mask = pos < length.long()[:, None, None, None]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k_sel, v_sel, attn_mask=mask), torch)
    nbytes, ops = case_bytes_ops(case, flavor, bool(kw))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[flavor] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


# -- phase 2b: the kernels.ops path ------------------------------------------------


def bound(nbytes: int, ops: int, ops_per_s: float):
    """The least time the card could take: bytes at the HBM rate or
    operations at ``ops_per_s``, whichever is longer."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def peak_ops(torch, dtype) -> float:
    return H100_OPS_PER_S["bf16"] if dtype == torch.bfloat16 \
        else H100_F32_OPS_PER_S


def head_major_cases(torch, gen, dtype):
    """The paged phase's cases over the head-major layout, plus page 256,
    head widths 32 and 256, and slices too large to load whole (the tiled
    walk, head_major_plan: 16 blocks of 256 slots of hd 256); the first is
    the decode shape the ops path runs and times."""
    decode = dict(B=4, Hkv=4, rep=8, hd=128, page=128, P=16, K=5)
    specs = {
        "decode": dict(decode, lengths=[1500, 1800, 2000, 2048]),
        "shared_heads": dict(decode, lengths=[769, 800, 700, 896],
                             shared=True),
        "ragged": dict(decode, lengths=[1, 130, 1000, 2048]),
        "k_page_minus_1": dict(decode, lengths=[5 * 128 - 1] * 4),
        "k_page": dict(decode, lengths=[5 * 128] * 4),
        "k_page_plus_1": dict(decode, lengths=[5 * 128 + 1] * 4),
        "k_eq_p": dict(decode, P=5, lengths=[640, 600, 129, 1]),
        "page_256": dict(decode, page=256, P=8, K=4,
                         lengths=[2048, 1000, 257, 255]),
        "hd_32": dict(decode, hd=32, lengths=[1500, 1, 700, 2048]),
        "hd_256": dict(decode, hd=256, lengths=[1500, 1, 700, 2048]),
        "tiled": dict(B=2, Hkv=2, rep=8, hd=256, page=256, P=16, K=16,
                      lengths=[4096, 2500]),
    }
    return {name: make_case(torch, gen, head_major=True, dtype=dtype, **spec)
            for name, spec in specs.items()}


def head_major_bound(torch, case):
    """Each input read once (only the selected pages' valid tokens of K and
    V), the output written once; 4*rep*hd operations per valid token."""
    q, kp, _, idx, length = case
    B, Hkv, rep, hd = q.shape
    page, K = kp.shape[3], idx.shape[-1]
    starts = idx.long().expand(B, Hkv, K) * page
    tokens = int((length.long()[:, None, None] - starts).clamp(0, page).sum())
    nbytes = (q.numel() * q.element_size() + idx.numel() * 4
              + length.numel() * 4 + 2 * tokens * hd * kp.element_size()
              + B * Hkv * rep * hd * 4)
    return bound(nbytes, 4 * rep * hd * tokens, peak_ops(torch, q.dtype))


def flash_bound(torch, q, causal=True):
    """q, k, v read once and the output written once; 4*hd operations per
    (query, key) pair the mask keeps: S(S+1)/2 of them per head when
    causal."""
    B, H, S, hd = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return bound(4 * q.numel() * q.element_size(), 4 * B * H * pairs * hd,
                 peak_ops(torch, q.dtype))


def vbl_case(torch, gen, N, W, dtype):
    data = torch.randn((N, 8, W), generator=gen, device=gen.device)
    data = (data * 1000).to(dtype) if dtype == torch.int32 else data.to(dtype)
    masks = torch.randint(0, 2 ** 32, (N,), generator=gen, device=gen.device,
                          dtype=torch.int64)
    masks[:3] = torch.tensor([0xFF, 0x00, 0xFFFFFF00], device=gen.device)
    return data, masks  # int64 holding uint32 values


def vbl_bound(torch, data, masks):
    """Enabled sectors read once, all 8 slots written once, masks read and
    counts written; no arithmetic."""
    N, _, W = data.shape
    enabled = int(((masks.to(torch.int64)[:, None]
                    >> torch.arange(8, device=data.device)) & 1).sum())
    item = data.element_size()
    return bound(enabled * W * item + N * 8 * W * item + 8 * N, 0, 1.0)


def ops_phase(torch, ops, sa, vg, fa):
    """The kernels.ops path at realistic sizes, then every new kernel vs its
    plain version, then times. Returns (record, kernel entries)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    hm = {"f32": head_major_cases(torch, gen, torch.float32),
          "bf16": head_major_cases(torch, gen, torch.bfloat16)}
    data, masks = vbl_case(torch, gen, 65536, 128, torch.float32)
    vbl_in = (data, masks.to(torch.uint32))
    flash_in = {flavor: [torch.randn((1, 32, 2048, 128), generator=gen,
                                     device="cuda").to(dt)
                         for _ in range(3)]
                for flavor, dt in (("bf16", torch.bfloat16),
                                   ("f32", torch.float32))}

    # the path: every counter at 0 just before, read just after
    ops.reset_launches()
    path_out = {f"sectored_attention_{f}": ops.sectored_attention(
        *cases["decode"]) for f, cases in hm.items()}
    path_out["vbl_gather"] = ops.vbl_gather(*vbl_in)
    for flavor, qkv in flash_in.items():
        path_out[f"flash_attention_{flavor}"] = ops.flash_attention(
            *qkv, causal=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in path_out}
    if any(n == 0 for n in launches.values()):
        fail(f"a kernel of the kernels.ops path was never launched: "
             f"{launches}")

    worst, n_checks = ops_checks(torch, ops, sa, vg, fa, gen, hm, vbl_in,
                                 flash_in, path_out)
    timing = ops_times(torch, ops, sa, vg, fa, hm, vbl_in, flash_in)
    entries = []
    for name in path_out:
        source, replaces = OPS_KERNELS[name.removesuffix("_f32")
                                       .removesuffix("_bf16")]
        t = timing[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path="kernels.ops", launches=launches[name],
            max_abs_err=worst[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
    record = dict(phase="ops", launches=launches, max_abs_err=worst,
                  checks=n_checks, timing=timing)
    return record, entries


def ops_checks(torch, ops, sa, vg, fa, gen, hm, vbl_in, flash_in, path_out):
    """Each new kernel vs its plain version on the same CUDA tensors: the
    path's outputs, then a sweep of cases. Fails on any miss; returns the
    max abs error by kernel and the number of cases."""
    worst = {name: 0.0 for name in path_out}
    n_checks = [0]

    def check(name, case, ok, err):
        worst[name] = max(worst[name], err)
        n_checks[0] += 1
        if not ok:
            fail(f"{name} disagrees with its plain version on case {case}: "
                 f"max abs err {err}")

    for flavor, cases in hm.items():
        name = f"sectored_attention_{flavor}"
        for case_name, case in cases.items():
            got = (path_out[name] if case_name == "decode"
                   else ops.sectored_attention(*case))
            err = float((got - sa.sectored_attention_ref(*case)).abs().max())
            check(name, case_name, err <= HEAD_MAJOR_TOL
                  and bool(torch.isfinite(got).all()), err)

    vbl_cases = {"path": (vbl_in, path_out["vbl_gather"])}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for W in (128, 3):
            data, masks = vbl_case(torch, gen, 1000, W, dt)
            for mdt in (torch.uint32, torch.int32, torch.int64):
                args = (data, masks.to(mdt))
                vbl_cases[f"{dt}_w{W}_{mdt}"] = (args, ops.vbl_gather(*args))
    for case_name, (args, (out, counts)) in vbl_cases.items():
        want, want_counts = vg.vbl_gather_ref(*args)
        view = {torch.bfloat16: torch.int16,
                torch.float32: torch.int32}.get(out.dtype, out.dtype)
        same = (torch.equal(out.view(view), want.view(view))
                and torch.equal(counts, want_counts)
                and counts[:3].tolist() == [8, 0, 0])
        check("vbl_gather", case_name, same,
              float((out.float() - want.float()).abs().max()))

    flash_cases = {f"{f}_path": (f, qkv, {}, path_out[f"flash_attention_{f}"])
                   for f, qkv in flash_in.items()}
    for flavor, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for shape in ((1, 1, 128, 64), (2, 2, 256, 64), (1, 4, 256, 128),
                      (2, 1, 512, 32), (1, 2, 32, 32), (1, 2, 32, 64),
                      (1, 2, 32, 128)):
            qkv = [torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for _ in range(3)]
            for causal in (True, False):
                flash_cases[f"{flavor}_{shape}_causal={causal}"] = (
                    flavor, qkv, dict(causal=causal), None)
    qkv = [torch.randn((1, 2, 256, 64), generator=gen, device="cuda")
           for _ in range(3)]
    for bq, bk in ((64, 128), (128, 64), (64, 64)):  # tests/test_kernels.py
        flash_cases[f"f32_blocks_{bq}x{bk}"] = (
            "f32", qkv, dict(block_q=bq, block_k=bk), None)
    for case_name, (flavor, qkv, kw, got) in flash_cases.items():
        if got is None:
            got = ops.flash_attention(*qkv, **kw)
        want = fa.flash_attention_ref(*qkv, kw.get("causal", True))
        diff = (got.float() - want.float()).abs()
        tol = FLASH_TOL[flavor]
        check(f"flash_attention_{flavor}", case_name,
              bool((diff <= tol + tol * want.float().abs()).all())
              and got.dtype == qkv[0].dtype, float(diff.max()))
    return worst, n_checks[0]


def ops_times(torch, ops, sa, vg, fa, hm, vbl_in, flash_in):
    """Each new kernel at the path's sizes: its time, its plain version's,
    one PyTorch call computing the same function (the yardstick, never
    used by the port) and the card's bound."""
    import torch.nn.functional as F
    timing = {}
    for flavor, cases in hm.items():
        case = cases["decode"]
        q, kp, vp, idx, length = case
        B, Hkv, _, hd = q.shape
        page = kp.shape[3]
        pages = idx.expand(B, Hkv, idx.shape[-1]).long()
        b = torch.arange(B, device="cuda")[:, None, None]
        h = torch.arange(Hkv, device="cuda")[None, :, None]
        k_sel = kp[b, h, pages].reshape(B, Hkv, -1, hd)
        v_sel = vp[b, h, pages].reshape(B, Hkv, -1, hd)
        pos = pages[..., None] * page + torch.arange(page, device="cuda")
        mask = (pos < length.long()[:, None, None, None]).reshape(
            B, Hkv, 1, -1)
        timing[f"sectored_attention_{flavor}"] = dict(
            ms=time_ms(lambda: ops.sectored_attention(*case), torch),
            plain_ms=time_ms(lambda: sa.sectored_attention_ref(*case), torch),
            # SDPA over the already gathered pages, with the validity mask
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k_sel, v_sel, attn_mask=mask), torch),
            **head_major_bound(torch, case))

    data, masks = vbl_in
    # one row gather (index_select) over the sectors with a zero row
    # appended, its index worked out outside the timing
    rows = data.reshape(-1, data.shape[-1])
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    bits = (masks.to(torch.int64)[:, None]
            >> torch.arange(8, device="cuda")) & 1
    dest = torch.cumsum(bits, 1) - 1
    index = torch.full((data.shape[0], 8), rows.shape[0], dtype=torch.int64,
                       device="cuda")
    n, s = torch.nonzero(bits, as_tuple=True)
    index[n, dest[n, s]] = n * 8 + s
    index = index.reshape(-1)
    if not torch.equal(torch.index_select(padded, 0, index).view_as(data),
                       vg.vbl_gather_ref(data, masks)[0]):
        fail("the vbl_gather yardstick does not compute the same function")
    timing["vbl_gather"] = dict(
        ms=time_ms(lambda: ops.vbl_gather(data, masks), torch),
        plain_ms=time_ms(lambda: vg.vbl_gather_ref(data, masks), torch),
        library_ms=time_ms(lambda: torch.index_select(padded, 0, index),
                           torch),
        **vbl_bound(torch, data, masks))
    del padded, index

    for flavor, qkv in flash_in.items():
        timing[f"flash_attention_{flavor}"] = dict(
            ms=time_ms(lambda: ops.flash_attention(*qkv), torch),
            plain_ms=time_ms(lambda: fa.flash_attention_ref(*qkv), torch),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *qkv, is_causal=True), torch),
            **flash_bound(torch, qkv[0]))
    return timing


# -- phase 3: the main path ----------------------------------------------------


def schedule_meter(meters, geometry, prompt_lengths=(), k_per_wave=(), *,
                   sectored_hw=True, events=None):
    """A fresh ``meters.WaveMeter`` driven on the host with a schedule; no
    device value enters.

    By default the schedule a FIFO session runs when every request is
    admitted before the first wave and none stops early: each prompt's
    prefill in request order, then one wave per entry of ``k_per_wave``
    (the pages a slot fetches, probe included; None for a dense wave),
    request r in slot r at position ``len(prompt_r) + w`` in wave w.
    ``events`` gives any other schedule instead, as logged by
    :func:`log_schedule`: ``("prefill", kwargs of record_prefill)``
    (resumed and warm ``cached_tokens`` prefills included) and
    ``("wave", kwargs of record_wave)``, in order."""
    if events is None:
        events = [("prefill", dict(rid=rid, prompt_len=n))
                  for rid, n in enumerate(prompt_lengths)]
        events += [("wave", dict(
            sectored=k is not None, k_pages=k,
            slots=[(rid, rid, n + w)
                   for rid, n in enumerate(prompt_lengths)]))
            for w, k in enumerate(k_per_wave)]
    m = meters.WaveMeter(geometry, sectored_hw=sectored_hw)
    for kind, kwargs in events:
        if kind == "prefill":
            m.record_prefill(**kwargs)
        else:
            m.record_wave(**kwargs)
    return m


def log_schedule(meter):
    """Wrap ``meter``'s ``record_prefill`` and ``record_wave`` so every
    call's schedule (not its wall time or table views) is logged as a
    :func:`schedule_meter` event; returns the list."""
    events = []
    prefill, wave = meter.record_prefill, meter.record_wave

    def record_prefill(rid, prompt_len, **kw):
        events.append(("prefill", dict(rid=rid, prompt_len=prompt_len, **kw)))
        return prefill(rid, prompt_len, **kw)

    def record_wave(**kw):
        events.append(("wave", {k: v for k, v in kw.items()
                                if k not in ("wall_s", "state_views")}))
        return wave(**kw)
    meter.record_prefill, meter.record_wave = record_prefill, record_wave
    return events


class LoggedPolicy:
    """Delegates to a policy and keeps each wave's ``topk_frac``."""

    def __init__(self, policy):
        self.policy, self.fracs = policy, []

    def decide(self, occupancy, stats):
        decision = self.policy.decide(occupancy, stats)
        self.fracs.append(decision.topk_frac)
        return decision


def timed_calls(obj, name, seconds):
    """Wrap the bound method ``obj.name`` so each call's host time is
    appended to ``seconds``."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)
    setattr(obj, name, timed)


def metered_session(launch_serve, cfg, params, kernel, metered, *, seq_len,
                    dev, graphs):
    """The 4-slot session of the main path. ``metered`` None serves
    unmetered; "sectored" meters through ``build_session(telemetry=True)``
    (the CLI's ``--telemetry``); "coarse" meters the same backend as
    coarse-grained DRAM (``sectored_hw=False``); "adaptive" runs
    ``AdaptiveSectorPolicy`` over the meter's recorder."""
    from repro_torch.serve import (AdaptiveSectorPolicy, AlwaysSectored,
                                   ServeSession)
    from repro_torch.telemetry import MeteredBackend
    if metered in (None, "sectored"):
        sess = launch_serve.build_session(
            cfg, params, true_sectored=True, kernel=kernel,
            policy="sectored", seq_len=seq_len, max_batch=4, device=dev,
            graphs=graphs, telemetry=metered is not None)
    else:
        backend = MeteredBackend(
            launch_serve.build_backend(cfg, params, true_sectored=True,
                                       seq_len=seq_len, kernel=kernel,
                                       device=dev, graphs=graphs),
            sectored_hw=metered != "coarse")
        policy = (AdaptiveSectorPolicy(backend.meter.recorder, **ADAPTIVE)
                  if metered == "adaptive" else AlwaysSectored())
        sess = ServeSession(backend, max_batch=4, policy=policy)
    sess.policy = LoggedPolicy(sess.policy)
    return sess


def meter_record(np, meters, sess, backend, lengths, host_s, n_waves):
    """What the session's meter reports, checked against a fresh meter
    driven on the host with the schedule the session ran (each wave's
    page budget from the policy's logged fraction, plus the probe page):
    ``energy_j``, ``dram_ns``, ``prefill_dram_ns`` and ``tokens`` must be
    equal, and the audit within ``AUDIT_TOL``. These are outputs of the
    DDR4 model on host counters, not measurements of the card."""
    report = sess.meter.report()
    ks = [backend.k_for(f) + backend.probe_pages_for(backend.k_for(f))
          for f in sess.policy.fracs]
    host = schedule_meter(meters, backend.kv_geometry(), lengths, ks,
                          sectored_hw=sess.meter.sectored_hw).report()
    tokens = report["tokens"]
    total_ns = report["dram_ns"] + report["prefill_dram_ns"]
    out = dict(
        sectored_hw=sess.meter.sectored_hw,
        kv_word_fraction=sess.meter.geometry.kv_word_fraction,
        energy_j=report["energy_j"], tokens=tokens,
        j_per_token=report["energy_j"] / tokens,
        uj_per_token=report["energy_j"] / tokens * 1e6,
        ns_per_token=total_ns / tokens,
        decode_dram_ns=report["dram_ns"],
        prefill_dram_ns=report["prefill_dram_ns"],
        sector_coverage=report["sector_coverage"],
        attn_mass_ema=report["ema"].get("attn_mass"),
        audit_checks=report["audit_checks"],
        audit_max_rel_err=report["audit_max_rel_err"],
        meter_host_ms_per_wave=sum(host_s) / n_waves * 1e3,
        topk_frac_per_wave=list(sess.policy.fracs),
        k_pages_per_wave=ks,
        host_replay_equal={k: report[k] == host[k] for k in
                           ("energy_j", "dram_ns", "prefill_dram_ns",
                            "tokens")})
    if not all(out["host_replay_equal"].values()):
        fail(f"the session's meter differs from the host replay of its "
             f"schedule: {out['host_replay_equal']}; session "
             f"{[report[k] for k in out['host_replay_equal']]}, host "
             f"{[host[k] for k in out['host_replay_equal']]}")
    if not (report["audit_checks"] > 0
            and report["audit_max_rel_err"] <= AUDIT_TOL):
        fail(f"energy audit: {report['audit_checks']} checks, max rel err "
             f"{report['audit_max_rel_err']} (tolerance {AUDIT_TOL})")
    if not all(np.isfinite([out["j_per_token"], out["ns_per_token"]])):
        fail(f"non-finite metered figures: {out}")
    return out


def serve_run(torch, np, sa, launch_serve, cfg, params, kernel, n_layers,
              prefills, *, graphs=True, record=False, dev="cuda",
              lengths=PROMPT_LENGTHS, seq_len=2048, metered=None,
              specs=None, dense=False, phase="main_path"):
    """Serve the 4 requests with ``kernel``, their waves and prefill as
    replays of captured CUDA graphs or, with ``graphs=False``, eagerly,
    through :func:`metered_session` (``metered``: None, "sectored",
    "coarse" or "adaptive"); ``dense`` serves them on the dense path
    instead (``build_session`` without ``true_sectored``, unmetered, its
    prefill one eager forward pass, no paged kernel). ``specs`` gives each
    request its ``SamplerSpec`` (None: all greedy).

    ``prefills`` (prompt bytes -> (logits, state)) carries prefill results
    from one run to the next: prefill runs the exact dispatch step
    whatever the kernel, so later runs take the first run's states bit for
    bit instead of spending the time limit on recomputing them (the eager
    prefill is timed and held against them once, in :func:`main_path`).
    ``record`` (eager runs only) keeps every wave's logits by request.
    A metered run times the meter's host work per wave (the wave
    descriptor with its table copy, and ``record_wave``) and holds its
    report to the host replay of its schedule (:func:`meter_record`).
    Returns (session, handles, record of the run, logits by request).
    """
    from repro_torch.serve import Request
    from repro_torch.telemetry import meters

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    if dense:
        sess = launch_serve.build_session(cfg, params, policy="dense",
                                          max_batch=4, device=dev,
                                          graphs=graphs)
    else:
        sess = metered_session(launch_serve, cfg, params, kernel, metered,
                               seq_len=seq_len, dev=dev, graphs=graphs)
    backend = getattr(sess.backend, "inner", sess.backend)
    meter_s = []
    if sess.meter is not None:
        timed_calls(sess, "_meter_wave_info", meter_s)
        timed_calls(sess.meter, "record_wave", meter_s)
    prefill = backend.prefill_fn
    prefill_s = []
    reused = [0]

    def timed_prefill(tokens):
        key = np.asarray(tokens, np.int32).tobytes()
        if key in prefills:
            reused[0] += 1
            logits, state = prefills[key]
            return logits.clone(), state.clone()
        sync()
        t0 = time.perf_counter()
        logits, state = prefill(tokens)
        sync()
        prefill_s.append(time.perf_counter() - t0)
        prefills[key] = (logits.clone(), state.clone())
        return logits, state
    backend.prefill_fn = timed_prefill
    logits_by_rid = record_logits(sess) if record else None
    rng = np.random.default_rng(0)
    lengths = list(lengths)
    specs = specs or [None] * len(lengths)
    handles = [sess.submit(Request(
        rid, rng.integers(0, cfg.vocab, n).astype(np.int32),
        max_new_tokens=NEW_TOKENS, sampler=specs[rid]))
        for rid, n in enumerate(lengths)]
    sync()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sa.reset_launches()
    wave_ms = []  # each step less the prefills it ran (admission)
    t0 = time.perf_counter()
    while not sess.idle:
        n_prefills = len(prefill_s)
        t1 = time.perf_counter()
        sess.step()
        sync()
        wave_ms.append((time.perf_counter() - t1
                        - sum(prefill_s[n_prefills:])) * 1e3)
    total_s = time.perf_counter() - t0
    stats = sess.stats
    launches = dict(sa.launches)
    decode_s = sum(wave_ms) / 1e3
    k = None if dense else backend.k_for(None)
    captured = list(sess._wave_cache.values()) if backend.graphs else []
    warmup = {}
    for wave in captured:
        for n_flavor, n in wave.warmup_launches[0].items():
            warmup[n_flavor] = warmup.get(n_flavor, 0) + n
    out = dict(phase=phase, kernel="dense" if dense else kernel,
               graphs=backend.graphs, metered=metered, n_layers=n_layers,
               sampled=[s is not None for s in specs],
               wave_flavors=[("sampled" if key[1] else "greedy")
                             for key in sess._wave_cache],
               completed=stats["completed"],
               waves=stats["waves"], sectored_waves=stats["sectored_waves"],
               decode_steps=stats["decode_steps"], launches=launches,
               warmup_launches=warmup,
               graphs_captured=len(captured) + len(
                   getattr(backend, "_prefill_graphs", ())),
               prefill_s=sum(prefill_s), prefill_s_by_prompt=prefill_s,
               prefills_reused=reused[0], total_s=total_s,
               ms_per_wave=decode_s / stats["waves"] * 1e3,
               # the first wave captures its graph (and warms cuBLAS up)
               first_wave_ms=wave_ms[0],
               later_waves_median_ms=statistics.median(wave_ms[1:]),
               decode_tokens_per_s=stats["decode_steps"] / decode_s,
               peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if dev == "cuda" else None),
               k_pages=k,
               probe_pages=None if dense else backend.probe_pages_for(k),
               padded_pages=None if dense else backend.pages,
               prompt_lengths=lengths)
    if sess.meter is not None:
        out["meter"] = meter_record(np, meters, sess, backend, lengths,
                                    meter_s, stats["waves"])
    emit(out)
    if not all(h.done for h in handles) or stats["completed"] != 4:
        fail(f"{kernel}: not every request completed: {stats}")
    want = {"bf16": 0, "int8": 0}
    if kernel != "dispatch" and not dense:
        want["int8" if kernel == "fused_q8" else "bf16"] = (
            n_layers * stats["sectored_waves"])
    if dev == "cuda" and (launches != want
                          or (stats["sectored_waves"] == 0) != dense):
        fail(f"{kernel}: launches {launches}, want {want} (n_layers x "
             f"sectored waves of the kernel's flavor)")
    for h in handles:
        if len(h.peek()) != NEW_TOKENS:
            fail(f"{kernel}: request {h.rid} emitted {len(h.peek())} tokens")
    return sess, handles, out, logits_by_rid


def record_logits(sess):
    """Wrap the eager steps of ``sess``'s backend so every wave's logits
    are kept, by request id (a Python wrapper inside a captured graph
    would run once, at capture: eager runs only)."""
    if sess.backend.graphs:
        fail("logits can be recorded from eager runs only")
    by_rid: dict[int, list] = {}
    for fn in sess.backend._k_cache.values():
        def recording(state, token, step_=fn.step_):
            logits = step_(state, token)
            if token.shape[0] == sess.max_batch:
                for slot in sess.active_slots():
                    by_rid.setdefault(sess.slots[slot].rid, []).append(
                        logits[slot].float().clone())
            return logits
        fn.step_ = recording
    return by_rid


def host_copy(torch, sess):
    """The session's final wave buffer and sampler rows, on the host."""
    from repro_torch.runtime.graphs import leaves
    return [t.cpu() for t in leaves((sess.batched, sess._sampler_rows))]


def same_results(torch, a, b) -> dict:
    """Bitwise comparison of two runs of :func:`main_path`."""
    return dict(
        tokens=a["tokens"] == b["tokens"],
        logprobs=a["logprobs"] == b["logprobs"],
        final_state=all(torch.equal(x, y)
                        for x, y in zip(a["final"], b["final"])))


def stream_divergence(fused, dispatch):
    """Where the fused and dispatch greedy streams of two runs of
    :func:`main_path` first part, by request: the position, both tokens,
    each run's logit gap between them and the two runs' largest logit
    difference at that step."""
    out = []
    for rid, (a, b) in enumerate(zip(fused["tokens"], dispatch["tokens"])):
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        row = dict(rid=rid, agree=p is None, tokens=len(a))
        if p is not None:
            row.update(position=p, fused_token=a[p], dispatch_token=b[p])
            if p > 0:  # token p came from the request's wave p - 1
                lf = fused["logits"][rid][p - 1]
                ld = dispatch["logits"][rid][p - 1]
                row.update(
                    fused_logit_gap=float(lf[a[p]] - lf[b[p]]),
                    dispatch_logit_gap=float(ld[b[p]] - ld[a[p]]),
                    logit_max_abs_diff=float((lf - ld).abs().max()))
        out.append(row)
    return out


def profile_call(torch, label, run, batch):
    """One call of ``run()`` under ``torch.profiler``: its host time, the
    device time of every kernel it ran, and the device's idle share of
    the call (1 - busy / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        row = by_name.setdefault(evt.name, [0.0, 0])
        row[0] += evt.time_range.elapsed_us() / 1e3
        row[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    attn = {k: v for k, v in by_name.items() if PAGED_KERNEL in k}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(phase="profile", step=label, batch=batch,
               wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               device_launches=sum(c for _, c in by_name.values()),
               sectored_attention_ms=sum(ms for ms, _ in attn.values()),
               sectored_attention_launches=sum(c for _, c in attn.values()),
               top=[dict(name=k[:90], ms=ms, count=c)
                    for k, (ms, c) in top])
    emit(out)
    return out


def event_ms(torch, run, n: int = 5) -> float:
    """Median time of ``run()`` between CUDA events recorded just before
    and after it, with no profiler: where the host launches op by op, the
    device's waits for the host fall inside it."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_pair(torch, label, fn_graph, fn_eager, inputs, token):
    """One eager call and one replay of the same step, each on its own
    copy of ``inputs`` (the state, then the rows of a wave), as
    ``fn(inputs[0], token, *inputs[1:])``. The graph is captured (and
    replayed once) on its copy before the profiled replay. The profiler
    slows a replay's thousands of traced kernels, so each record also
    holds the call's unprofiled time (:func:`event_ms`) and the idle share
    that time gives with the profiled busy time."""
    from repro_torch.runtime.graphs import clone_tree
    eager_in, graph_in = clone_tree(inputs), clone_tree(inputs)
    fn_graph(graph_in[0], token, *graph_in[1:])
    batch = int(token.shape[0])
    out = []
    for name, fn, args in (("eager", fn_eager, eager_in),
                           ("replayed", fn_graph, graph_in)):
        def run(fn=fn, args=args):
            fn(args[0], token, *args[1:])
        rec = profile_call(torch, f"{label}, {name}", run, batch)
        rec["unprofiled_ms"] = event_ms(torch, run)
        rec["unprofiled_idle_share"] = (1.0 - rec["device_busy_ms"]
                                        / rec["unprofiled_ms"])
        emit(dict(phase="profile_unprofiled", step=rec["step"],
                  ms=rec["unprofiled_ms"],
                  idle_share=rec["unprofiled_idle_share"]))
        out.append(rec)
    return out


def one_wave_check(torch, sess, handles, backend_kernel_fns):
    """From one prefilled state at full width: one wave with fused,
    fused_q8 and dispatch. Fused vs dispatch logits and tables are held
    to LOGIT_TOL and TABLE_TOL; the fused_q8 logprob error is reported
    (its gate, LOGPROB_TOL, is defined on the reduced config and is held
    there by :func:`q8_reduced_check`)."""
    state = sess.batched
    token = torch.tensor([[h.peek()[-1]] for h in handles],
                         dtype=torch.int32, device=state.table.device)
    res = {}
    for name, fn in backend_kernel_fns.items():
        logits, new = fn(state.clone(), token)
        res[name] = (logits.float(), new.table)
    ld, td = res["dispatch"]
    lf, tf = res["fused"]
    lq, _ = res["fused_q8"]
    logit_err = float((lf - ld).abs().max())
    table_err = float((tf - td).abs().max())
    lp_err = float((torch.log_softmax(lq, -1)
                    - torch.log_softmax(ld, -1)).abs().max())
    lp_err_bf16 = float((torch.log_softmax(lf, -1)
                         - torch.log_softmax(ld, -1)).abs().max())
    out = dict(phase="one_wave", fused_vs_dispatch_logit_err=logit_err,
               fused_vs_dispatch_table_err=table_err,
               fused_vs_dispatch_logprob_err=lp_err_bf16,
               fused_q8_vs_dispatch_logprob_err=lp_err,
               greedy_agree=dict(
                   fused=bool((lf.argmax(-1) == ld.argmax(-1)).all()),
                   fused_q8=bool((lq.argmax(-1) == ld.argmax(-1)).all())),
               logit_absmax=float(ld.abs().max()),
               tolerances=dict(logits=LOGIT_TOL, table=TABLE_TOL))
    emit(out)
    if not (torch.isfinite(ld).all() and torch.isfinite(lf).all()
            and torch.isfinite(lq).all()):
        fail("non-finite logits in the one-wave check")
    if logit_err > LOGIT_TOL or table_err > TABLE_TOL:
        fail(f"fused vs dispatch: logits err {logit_err}, table err "
             f"{table_err}")
    return out


def q8_reduced_check(torch, np, configs, model, sd, qkv, dev="cuda"):
    """The reference's int8 gate on the card: on the reduced yi-6b it
    holds ``LOGPROB_TOL`` for (tests/test_kernels_fused.py), teacher-forced
    fused_q8 steps (the int8 kernel) vs dispatch steps from one prefilled
    state, per-step logprob max-abs-err <= LOGPROB_TOL and nonzero."""
    cfg = configs.get("yi-6b").reduced()
    params = model.init_params(cfg, seed=0, device=dev)
    backend = sd.make_serving_fns(cfg, params=params, seq_len=384,
                                  min_topk=1, device=dev)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (2, 260)).astype(np.int32)
    logits, state_d = backend.prefill_fn(prompt)
    state_q = state_d.clone()
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    worst = 0.0
    for _ in range(4):
        ld, state_d = sd.sectored_decode_step(params, cfg, state_d, tok, 1,
                                              probe=True, kernel="dispatch")
        lq, state_q = sd.sectored_decode_step(params, cfg, state_q, tok, 1,
                                              probe=True, kernel="fused_q8")
        worst = max(worst, float((torch.log_softmax(ld.float(), -1)
                                  - torch.log_softmax(lq.float(), -1))
                                 .abs().max()))
        tok = ld.argmax(-1, keepdim=True).to(torch.int32)
    out = dict(phase="q8_reduced", arch=cfg.name, steps=4,
               logprob_err=worst, tolerance=qkv.LOGPROB_TOL)
    emit(out)
    if not 0 < worst <= qkv.LOGPROB_TOL:
        fail(f"reduced fused_q8 logprob err {worst} not in "
             f"(0, {qkv.LOGPROB_TOL}]")
    return out


METER_KEYS = ("j_per_token", "uj_per_token", "ns_per_token", "energy_j",
              "tokens", "decode_dram_ns", "prefill_dram_ns",
              "sector_coverage", "attn_mass_ema", "audit_checks",
              "audit_max_rel_err", "meter_host_ms_per_wave",
              "kv_word_fraction", "sectored_hw")


def metering_summary(runs, card):
    """The metered figures of the four graph legs side by side: ``fused``,
    ``fused_q8`` (int8 words), coarse-grained DRAM over the fused backend
    and the adaptive policy over it (with its per-wave ``topk_frac`` and
    the graphs its widths captured). Fails unless J/token and ns/token
    order quantized < fused < coarse, and unless the coarse leg, which
    differs from ``fused`` only in the meter, served the same streams."""
    legs = {name: runs[key]["rec"] for name, key in (
        ("fused", ("fused", True)), ("fused_q8", ("fused_q8", True)),
        ("coarse", ("coarse", True)), ("adaptive", ("adaptive", True)),
        ("sampled", ("sampled", True)))}
    out = dict(phase="metering", card=card,
               note="joules and dram_ns are DDR4-model outputs from host "
                    "counters, not measurements of the card")
    for name, rec in legs.items():
        out[name] = {k: rec["meter"][k] for k in METER_KEYS}
    out["adaptive"].update(
        topk_frac_per_wave=legs["adaptive"]["meter"]["topk_frac_per_wave"],
        k_pages_per_wave=legs["adaptive"]["meter"]["k_pages_per_wave"],
        graphs_captured=legs["adaptive"]["graphs_captured"],
        later_waves_median_ms=legs["adaptive"]["later_waves_median_ms"])
    out["coarse_streams_equal_fused"] = (
        runs["coarse", True]["tokens"] == runs["fused", True]["tokens"]
        and runs["coarse", True]["logprobs"]
        == runs["fused", True]["logprobs"])
    # the meter reads host counters only: sampling moves no joule
    out["sampled_meter_equal_fused"] = all(
        out["sampled"][k] == out["fused"][k]
        for k in ("energy_j", "tokens", "decode_dram_ns", "prefill_dram_ns"))
    emit(out)
    if not out["sampled_meter_equal_fused"]:
        fail("the sampled leg's meter differs from the greedy leg's")
    for key in ("j_per_token", "ns_per_token"):
        q, f, c = (out[k][key] for k in ("fused_q8", "fused", "coarse"))
        if not q < f < c:
            fail(f"{key}: want fused_q8 < fused < coarse, got {q}, {f}, {c}")
    if not out["coarse_streams_equal_fused"]:
        fail("the coarse-grained meter changed the served streams")
    return out


def sampled_specs():
    """The sampled leg's requests: the CLI's ``--temperature 0.8 --top-k
    50 --top-p 0.9 --sample-every 2 --seed 0``, so requests 0 and 2
    sample (seed = rid) and 1 and 3 stay greedy, sharing every wave."""
    from repro_torch.sample import SamplerSpec
    return [SamplerSpec(seed=rid, **SAMPLED) if rid % 2 == 0 else None
            for rid in range(len(PROMPT_LENGTHS))]


def rng_grid_check(torch) -> dict:
    """Keys, random bits and uniforms (64,000 per key) drawn on the card
    over the grid of seeds and positions the CPU tests hold to JAX, each
    bitwise the port's CPU draws; the Gumbel draws' largest difference in
    eps * max(1, |g|) (the card's log may round differently)."""
    from repro_torch.sample import rng
    seeds = torch.tensor(RNG_SEEDS).repeat_interleave(len(RNG_POSITIONS))
    pos = torch.tensor(RNG_POSITIONS, dtype=torch.int32).repeat(
        len(RNG_SEEDS))
    cpu = rng.token_key(seeds, pos)
    card = rng.token_key(seeds.cuda(), pos.cuda())
    vocab = 64000
    gc = rng.gumbel(cpu, vocab).double()
    gg = rng.gumbel(card, vocab).cpu().double()
    eps = torch.finfo(torch.float32).eps
    return dict(
        grid=len(seeds),
        keys_bitwise=bool(torch.equal(card.cpu(), cpu)),
        bits_bitwise=bool(torch.equal(rng.random_bits(card, vocab).cpu(),
                                      rng.random_bits(cpu, vocab))),
        uniforms_bitwise=bool(torch.equal(
            rng.uniform(card, vocab).cpu().view(torch.int32),
            rng.uniform(cpu, vocab).view(torch.int32))),
        gumbel_max_err_eps=float(((gg - gc).abs() / gc.abs().clamp_min(1.0)
                                  ).max() / eps))


def draws_card_vs_cpu(torch, specs, logits_by_rid, tokens) -> dict:
    """Every wave of the eager sampled run again, from its recorded
    logits: the card's ``sample_from_logits`` must give the tokens the
    session emitted, and the CPU's the same tokens, except where the two
    highest Gumbel-perturbed scores (the CPU's) lie within GUMBEL_ULPS
    ulps; such near ties are counted."""
    from repro_torch.sample import SamplerRows, kernel, rng
    from repro_torch.sample import sample_from_logits
    n = len(specs)
    eps = torch.finfo(torch.float32).eps
    out = dict(draws=0, sampled_draws=0, differ=0, near_ties=0,
               session_tokens_equal=True)
    for w in range(WAVES):
        logits = torch.stack([logits_by_rid[r][w] for r in range(n)])
        card = sample_from_logits(logits, SamplerRows.from_specs(
            specs, [w + 1] * n, device="cuda")).cpu()
        rows = SamplerRows.from_specs(specs, [w + 1] * n)
        cpu = sample_from_logits(logits.cpu(), rows)
        out["session_tokens_equal"] &= card.tolist() == [
            tokens[r][w + 1] for r in range(n)]
        for i in torch.nonzero(card != cpu).flatten().tolist():
            out["differ"] += 1
            if specs[i] is None:
                continue
            scaled = logits[i:i + 1].cpu() / specs[i].temperature
            scaled = kernel._mask_top_p(
                kernel._mask_top_k(scaled, rows.top_k[i:i + 1]),
                rows.top_p[i:i + 1])
            z = (scaled + rng.gumbel(rng.token_key(rows.seed[i:i + 1],
                                                   rows.pos[i:i + 1]),
                                     logits.shape[-1]))[0]
            top = torch.topk(z, 2).values
            if float(top[0] - top[1]) <= GUMBEL_ULPS * eps * max(
                    1.0, float(top[0].abs())):
                out["near_ties"] += 1
        out["draws"] += n
        out["sampled_draws"] += sum(s is not None for s in specs)
    return out


def sampled_summary(torch, runs, specs, greedy_waves, sampled_waves, card):
    """The sampled leg's checks and figures: (a) graph == eager bitwise;
    (b) the greedy requests' streams equal the greedy ``fused`` graph
    leg's; (c) a second session with the same seeds reproduces every
    stream; (d) the card's keys, bits and uniforms equal the CPU's; (e)
    the card's draws from the recorded logits equal the session's tokens
    and the CPU's up to counted near ties; (f) ms per wave against the
    greedy graph leg and the kernels a sampled replay adds; (g) the paged
    kernel's launches."""
    sg, se = runs["sampled", True], runs["sampled", False]
    greedy = runs["fused", True]
    by_step = {p["step"]: p for p in (*greedy_waves, *sampled_waves)}
    g_rep = by_step["fused sectored wave, replayed"]
    s_rep = by_step["fused sampled wave, replayed"]
    out = dict(
        phase="sampled", card=card,
        specs=[s.describe() if s is not None else "greedy" for s in specs],
        graph_vs_eager_bitwise=same_results(torch, sg, se),
        greedy_requests_equal_greedy_leg={
            rid: sg["tokens"][rid] == greedy["tokens"][rid]
            and sg["logprobs"][rid] == greedy["logprobs"][rid]
            for rid, s in enumerate(specs) if s is None},
        sampled_requests_left_greedy={
            rid: sg["tokens"][rid] != greedy["tokens"][rid]
            for rid, s in enumerate(specs) if s is not None},
        same_seeds_reproduce=same_results(torch, sg,
                                          runs["sampled_again", True]),
        rng=rng_grid_check(torch),
        draws=draws_card_vs_cpu(torch, specs, se["logits"], se["tokens"]),
        ms_per_wave=dict(
            sampled_graph_median=sg["rec"]["later_waves_median_ms"],
            greedy_graph_median=greedy["rec"]["later_waves_median_ms"],
            sampled_graph_mean=sg["rec"]["ms_per_wave"],
            greedy_graph_mean=greedy["rec"]["ms_per_wave"],
            sampled_eager_median=se["rec"]["later_waves_median_ms"]),
        replay=dict(
            sampled_device_launches=s_rep["device_launches"],
            greedy_device_launches=g_rep["device_launches"],
            extra_kernels=(s_rep["device_launches"]
                           - g_rep["device_launches"]),
            sampled_busy_ms=s_rep["device_busy_ms"],
            greedy_busy_ms=g_rep["device_busy_ms"],
            sampled_unprofiled_ms=s_rep["unprofiled_ms"],
            greedy_unprofiled_ms=g_rep["unprofiled_ms"],
            sampled_unprofiled_idle_share=s_rep["unprofiled_idle_share"],
            top=s_rep["top"]),
        paged_launches=dict(
            sampled=sg["rec"]["launches"]["bf16"],
            sampled_again=runs["sampled_again", True]["rec"]["launches"][
                "bf16"],
            profiled_replay=s_rep["sectored_attention_launches"]))
    emit(out)
    checks = dict(
        graph_vs_eager=all(out["graph_vs_eager_bitwise"].values()),
        greedy_invariant=all(
            out["greedy_requests_equal_greedy_leg"].values()),
        sampled=any(out["sampled_requests_left_greedy"].values()),
        reproduced=all(out["same_seeds_reproduce"].values()),
        rng=all(out["rng"][k] for k in ("keys_bitwise", "bits_bitwise",
                                        "uniforms_bitwise"))
        and out["rng"]["gumbel_max_err_eps"] <= GUMBEL_ULPS,
        draws=(out["draws"]["session_tokens_equal"]
               and out["draws"]["differ"] == out["draws"]["near_ties"]))
    if not all(checks.values()):
        fail(f"sampled leg: {checks}")
    return out


def dense_leg(torch, np, sa, launch_serve, cfg, params, card,
              sectored_prefill_s):
    """The dense path at full width: the 4 greedy requests served with
    graphs, then eagerly from the same prefilled states, held bitwise
    (tokens, logprobs, final wave buffer and sampler rows); each prompt's
    prefill (one eager forward pass) timed beside the sectored exact-scan
    prefill of the same prompts; one wave profiled eager and replayed."""
    from repro_torch.serve import make_fused_wave
    prefills, runs, records = {}, {}, []
    prof = []
    for graphs in (True, False):
        sess, handles, rec, _ = serve_run(
            torch, np, sa, launch_serve, cfg, params, "dispatch",
            cfg.n_layers, prefills, graphs=graphs, dense=True)
        records.append(rec)
        runs[graphs] = dict(rec=rec, tokens=[h.peek() for h in handles],
                            logprobs=[h.logprobs() for h in handles],
                            final=host_copy(torch, sess))
        if graphs:
            token = torch.tensor([[h.peek()[-1]] for h in handles],
                                 dtype=torch.int32, device="cuda")
            eager = launch_serve.build_backend(cfg, params, device="cuda",
                                               graphs=False)
            prof = profile_pair(torch, "dense wave",
                                make_fused_wave(sess.backend.decode_fn),
                                make_fused_wave(eager.decode_fn),
                                (sess.batched, sess._sampler_rows), token)
            records += prof
            del eager, token
        del sess, handles
        torch.cuda.empty_cache()
    same = same_results(torch, runs[True], runs[False])
    graph, eager = runs[True]["rec"], runs[False]["rec"]
    out = dict(phase="dense", card=card, bitwise=same,
               prefill_s_by_prompt=graph["prefill_s_by_prompt"],
               prefill_4_prompts_s=graph["prefill_s"],
               sectored_exact_prefill_4_prompts_s=sectored_prefill_s,
               graph=dict(later_waves_median_ms=graph[
                   "later_waves_median_ms"], ms_per_wave=graph["ms_per_wave"],
                   first_wave_ms=graph["first_wave_ms"],
                   peak_mem_gb=graph["peak_mem_gb"]),
               eager=dict(later_waves_median_ms=eager[
                   "later_waves_median_ms"], ms_per_wave=eager["ms_per_wave"],
                   peak_mem_gb=eager["peak_mem_gb"]),
               idle_share={p["step"]: p["idle_share"] for p in prof},
               unprofiled_idle_share={p["step"]: p["unprofiled_idle_share"]
                                      for p in prof},
               unprofiled_ms={p["step"]: p["unprofiled_ms"] for p in prof},
               device_launches={p["step"]: p["device_launches"]
                                for p in prof})
    records.append(out)
    emit(out)
    if not all(same.values()):
        fail(f"dense: graph and eager runs differ: {same}")
    return records


def main_path(torch, np, sa, launch_serve, cfg, params, card):
    """The serving main path at full width, as captured graphs and eagerly
    in one call: ``fused`` and ``fused_q8`` served both ways and held
    bitwise equal (token streams, logprobs, final wave buffer and sampler
    rows), the graph runs metered (``--telemetry``) and the eager ones
    not; the prefill graph held bitwise against one eager prompt and
    timed against it; the exact step and the fused wave profiled eager and
    replayed; one wave from the final state compares the kernels; the 4
    requests served once with ``dispatch`` and its greedy streams compared
    with ``fused``'s; then, over the ``fused`` backend with graphs, a
    coarse-grained DRAM leg and an adaptive-policy leg, and the metered
    figures of all four (:func:`metering_summary`). Returns (records,
    paged launches by flavor in the metered graph runs)."""
    from repro_torch.runtime.graphs import leaves
    from repro_torch.serve import make_fused_wave
    L = cfg.n_layers
    records, prefills, runs = [], {}, {}

    def run(kernel, graphs, record=False, metered=None, specs=None,
            name=None):
        sess, handles, rec, logits = serve_run(
            torch, np, sa, launch_serve, cfg, params, kernel, L, prefills,
            graphs=graphs, record=record, metered=metered, specs=specs)
        records.append(rec)
        # streams, not handles: a handle keeps its session (and the
        # session's buffers and graphs) alive, which later peaks would see
        key = ((name or kernel, graphs) if metered in (None, "sectored")
               else (metered, graphs))
        runs[key] = dict(
            rec=rec, tokens=[h.peek() for h in handles],
            logprobs=[h.logprobs() for h in handles],
            final=host_copy(torch, sess), logits=logits)
        return sess, handles

    def eager_backend(kernel):
        return launch_serve.build_backend(
            cfg, params, true_sectored=True, seq_len=2048, kernel=kernel,
            device="cuda", graphs=False)

    # fused with graphs, metered (it computes the 4 prefills), then profiles
    sess, handles = run("fused", True, metered="sectored")
    first_prompt = handles[0].request.prompt
    backend, eager = sess.backend, eager_backend("fused")
    _, state1 = backend.prefill_fn(np.arange(8, dtype=np.int32)[None])
    exact = profile_pair(torch, "exact (prefill) step", backend.decode_fn,
                         eager.decode_fn, (state1,),
                         torch.zeros((1, 1), dtype=torch.int32,
                                     device="cuda"))
    token = torch.tensor([[h.peek()[-1]] for h in handles],
                         dtype=torch.int32, device="cuda")
    waves = profile_pair(
        torch, "fused sectored wave",
        make_fused_wave(backend.sectored_fn_for(None)),
        make_fused_wave(eager.sectored_fn_for(None)),
        (sess.batched, sess._sampler_rows), token)
    records += [*exact, *waves]
    for wave in waves:
        if (wave["sectored_attention_launches"] != L
                or not wave["sectored_attention_ms"] > 0):
            fail(f"the profiled {wave['step']} ran {PAGED_KERNEL} "
                 f"{wave['sectored_attention_launches']} times in "
                 f"{wave['sectored_attention_ms']} ms; want one launch per "
                 f"layer ({L}) and a non-zero time")
    del sess, handles, backend, state1, token
    torch.cuda.empty_cache()

    # the eager yardstick of prefill: the first prompt, held bitwise
    prompt = np.asarray(first_prompt, np.int32)[None]
    graph_logits, graph_state = prefills[prompt.tobytes()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = eager.prefill_fn(prompt)
    torch.cuda.synchronize()
    eager_prefill_s = time.perf_counter() - t0
    prefill_same = bool(torch.equal(logits, graph_logits)) and all(
        torch.equal(a, b) for a, b in zip(leaves(state), leaves(graph_state)))
    del eager, logits, state, graph_logits, graph_state
    torch.cuda.empty_cache()

    # fused eager (logits kept for the dispatch comparison), one-wave check
    sess, handles = run("fused", False, record=True)
    backends = {k: eager_backend(k) for k in ("dispatch", "fused",
                                               "fused_q8")}
    records.append(one_wave_check(
        torch, sess, handles,
        {k: b.sectored_fn_for(None) for k, b in backends.items()}))
    del sess, handles, backends
    torch.cuda.empty_cache()
    for graphs in (True, False):
        run("fused_q8", graphs, metered="sectored" if graphs else None)
        torch.cuda.empty_cache()
    run("dispatch", False, record=True)
    torch.cuda.empty_cache()
    for leg in ("coarse", "adaptive"):
        run("fused", True, metered=leg)
        torch.cuda.empty_cache()

    # the sampled leg: the fused backend's mixed greedy/sampled waves, with
    # graphs (metered), eagerly (logits kept) and with graphs again
    specs = sampled_specs()
    for name, graphs, metered, record in (
            ("sampled", True, "sectored", False),
            ("sampled", False, None, True),
            ("sampled_again", True, "sectored", False)):
        sess, handles = run("fused", graphs, record=record, metered=metered,
                            specs=specs, name=name)
        if name == "sampled" and graphs:
            token = torch.tensor([[h.peek()[-1]] for h in handles],
                                 dtype=torch.int32, device="cuda")
            eager = eager_backend("fused")
            sampled_waves = profile_pair(
                torch, "fused sampled wave",
                make_fused_wave(sess.backend.sectored_fn_for(None),
                                sampled=True),
                make_fused_wave(eager.sectored_fn_for(None), sampled=True),
                (sess.batched, sess._sampler_rows), token)
            records += sampled_waves
            del eager, token
        del sess, handles
        torch.cuda.empty_cache()
    records.append(sampled_summary(torch, runs, specs, waves, sampled_waves,
                                   card))
    records.append(metering_summary(runs, card))
    records += dense_leg(torch, np, sa, launch_serve, cfg, params, card,
                         runs["fused", True]["rec"]["prefill_s"])

    fused = runs["fused", False]
    dispatch = runs["dispatch", False]
    streams = stream_divergence(fused, dispatch)
    records.append(dict(phase="fused_vs_dispatch_streams",
                        agree=all(r["agree"] for r in streams),
                        requests=streams, logit_tolerance=LOGIT_TOL))
    emit(records[-1])

    same = {k: same_results(torch, runs[k, True], runs[k, False])
            for k in ("fused", "fused_q8")}
    graph_run = runs["fused", True]["rec"]
    summary = dict(phase="graphs_vs_eager", card=card, bitwise=same,
                   prefill_bitwise=prefill_same,
                   prefill_one_prompt_s=dict(
                       graph=graph_run["prefill_s_by_prompt"][0],
                       eager=eager_prefill_s),
                   prefill_4_prompts_graph_s=graph_run["prefill_s"],
                   idle_share={p["step"]: p["idle_share"]
                               for p in (*exact, *waves)},
                   unprofiled_idle_share={
                       p["step"]: p["unprofiled_idle_share"]
                       for p in (*exact, *waves)},
                   device_launches={p["step"]: p["device_launches"]
                                    for p in (*exact, *waves)})
    for k in ("fused", "fused_q8"):
        for graphs, name in ((True, "graph"), (False, "eager")):
            rec = runs[k, graphs]["rec"]
            summary[f"{k}_{name}"] = dict(
                ms_per_wave=rec["ms_per_wave"],
                later_waves_median_ms=rec["later_waves_median_ms"],
                decode_tokens_per_s=rec["decode_tokens_per_s"],
                peak_mem_gb=rec["peak_mem_gb"])
    records.append(summary)
    emit(summary)
    if not prefill_same:
        fail("the prefill graph is not bitwise the eager prefill")
    for k, flags in same.items():
        if not all(flags.values()):
            fail(f"{k}: graph and eager runs differ: {flags}")
    launches = {"bf16": sum(runs[k, True]["rec"]["launches"]["bf16"]
                            for k in ("fused", "sampled", "sampled_again")),
                "int8": runs["fused_q8", True]["rec"]["launches"]["int8"]}
    return records, launches


# -- phase 3b: the rest of the serving layer -------------------------------------

# leg A (exact path): 4 prompts of one shared page plus distinct tails,
# 24 new tokens each, so every request grows across the 256-token page
# boundary; the pool preempts the cold overlap run
LEG_A = dict(shared=128, tails=(108, 110, 112, 114), new=24, pool_pages=11,
             cache_pages=2)
# leg B (fused kernel, AlwaysSectored): 6 prompts of 4 shared pages plus
# distinct tails above the k = 4 budget, half of them sampled, 24 new
# tokens across the 768-token boundary; overlap, pool, cache, recorder
LEG_B = dict(shared=512, tails=(246, 248, 250, 252, 254, 256), new=24,
             pool_pages=16, cache_pages=12)
# legs A and B run the first 16 of yi-6b's 32 layers (a cut of depth that
# keeps the script, with legs C and D, near half its time limit)
LEG_AB_LAYERS = 16
# streams that part after a resume when the card is not batch-invariant
# may part only where the two tokens' logits (batch-1 recomputation) are
# the top two and within this many bf16 ulps
TIE_ULPS = 2


def first_layers(cfg, params, n):
    """The config and parameters of the first ``n`` layers (views)."""
    import dataclasses
    from repro_torch.runtime.graphs import map_tree
    layers = params["layers"]
    layers = (layers[:n] if isinstance(layers, list)
              else map_tree(lambda t: t[:n], layers))
    return dataclasses.replace(cfg, n_layers=n), dict(params, layers=layers)


def layer_prompts(np, vocab, leg, seed):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, leg["shared"]).astype(np.int32)
    return [np.concatenate([common,
                            rng.integers(0, vocab, t).astype(np.int32)])
            for t in leg["tails"]]


def device_timer(torch, dev, spans):
    """Wrap a callable so each call's device time is kept in ``spans``:
    a pair of CUDA events around it on the card (no host sync; read
    after the run), the host clock on the CPU."""
    def wrap(fn):
        def timed(*args, **kwargs):
            if dev != "cuda":
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                spans.append((time.perf_counter() - t0) * 1e3)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans.append((start, end))
            return out
        return timed
    return wrap


def span_ms(spans):
    return [s if isinstance(s, float) else s[0].elapsed_time(s[1])
            for s in spans]


def layer_run(torch, np, sa, launch_serve, cfg, params, leg, *, kernel,
              policy, scheduler, pool, cache, obs, specs, dev, seq_len):
    """Serve a leg's prompts through ``build_session`` (metered, graphs on
    the card) and return the record: streams, stats, the meter's report
    and the schedule it was driven with, each prompt's prefill device ms
    (cold through ``prefill_fn``, warm through ``suffix_prefill``), each
    wave's device ms, preemption points, paged launches, peak memory."""
    from repro_torch.serve import KVPagePool, PrefixCache, Request
    sess = launch_serve.build_session(
        cfg, params, true_sectored=True, kernel=kernel, policy=policy,
        seq_len=seq_len, max_batch=4, device=dev, telemetry=True,
        scheduler=scheduler,
        page_pool=KVPagePool(leg["pool_pages"]) if pool else None,
        prefix_cache=PrefixCache(leg["cache_pages"]) if cache else None,
        obs=obs)
    backend = sess.backend.inner
    events = log_schedule(sess.meter)
    cold, warm, waves = [], [], []
    backend.prefill_fn = device_timer(torch, dev, cold)(backend.prefill_fn)
    sess._suffix_prefill = device_timer(torch, dev, warm)(
        sess._suffix_prefill)
    wave_for = sess._wave_for
    sess._wave_for = lambda fn, sampled=False: device_timer(
        torch, dev, waves)(wave_for(fn, sampled))
    preempted = []  # (rid, tokens kept) at each preemption
    preempt = sess._preempt

    def logged_preempt(slot):
        h = sess.slots[slot]
        preempted.append((h.rid, len(h._tokens)))
        return preempt(slot)
    sess._preempt = logged_preempt
    prompts = layer_prompts(np, cfg.vocab, leg, seed=3)
    handles = [sess.submit(Request(rid, p, max_new_tokens=leg["new"],
                                   sampler=specs[rid]))
               for rid, p in enumerate(prompts)]
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sa.reset_launches()
    t0 = time.perf_counter()
    sess.run_until_drained()
    if dev == "cuda":
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    report = sess.meter.report()
    wave_ms = span_ms(waves)
    cache_obj = sess.prefix_cache
    rec = dict(
        scheduler=scheduler, pool=pool, cache=cache, obs=obs is not None,
        stats=dict(sess.stats), total_s=total_s,
        tokens=[h.peek() for h in handles],
        logprobs=[h.logprobs() for h in handles],
        request_energy_j=[h.energy_j for h in handles],
        request_dram_ns=[h.telemetry["dram_ns"] for h in handles],
        preempted=preempted,
        cache_stats=(dict(cache_obj.stats) if cache_obj is not None
                     else None),
        pool_peak_pages=sess.page_pool.peak_pages if pool else None,
        meter={k: report[k] for k in (
            "energy_j", "dram_ns", "prefill_dram_ns", "prefill_j", "tokens",
            "prefix_hit_tokens", "resumed_prefills", "overlapped_prefills",
            "audit_checks", "audit_max_rel_err")},
        cold_prefill_ms=span_ms(cold), warm_prefill_ms=span_ms(warm),
        wave_ms_median_2_n=(statistics.median(wave_ms[1:])
                            if len(wave_ms) > 1 else None),
        wave_ms_first=wave_ms[0] if wave_ms else None,
        launches=dict(sa.launches),
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if dev == "cuda" else None))
    from repro_torch.telemetry import meters
    host = schedule_meter(meters, backend.kv_geometry(), events=events,
                          sectored_hw=sess.meter.sectored_hw).report()
    rec["host_replay_equal"] = {k: report[k] == host[k] for k in (
        "energy_j", "dram_ns", "prefill_dram_ns", "prefill_j", "tokens")}
    rec["schedule_events"] = dict(
        prefills=sum(k == "prefill" for k, _ in events),
        resumed=sum(k == "prefill" and e.get("resumed") for k, e in events),
        warm=sum(k == "prefill" and e.get("cached_tokens", 0) > 0
                 for k, e in events),
        waves=sum(k == "wave" for k, _ in events))
    if not all(h.done and len(h.peek()) == leg["new"] for h in handles):
        fail(f"serving-layer run {scheduler}/{pool}/{cache}: not every "
             f"request completed: {rec['stats']}")
    if not all(rec["host_replay_equal"].values()):
        fail(f"the meter differs from the host replay of its schedule: "
             f"{rec['host_replay_equal']}")
    if not (report["audit_checks"] > 0
            and report["audit_max_rel_err"] <= AUDIT_TOL):
        fail(f"energy audit: {report['audit_checks']} checks, max rel err "
             f"{report['audit_max_rel_err']}")
    return sess, rec


def batch_invariance(torch, np, launch_serve, cfg, params, dev, seq_len,
                     prompts, steps=3):
    """Exact decode steps of the same states at batch 1 and at batch 4
    (the prefill's step and the wave's; eagerly, which is bitwise their
    graphs): the leg's prompts prefilled into the 4 slots, ``steps``
    steps of the batch (each fed its own argmax), and each slot's step
    alone from the same state. Bitwise equal in logits, the appended K/V
    row and the chosen token's logprob for every slot and step, or the
    largest differences. A bf16 output hides most last-bit differences
    of the f32 sums behind it, so one equal step proves little."""
    from repro_torch.sample import token_logprob
    backend = launch_serve.build_backend(cfg, params, true_sectored=True,
                                         seq_len=seq_len, kernel="fused",
                                         device=dev)
    rows = [backend.prefill_fn(p[None]) for p in prompts]
    big = rows[0][1].zeros_batch(len(rows))
    for slot, (_, state) in enumerate(rows):
        big.set_row(slot, state)
    exact = backend._step_for(backend.pages)
    token = torch.stack([torch.argmax(lg[0].float()) for lg, _ in rows])
    out = dict(prompt_lengths=[len(p) for p in prompts], steps=steps,
               compared=0, bitwise_steps=0, logit_max_abs_diff=0.0,
               kv_row_max_abs_diff=0.0, logprob_max_abs_diff=0.0)
    for _ in range(steps):
        token = token.to(torch.int32).reshape(-1, 1)
        before = big.clone()
        l4 = exact.step_(big, token)
        tok = torch.argmax(l4.float(), dim=-1)
        lp4 = token_logprob(l4, tok)
        for slot in range(len(rows)):
            one = before.row(slot).clone()
            n = int(one.kv.length[0, 0])
            l1 = exact.step_(one, token[slot:slot + 1])
            lp1 = token_logprob(l1, tok[slot:slot + 1])[0]
            kv = max(float((a[:, 0, n].float() - b[:, slot, n].float())
                           .abs().max())
                     for a, b in ((one.kv.k, big.kv.k),
                                  (one.kv.v, big.kv.v)))
            logit = float((l1[0].float() - l4[slot].float()).abs().max())
            lp = float((lp1 - lp4[slot]).abs())
            out["compared"] += 1
            out["bitwise_steps"] += logit == 0.0 and kv == 0.0 and lp == 0.0
            out["logit_max_abs_diff"] = max(out["logit_max_abs_diff"], logit)
            out["kv_row_max_abs_diff"] = max(out["kv_row_max_abs_diff"], kv)
            out["logprob_max_abs_diff"] = max(out["logprob_max_abs_diff"],
                                              lp)
        token = tok
    out["bitwise"] = out["bitwise_steps"] == out["compared"]
    return out


def tie_check(torch, np, backend, prompt, tokens_a, tokens_b, p):
    """Where two streams of one request part at position p: the logits
    of position p from a batch-1 re-prefill over ``prompt +
    tokens_a[:p]``; the parting is a near tie when the two tokens are its
    top two and lie within TIE_ULPS bf16 ulps."""
    ctx = np.concatenate([prompt, np.asarray(tokens_a[:p], np.int32)])
    logits, _ = backend.prefill_fn(ctx[None])
    row = logits[0].float()
    a, b = int(tokens_a[p]), int(tokens_b[p])
    top = set(torch.topk(row, 2).indices.tolist())
    gap = float((row[a] - row[b]).abs())
    big = float(max(row[a].abs(), row[b].abs()))
    ulp = 2.0 ** (math.floor(math.log2(big)) - 7) if big > 0 else 2.0 ** -133
    return dict(position=p, tokens=[a, b], gap=gap, ulps=gap / ulp,
                near_tie=top == {a, b} and gap <= TIE_ULPS * ulp)


def compare_to_oracle(torch, np, backend, prompts, oracle, run, invariant):
    """Each request of ``run`` against the uncontended ``oracle``: bitwise
    before its first preemption; after it bitwise when the card is
    batch-invariant, else tokens may part only at a near tie
    (:func:`tie_check`) and logprobs within LOGIT_TOL until then."""
    first = {}
    for rid, kept in run["preempted"]:
        first.setdefault(rid, kept)
    out = []
    for rid, prompt in enumerate(prompts):
        ta, tb = oracle["tokens"][rid], run["tokens"][rid]
        la, lb = oracle["logprobs"][rid], run["logprobs"][rid]
        cut = first.get(rid, len(ta))
        row = dict(rid=rid, preempted_at=first.get(rid),
                   before_bitwise=ta[:cut] == tb[:cut] and la[:cut] == lb[:cut],
                   after_bitwise=ta[cut:] == tb[cut:] and la[cut:] == lb[cut:])
        row["ok"] = row["before_bitwise"] and (row["after_bitwise"]
                                               or not invariant)
        if not row["after_bitwise"] and not invariant:
            p = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     len(ta))
            row["logprob_max_abs_diff"] = max(
                [0.0] + [abs(x - y) for x, y in zip(la[:p], lb[:p])])
            row["ok"] = row["ok"] and row["logprob_max_abs_diff"] <= LOGIT_TOL
            if p < len(ta):
                row["parting"] = tie_check(torch, np, backend, prompt, ta,
                                           tb, p)
                row["ok"] = row["ok"] and row["parting"]["near_tie"]
        out.append(row)
    return out


def serve_layer_exact(torch, np, sa, launch_serve, cfg, params, card,
                      dev="cuda", seq_len=2048):
    """Leg A: the exact path (``AlwaysDense`` over the fused backend) in
    three sessions — FIFO with no pool (the oracle), overlap with a
    preempting pool, and overlap with the pool, a prefix cache and the
    recorder — held bitwise (or to the near-tie rule after a resume, when
    the card is not batch-invariant), the warm run's prefill joules below
    the oracle's."""
    from repro_torch.obs import FlightRecorder
    leg = LEG_A
    prompts = layer_prompts(np, cfg.vocab, leg, seed=3)
    invariance = batch_invariance(torch, np, launch_serve, cfg, params, dev,
                                  seq_len, prompts)
    emit(dict(phase="batch_invariance", card=card, **invariance))
    specs = [None] * len(leg["tails"])
    runs = {}
    for name, scheduler, pool, cache, obs in (
            ("fifo", "fifo", False, False, None),
            ("overlap_pool", "overlap", True, False, None),
            ("overlap_pool_cache_obs", "overlap", True, True,
             FlightRecorder())):
        sess, rec = layer_run(torch, np, sa, launch_serve, cfg, params, leg,
                              kernel="fused", policy="dense",
                              scheduler=scheduler, pool=pool, cache=cache,
                              obs=obs, specs=specs, dev=dev, seq_len=seq_len)
        runs[name] = rec
        if name == "fifo":
            oracle_backend = sess.backend.inner
        else:
            del sess
    oracle, cold, warm = (runs[k] for k in ("fifo", "overlap_pool",
                                            "overlap_pool_cache_obs"))
    cmp = {name: compare_to_oracle(torch, np, oracle_backend, prompts,
                                   oracle, runs[name],
                                   invariance["bitwise"])
           for name in ("overlap_pool", "overlap_pool_cache_obs")}
    del oracle_backend
    if dev == "cuda":
        torch.cuda.empty_cache()
    out = dict(
        phase="serve_layer_exact", card=card, leg=leg,
        batch_invariance=invariance, compare=cmp,
        preemptions={k: r["stats"]["preemptions"] for k, r in runs.items()},
        overlapped_prefills={k: r["stats"]["overlapped_prefills"]
                             for k, r in runs.items()},
        cache_stats=warm["cache_stats"],
        prefill_j={k: r["meter"]["prefill_j"] for k, r in runs.items()},
        energy_j={k: r["meter"]["energy_j"] for k, r in runs.items()},
        audit_max_rel_err={k: r["meter"]["audit_max_rel_err"]
                           for k, r in runs.items()},
        cold_prefill_ms={k: r["cold_prefill_ms"] for k, r in runs.items()},
        warm_prefill_ms=warm["warm_prefill_ms"],
        wave_ms_median_2_n={k: r["wave_ms_median_2_n"]
                            for k, r in runs.items()},
        total_s={k: r["total_s"] for k, r in runs.items()},
        peak_mem_gb={k: r["peak_mem_gb"] for k, r in runs.items()},
        schedule_events={k: r["schedule_events"] for k, r in runs.items()},
        pool_peak_pages={k: r["pool_peak_pages"] for k, r in runs.items()})
    emit(out)
    checks = dict(
        streams=all(r["ok"] for rows in cmp.values() for r in rows),
        cold_preempts=cold["stats"]["preemptions"] >= 1,
        warm_hits=warm["cache_stats"]["hits"] == 3,
        warm_preempts_less=(warm["stats"]["preemptions"]
                            < cold["stats"]["preemptions"]),
        overlapped=cold["stats"]["overlapped_prefills"] > 0,
        warm_prefill_j_below=(warm["meter"]["prefill_j"]
                              < oracle["meter"]["prefill_j"]))
    if not all(checks.values()):
        fail(f"serve_layer_exact: {checks}")
    return out


def serve_layer_fused(torch, np, sa, launch_serve, cfg, params, card,
                      dev="cuda", seq_len=2048):
    """Leg B: the main path with everything on — the fused kernel under
    ``AlwaysSectored``, overlap, pool, prefix cache, half the requests
    sampled — served with the recorder on and off: streams, per-request
    joules and ``dram_ns`` and the meter's totals bitwise equal, each
    meter equal to the host replay of its schedule, the paged kernel
    launched once per layer per wave. Returns (record, paged launches of
    the two runs)."""
    from repro_torch.obs import FlightRecorder, write_perfetto
    from repro_torch.sample import SamplerSpec
    leg = LEG_B
    specs = [SamplerSpec(seed=rid, **SAMPLED) if rid % 2 else None
             for rid in range(len(leg["tails"]))]
    runs, obs = {}, FlightRecorder(commands=True)
    # off first: the recorder keeps its session (and its memory) alive
    for name, recorder in (("obs_off", None), ("obs_on", obs)):
        sess, rec = layer_run(torch, np, sa, launch_serve, cfg, params, leg,
                              kernel="fused", policy="sectored",
                              scheduler="overlap", pool=True, cache=True,
                              obs=recorder, specs=specs, dev=dev,
                              seq_len=seq_len)
        runs[name] = rec
        del sess
        if dev == "cuda":
            torch.cuda.empty_cache()
    on, off = runs["obs_on"], runs["obs_off"]
    path = ROOT / "build" / "chip_smoke" / "serve_layer_fused.perfetto.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_perfetto(obs.spans(), path, commands=obs.command_records)
    same = {k: on[k] == off[k] for k in (
        "tokens", "logprobs", "request_energy_j", "request_dram_ns",
        "meter", "stats")}
    want = {name: cfg.n_layers * r["stats"]["sectored_waves"]
            for name, r in runs.items()}
    launches = {name: r["launches"]["bf16"] for name, r in runs.items()}
    out = dict(
        phase="serve_layer_fused", card=card, leg=leg,
        specs=[s.describe() if s else "greedy" for s in specs],
        observer_effect_free=same, launches=launches,
        launches_want=want, stats=on["stats"], cache_stats=on["cache_stats"],
        pool_peak_pages=on["pool_peak_pages"],
        schedule_events=on["schedule_events"],
        host_replay_equal={k: r["host_replay_equal"]
                           for k, r in runs.items()},
        meter=on["meter"], preempted=on["preempted"],
        cold_prefill_ms={k: r["cold_prefill_ms"] for k, r in runs.items()},
        warm_prefill_ms={k: r["warm_prefill_ms"] for k, r in runs.items()},
        wave_ms_median_2_n={k: r["wave_ms_median_2_n"]
                            for k, r in runs.items()},
        wave_ms_first={k: r["wave_ms_first"] for k, r in runs.items()},
        total_s={k: r["total_s"] for k, r in runs.items()},
        peak_mem_gb={k: r["peak_mem_gb"] for k, r in runs.items()},
        perfetto_bytes=path.stat().st_size, spans=len(obs.spans()),
        command_records=len(obs.command_records),
        obs_snapshot={k: v for k, v in obs.snapshot().items()
                      if not isinstance(v, dict)})
    emit(out)
    checks = dict(
        observer_effect_free=all(same.values()),
        launches=(launches == want if dev == "cuda"
                  else all(n == 0 for n in launches.values())),
        sectored=on["stats"]["sectored_waves"] == on["stats"]["waves"] > 0,
        hits=on["cache_stats"]["hits"] > 0,
        preempted=on["stats"]["preemptions"] > 0,
        resumed=on["schedule_events"]["resumed"] > 0)
    if not all(checks.values()):
        fail(f"serve_layer_fused: {checks}")
    return out, sum(launches.values())


# -- phase 3c: the other model families ----------------------------------------

# leg C: qwen3-moe at full width, 8 of its 94 layers (one layer's experts
# are 128 x 3 x 4096 x 1536 bf16 = 4.83 GB, so all 94 would be 454 GB;
# 8 layers plus the embedding and unembedding are ~41 GB of the 80 GB);
# prompts of 6 valid pages of the 16 padded ones (seq_len 1024), so
# k = 4 + 1 probe still selects
LEG_C = dict(arch="qwen3-moe-235b-a22b", n_layers=8, seq_len=1024,
             lengths=(700, 706, 713, 720))
# leg D: the dense path of the recurrent families at full width and depth
# (~3.2 and ~5 GB of bf16 weights); recurrentgemma's prompts and tokens
# stay within its local-attention cache (1,024 rows for these prompts)
LEG_D = dict(archs=("rwkv6-1.6b", "recurrentgemma-2b"),
             lengths=(500, 533, 566, 600))
# leg D, prefill state vs the token-by-token chain of the eager decode step
# on the card. The prompt's projections are (S, D) products and the
# chain's (1, D) ones, which round some bf16 outputs an ulp apart; random
# deep stacks carry that from layer to layer. On the first pattern of
# layers: recurrent leaves within REC_TOL of the leaf's largest magnitude
# (the CPU tests measure 0.5-0.8 % at reduced width), K/V rows of the
# local-attention layers within KV_TOL (their inputs pass the recurrent
# layers). At full depth, layer i within tol + slope * i (DEPTH_SLOPE):
# on an H100 80GB HBM3 at 700 W the difference grew at most 0.0070 a
# layer (rwkv6's recurrent leaves, 15 % at layer 23) and 0.0050
# (recurrentgemma's K/V, 0.119 at layer 23). Lengths and position
# exactly.
REC_TOL = 0.05
KV_TOL = 0.0625
DEPTH_SLOPE = {"rec": (0.02, 0.0075), "kv": (KV_TOL, 0.005)}
# the witness of that cause: the same prefill and chain with f32 weights,
# activations and state, whose products round 2**16 times finer; every
# layer's relative difference (recurrent leaves and K/V rows) within
# WITNESS_TOL, the logits within WITNESS_LOGIT_TOL (the same H100 read
# at most 7.1e-5 and 2.3e-4)
WITNESS_TOL = 1e-3
WITNESS_LOGIT_TOL = 1e-2
# leg C, the fused eager run: every fused attention call against the
# dispatch one on the same inputs (q, cache, table, pages), at the
# kernel's own bf16 tolerances (KERNEL_TOL): the attention output after
# the output projection within ATTN_REL_TOL of the dispatch one's largest
# magnitude (a bf16(e) flip on a dominant weight moves it by up to 2**-8
# of that weight's share; an H100 80GB HBM3 at 700 W read 0.0053), the
# updated tables (EMA masses) within ATTN_TABLE_TOL (a wrong mask or
# length moves a page's mass by ~1/640; the same H100 read 3e-8)
ATTN_REL_TOL = KERNEL_TOL["bf16"]["out"]
ATTN_TABLE_TOL = KERNEL_TOL["bf16"]["mass"]
# leg C: a routing flip between the fused and dispatch runs comes from
# rounding: at a request's first flip, the two runs' MoE inputs for its
# row lie within this many bf16 ulps of the row's largest magnitude
FLIP_INPUT_ULPS = 4
# leg C: each recorded MoE output row against a plain per-assignment
# reference in f32 (kept pairs only), as root-mean-square error over the
# reference row's: the card rounds g, u, h, y and each of the k partial
# sums to bf16 (2**-9 relative each); a dropped or wrongly kept
# assignment moves a row by its gate (>= ~0.05 at top-8 of 128) times an
# expert's output, a share of ~0.15
MOE_REF_TOL = 2 ** -5


def memory_line(torch, label):
    """Device memory in use and reserved, after collecting garbage."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(phase="memory", at=label,
               allocated_gb=torch.cuda.memory_allocated() / 1e9,
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    emit(out)
    return out


@contextlib.contextmanager
def moe_calls(moe, calls, batch):
    """Keep ``(params, x, out)`` of every call of ``moe.moe_ffn`` over
    ``batch`` rows (an eager run's waves, layer by layer)."""
    plain = moe.moe_ffn

    def recording(params, cfg, x):
        out = plain(params, cfg, x)
        if x.shape[0] == batch:
            calls.append((params, x.clone(), out.clone()))
        return out
    moe.moe_ffn = recording
    try:
        yield
    finally:
        moe.moe_ffn = plain


@contextlib.contextmanager
def attend_pairs(torch, sectored_decode, rows):
    """In a fused run, precede every fused ``sectored_attend`` call by the
    dispatch one on the same inputs (both write the same new K/V row);
    the fused call's results go on. Keeps per call the largest difference
    of the two attention outputs over the dispatch one's largest
    magnitude, and that of the two updated tables."""
    plain = sectored_decode.sectored_attend

    def paired(attn_params, cfg, x, cache, table_l, k_pages, probe=False,
               kernel="dispatch"):
        if kernel != "fused":
            return plain(attn_params, cfg, x, cache, table_l, k_pages,
                         probe=probe, kernel=kernel)
        od, _, td = plain(attn_params, cfg, x, cache, table_l, k_pages,
                          probe=probe, kernel="dispatch")
        out = plain(attn_params, cfg, x, cache, table_l, k_pages,
                    probe=probe, kernel="fused")
        of, _, tf = out
        rows.append(torch.stack([
            (of.float() - od.float()).abs().max() / od.float().abs().max(),
            (tf - td).abs().max()]))
        return out
    sectored_decode.sectored_attend = paired
    try:
        yield
    finally:
        sectored_decode.sectored_attend = plain


def moe_reference(torch, moe, params, cfg, x):
    """A plain per-assignment MoE over the rows ``x``: the f32 router's
    top-k and their softmax gates; an assignment kept while its expert
    holds fewer than ``cap`` of the earlier tokens' (the reference's
    capacity, counted in token order); each kept pair's SwiGLU in f32 from
    its expert's weights, times its gate, summed in f32. Returns (out
    (T, D) f32, kept (T, k) as lists of bools)."""
    import torch.nn.functional as F
    e = cfg.moe
    xt = x.reshape(-1, cfg.d_model)
    T = xt.shape[0]
    top, idx = torch.topk(torch.matmul(xt.float(), params["router"]),
                          e.top_k, dim=-1)
    gate = torch.softmax(top, dim=-1)
    cap = int(T * e.top_k * moe.CAPACITY_FACTOR / e.n_experts) + 1
    out = torch.zeros((T, cfg.d_model), dtype=torch.float32,
                      device=x.device)
    held, kept = {}, []
    for t, experts in enumerate(idx.tolist()):
        xf = xt[t].float()
        row = []
        for j, ex in enumerate(experts):
            row.append(held.get(ex, 0) < cap)
            held[ex] = held.get(ex, 0) + 1
            if row[-1]:
                h = (F.silu(xf @ params["w_gate"][ex].float())
                     * (xf @ params["w_up"][ex].float()))
                out[t] += gate[t, j] * (h @ params["w_down"][ex].float())
        kept.append(row)
    if e.n_shared_experts:
        sh, xf = params["shared"], xt.float()
        out += (F.silu(xf @ sh["w_gate"].float())
                * (xf @ sh["w_up"].float())) @ sh["w_down"].float()
    return out, kept


def moe_layer_check(torch, moe, cfg, calls):
    """Each recorded wave layer's MoE output on the card against
    :func:`moe_reference` on the same rows (per row, the root-mean-square
    error over the reference's), the assignments the card keeps against
    the reference's, and the routing recomputed on the host (equal to
    the card's, or a near tie of the f32 router logits); per call the
    assignments the capacity drops."""
    rows = []
    for i, (params, x, out) in enumerate(calls):
        ref, ref_kept = moe_reference(torch, moe, params, cfg, x)
        xt = x.reshape(-1, x.shape[-1])
        _, idx = moe.route(params, cfg, xt)
        order, _, keep, _, _ = moe.dispatch(idx, cfg)
        kept = torch.empty_like(keep)
        kept[order] = keep
        _, host_idx = moe.route({"router": params["router"].cpu()}, cfg,
                                xt.cpu())
        diff = out.reshape(ref.shape).float() - ref
        rel = diff.square().mean(-1).sqrt() / ref.square().mean(-1).sqrt()
        rows.append(dict(
            wave=i // cfg.n_layers, layer=i % cfg.n_layers,
            cap=moe.capacity(xt.shape[0], cfg),
            assignments=int(keep.numel()), dropped=int((~keep).sum()),
            ref_rms_rel_err=float(rel.max()),
            ref_max_abs_err=float(diff.abs().max()),
            kept_equal_ref=kept.reshape(idx.shape).tolist() == ref_kept,
            routing_equal_host=bool(torch.equal(idx.cpu(), host_idx))))
    return rows


def bf16_ulp(value: float) -> float:
    """The spacing of bf16 numbers at magnitude ``value``."""
    return 2.0 ** (math.floor(math.log2(value)) - 7) if value > 0 else 0.0


def routing_flips(torch, moe, cfg, fused_calls, dispatch_calls):
    """Where the fused and dispatch eager runs route a token of a wave
    differently: the two runs' MoE inputs differ by the attention's
    rounding, and a router near tie turns that into another expert
    (``experts``), or another row's flip changes which assignments the
    capacity keeps (``drops``). Either moves the row's FFN output by
    about a gate times an expert's output, far more than the rounding.
    Returns the flips in wave order, each with the largest difference of
    the two runs' inputs for the row (also in bf16 ulps of the row's
    largest magnitude) and of their router logits, and the dispatch run's
    gap between its k-th and (k+1)-th router logits: another expert set
    needs that gap within twice the logits' difference."""
    k = cfg.moe.top_k
    flips = []
    for i, ((params, xf, _), (_, xd, _)) in enumerate(
            zip(fused_calls, dispatch_calls, strict=True)):
        sides = []
        for x in (xf, xd):
            xt = x.reshape(-1, cfg.d_model)
            _, idx = moe.route(params, cfg, xt)
            order, _, keep, _, _ = moe.dispatch(idx, cfg)
            kept = torch.empty_like(keep)
            kept[order] = keep
            sides.append((xt, idx.cpu().tolist(),
                          kept.reshape(idx.shape).cpu().tolist()))
        (xa, ia, ka), (xb, ib, kb) = sides
        for t in range(len(ia)):
            experts = set(ia[t]) != set(ib[t])
            drops = ({e for e, kk in zip(ia[t], ka[t]) if kk}
                     != {e for e, kk in zip(ib[t], kb[t]) if kk})
            if not (experts or drops):
                continue
            lf = torch.matmul(xa[t].float(), params["router"])
            ld = torch.matmul(xb[t].float(), params["router"])
            top = torch.topk(ld, k + 1).values
            diff = float((xa[t] - xb[t]).float().abs().max())
            flips.append(dict(
                wave=i // cfg.n_layers, layer=i % cfg.n_layers, row=t,
                kind="experts" if experts else "drops",
                input_max_abs_diff=diff,
                input_ulps=diff / bf16_ulp(float(xb[t].float().abs()
                                                 .max())),
                router_logit_max_abs_diff=float((lf - ld).abs().max()),
                dispatch_topk_gap=float(top[k - 1] - top[k])))
    return flips


def flip_checks(flips):
    """Each flip from rounding: at each row's first flip the inputs within
    FLIP_INPUT_ULPS; every ``experts`` flip at a router near tie (the
    dispatch run's k-th to (k+1)-th gap within twice the two runs' logit
    difference); every ``drops`` flip beside an ``experts`` flip of
    an earlier row in the same wave and layer (an assignment's place in
    its expert counts the earlier tokens' only). Returns ({row: wave of
    its first flip}, checks)."""
    first, first_ulps = {}, []
    for f in flips:
        if f["row"] not in first:
            first[f["row"]] = f["wave"]
            first_ulps.append(f["input_ulps"])
    experts_at = {(f["wave"], f["layer"], f["row"]) for f in flips
                  if f["kind"] == "experts"}
    checks = dict(
        first_flips_at_rounding=all(u <= FLIP_INPUT_ULPS
                                    for u in first_ulps),
        experts_flips_near_ties=all(
            f["dispatch_topk_gap"] <= 2 * f["router_logit_max_abs_diff"]
            for f in flips if f["kind"] == "experts"),
        drops_flips_beside_experts_flips=all(
            any(w == f["wave"] and layer == f["layer"] and r < f["row"]
                for w, layer, r in experts_at)
            for f in flips if f["kind"] == "drops"))
    return first, checks


def logits_before_flips(fused, dispatch, first_flip):
    """The largest fused vs dispatch logit difference, and the count of
    (request, wave) pairs compared, over each request's waves before its
    first routing flip (``first_flip``: wave by slot, request r in slot
    r) and before its stream parts (:func:`stream_divergence`)."""
    worst, compared = 0.0, 0
    for rid, (a, b) in enumerate(zip(fused["tokens"], dispatch["tokens"])):
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        # token i + 1 comes from wave i, fed tokens 0 .. i
        for w in range(min(p, first_flip.get(rid, WAVES),
                           len(fused["logits"][rid]))):
            compared += 1
            worst = max(worst, float((fused["logits"][rid][w]
                                      - dispatch["logits"][rid][w]).abs()
                                     .max()))
    return worst, compared


def moe_sectored(torch, np, sa, launch_serve, configs, model, moe, card,
                 dev="cuda", cfg=None):
    """Leg C: qwen3-moe (``LEG_C``) on the sectored main path, the fused
    kernel and dispatch under ``AlwaysSectored``, each with graphs
    (metered) and eagerly from one set of prefilled states. Gates: graph
    == eager bitwise per flavor; each meter equal to the host replay
    of its schedule, audit <= 1e-9 (:func:`meter_record`); in the fused
    eager run every fused attention call within ATTN_REL_TOL (tables
    ATTN_TABLE_TOL) of dispatch on the same inputs (:func:`attend_pairs`);
    every routing flip between the two eager runs from rounding
    (:func:`flip_checks`), and their logits within LOGIT_TOL over each
    request's waves before its first flip, at least one such wave
    compared, a stream that parts before it parting at a near tie of the
    dispatch run's logits; paged launches = n_layers x waves; every
    recorded MoE call of the fused eager run within MOE_REF_TOL of
    :func:`moe_reference`, keeping the same assignments. ``cfg`` (a
    reduced config, with ``dev="cpu"``) rehearses the leg on the CPU.
    Returns (record, paged launches of the fused graph run)."""
    import dataclasses

    from repro_torch.runtime import sectored_decode
    leg = LEG_C
    if cfg is None:
        cfg = dataclasses.replace(configs.get(leg["arch"]),
                                  n_layers=leg["n_layers"])
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefills, runs = {}, {}
    calls = {"fused": [], "dispatch": []}
    pairs = []
    for kernel in ("fused", "dispatch"):
        for graphs in (True, False):
            with contextlib.ExitStack() as hooks:
                # eager runs only: a wrapper inside a captured body would
                # run once, at capture, and its copies at every replay
                if not graphs:
                    hooks.enter_context(moe_calls(moe, calls[kernel], 4))
                    hooks.enter_context(attend_pairs(torch, sectored_decode,
                                                     pairs))
                sess, handles, rec, logits = serve_run(
                    torch, np, sa, launch_serve, cfg, params, kernel,
                    cfg.n_layers, prefills, graphs=graphs, record=not graphs,
                    dev=dev, lengths=leg["lengths"], seq_len=leg["seq_len"],
                    metered="sectored" if graphs else None,
                    phase="moe_sectored_run")
            runs[kernel, graphs] = dict(
                rec=rec, tokens=[h.peek() for h in handles],
                logprobs=[h.logprobs() for h in handles],
                final=host_copy(torch, sess), logits=logits)
            if rec["sectored_waves"] != rec["waves"]:
                fail(f"moe_sectored {kernel}: {rec['sectored_waves']} of "
                     f"{rec['waves']} waves sectored")
            del sess, handles
            if dev == "cuda":
                torch.cuda.empty_cache()
    layers = moe_layer_check(torch, moe, cfg, calls["fused"])
    attn = (torch.stack(pairs).cpu().tolist() if pairs else [])
    same = {k: same_results(torch, runs[k, True], runs[k, False])
            for k in ("fused", "dispatch")}
    fused, dispatch = runs["fused", False], runs["dispatch", False]
    streams = stream_divergence(fused, dispatch)
    flips = routing_flips(torch, moe, cfg, calls["fused"],
                          calls["dispatch"])
    first_flip, flip_ok = flip_checks(flips)
    logit_err, compared = logits_before_flips(fused, dispatch, first_flip)
    # a stream that parts before its first flip parts at a near tie
    partings = [r for r in streams
                if not r["agree"] and r["position"] - 1 < first_flip.get(
                    r["rid"], WAVES)]
    graph = runs["fused", True]["rec"]
    out = dict(
        phase="moe_sectored", card=card, arch=cfg.name,
        n_layers=cfg.n_layers, cut=f"{cfg.n_layers} of 94 layers",
        d_model=cfg.d_model, experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, seq_len=leg["seq_len"],
        prompt_lengths=list(leg["lengths"]), init_params_s=init_s,
        bitwise=same, attention_pairs=len(attn),
        attention_rel_err_max=max((a for a, _ in attn), default=None),
        attention_table_err_max=max((t for _, t in attn), default=None),
        routing_flips=flips, first_flip_wave=first_flip,
        flip_checks=flip_ok,
        fused_vs_dispatch_logit_err_before_flip=logit_err,
        logit_pairs_compared=compared,
        fused_vs_dispatch_logit_err=logits_before_flips(
            fused, dispatch, {})[0],
        streams=streams, logit_tolerance=LOGIT_TOL,
        moe_calls_checked=len(layers),
        moe_ref_rms_rel_err_max=max(r["ref_rms_rel_err"] for r in layers),
        moe_ref_max_abs_err_max=max(r["ref_max_abs_err"] for r in layers),
        moe_layers=layers[:cfg.n_layers],
        dropped_per_layer=[r["dropped"] for r in layers[:cfg.n_layers]],
        dropped_per_call_max=max(r["dropped"] for r in layers),
        prefill_s_by_prompt=graph["prefill_s_by_prompt"],
        k_pages=graph["k_pages"], probe_pages=graph["probe_pages"],
        padded_pages=graph["padded_pages"],
        launches={k: runs[k, True]["rec"]["launches"]
                  for k in ("fused", "dispatch")},
        **{f"{k}_{'graph' if g else 'eager'}": dict(
            later_waves_median_ms=runs[k, g]["rec"]["later_waves_median_ms"],
            ms_per_wave=runs[k, g]["rec"]["ms_per_wave"],
            first_wave_ms=runs[k, g]["rec"]["first_wave_ms"],
            decode_tokens_per_s=runs[k, g]["rec"]["decode_tokens_per_s"],
            peak_mem_gb=runs[k, g]["rec"]["peak_mem_gb"])
           for k in ("fused", "dispatch") for g in (True, False)},
        meter={k: {m: runs[k, True]["rec"]["meter"][m] for m in (
            "j_per_token", "ns_per_token", "energy_j", "audit_checks",
            "audit_max_rel_err", "host_replay_equal")}
            for k in ("fused", "dispatch")})
    emit(out)
    fused_waves = runs["fused", False]["rec"]["sectored_waves"]
    checks = dict(
        graph_eager=all(all(v.values()) for v in same.values()),
        attention_pairs=len(attn) == cfg.n_layers * fused_waves
        and all(a <= ATTN_REL_TOL and t <= ATTN_TABLE_TOL for a, t in attn),
        **flip_ok,
        logits_compared=compared > 0,
        logits=logit_err <= LOGIT_TOL,
        partings_near_ties=all(r.get("dispatch_logit_gap", 0.0)
                               <= 2 * LOGIT_TOL for r in partings),
        moe_reference=len(layers) == cfg.n_layers * fused_waves
        and all(r["ref_rms_rel_err"] <= MOE_REF_TOL and r["kept_equal_ref"]
                for r in layers))
    if not all(checks.values()):
        fail(f"moe_sectored: {checks}")
    launches = runs["fused", True]["rec"]["launches"]["bf16"]
    del params
    return out, launches


def layer_errors(torch, cfg, a, b):
    """Per layer, how far decode state ``a`` is from ``b``: the largest
    difference of its recurrent leaves, or of its K/V rows, over the
    largest magnitude of ``b``'s (at least 1); for K/V rows also the
    largest difference itself."""
    from repro_torch.runtime.graphs import leaves

    def rel(x, y):
        return (float((x.float() - y.float()).abs().max())
                / max(float(y.float().abs().max()), 1.0))
    rows = []
    for i, kind in enumerate(cfg.layer_kinds):
        row = dict(layer=i, kind=kind)
        if kind == "attn":
            ca, cb = a.layer_kv(i), b.layer_kv(i)
            row["kv_max_abs_err"] = max(
                float((x.float() - y.float()).abs().max())
                for x, y in ((ca.k, cb.k), (ca.v, cb.v)))
            row["kv_rel_err"] = max(rel(ca.k, cb.k), rel(ca.v, cb.v))
            row["kv_bitwise"] = bool(torch.equal(ca.k, cb.k)
                                     and torch.equal(ca.v, cb.v))
        else:
            row["rec_rel_err"] = max(
                rel(x, y) for x, y in zip(leaves(a.layer_rec(i)),
                                          leaves(b.layer_rec(i)),
                                          strict=True))
        rows.append(row)
    return rows


def chain_check(torch, np, model, cfg, params, prompt, dev, *, bound,
                logit_tol=LOGIT_TOL, gate_logits=True, dtype=None,
                new=NEW_TOKENS):
    """The prefill's state against a token-by-token chain of the eager
    decode step over the same prompt (batch 1), then ``new`` greedy
    tokens from each, fed their own argmax. ``dtype`` (float32 for the
    witness) casts the weights and sets the state's dtype.

    Gated: lengths and position equal; every layer's error
    (:func:`layer_errors`) within ``bound(kind, layer)``, where kind is
    ``"rec"`` (relative, recurrent leaves) or ``"kv"`` (K/V rows: absolute
    for bf16, relative for the witness). With ``gate_logits``, the logits
    within ``logit_tol`` until the streams part, and a parting only where
    the chain's two logits lie within 2 x ``logit_tol``."""
    from repro_torch.runtime.graphs import map_tree
    state_dtype = torch.bfloat16
    if dtype is not None:
        params = map_tree(lambda t: t.to(dtype), params)
        state_dtype = dtype
    toks = torch.from_numpy(np.asarray(prompt, np.int32)[None]).to(dev)
    t0 = time.perf_counter()
    pre_logits, pre_state = model.prefill(params, cfg, toks, state_dtype)
    chain = model.init_decode_state(cfg, 1, toks.shape[1], state_dtype,
                                    device=dev)
    for i in range(toks.shape[1]):
        logits = model.decode_step_(params, cfg, chain, toks[:, i:i + 1])
    if dev == "cuda":
        torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    by_layer = layer_errors(torch, cfg, pre_state, chain)
    kv_key = "kv_max_abs_err" if dtype is None else "kv_rel_err"
    exact = dict(
        lengths=all(torch.equal(a.length, b.length) for a, b in zip(
            pre_state.caches(), chain.caches(), strict=True)),
        position=bool(torch.equal(pre_state.position, chain.position)))
    worst = float((pre_logits.float() - logits.float()).abs().max())
    states, lg = [pre_state.clone(), chain], [pre_logits, logits]
    compared, parted = 0, None
    for step in range(new):
        tok = [int(torch.argmax(x[0].float())) for x in lg]
        if tok[0] != tok[1]:
            row = lg[1][0].float()
            parted = dict(position=step, tokens=tok,
                          chain_gap=float(row[tok[1]] - row[tok[0]]))
            break
        compared += 1
        worst = max(worst, float((lg[0].float() - lg[1].float()).abs()
                                 .max()))
        t = torch.tensor([[tok[0]]], dtype=torch.int32, device=dev)
        lg = [model.decode_step_(params, cfg, s, t) for s in states]
    ok = all(exact.values()) and all(
        r[kv_key] <= bound("kv", r["layer"]) if r["kind"] == "attn"
        else r["rec_rel_err"] <= bound("rec", r["layer"]) for r in by_layer)
    if gate_logits:
        ok = ok and worst <= logit_tol and (
            parted is None or parted["chain_gap"] <= 2 * logit_tol)
    return dict(n_layers=cfg.n_layers, dtype=str(state_dtype),
                prompt_len=int(toks.shape[1]), chain_s=chain_s,
                layers=by_layer, exact=exact, logit_err=worst,
                logits_gated=gate_logits, greedy_compared=compared,
                parted=parted, ok=ok)


def depth_bound(kind, layer):
    """The full-depth bf16 gate: ``tol + slope * layer`` (DEPTH_SLOPE)."""
    tol, slope = DEPTH_SLOPE[kind]
    return tol + slope * layer


def dense_families(torch, np, sa, launch_serve, configs, model, card,
                   dev="cuda", cfgs=None):
    """Leg D: rwkv6-1.6b and recurrentgemma-2b (``LEG_D``) at full width
    and depth on the dense path: the 4 greedy prompts served with graphs,
    then eagerly from the same prefilled states, held bitwise; the first
    prompt's prefill state held to the eager token-by-token chain
    (:func:`chain_check`) at full depth (every layer within
    :func:`depth_bound`), again with f32 weights and state (every layer
    within WITNESS_TOL, the logits within WITNESS_LOGIT_TOL: the witness
    that the bf16 gap is rounding), and on the first pattern of layers
    (every layer within REC_TOL / KV_TOL, the logits within LOGIT_TOL).
    ``cfgs`` (reduced configs, with ``dev="cpu"``) rehearses the leg on
    the CPU."""
    out = dict(phase="dense_families", card=card, families={})
    for cfg in cfgs or [configs.get(a) for a in LEG_D["archs"]]:
        t0 = time.perf_counter()
        params = model.init_params(cfg, seed=0, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prefills, runs = {}, {}
        for graphs in (True, False):
            sess, handles, rec, _ = serve_run(
                torch, np, sa, launch_serve, cfg, params, "dispatch",
                cfg.n_layers, prefills, graphs=graphs, dense=True, dev=dev,
                lengths=LEG_D["lengths"], phase="dense_family_run")
            runs[graphs] = dict(rec=rec, tokens=[h.peek() for h in handles],
                                logprobs=[h.logprobs() for h in handles],
                                final=host_copy(torch, sess))
            prompt = handles[0].request.prompt
            del sess, handles
            if dev == "cuda":
                torch.cuda.empty_cache()
        del prefills
        same = same_results(torch, runs[True], runs[False])
        chain = chain_check(torch, np, model, cfg, params, prompt, dev,
                            bound=depth_bound, gate_logits=False)
        witness = chain_check(torch, np, model, cfg, params, prompt, dev,
                              bound=lambda kind, layer: WITNESS_TOL,
                              logit_tol=WITNESS_LOGIT_TOL,
                              dtype=torch.float32)
        if dev == "cuda":
            torch.cuda.empty_cache()
        shallow_cfg, shallow_params = first_layers(
            cfg, params, len(cfg.layer_pattern) or 2)
        shallow = chain_check(
            torch, np, model, shallow_cfg, shallow_params, prompt, dev,
            bound=lambda kind, layer: REC_TOL if kind == "rec" else KV_TOL)
        graph, eager = runs[True]["rec"], runs[False]["rec"]
        fam = dict(
            n_layers=cfg.n_layers, d_model=cfg.d_model,
            layer_kinds=sorted(set(cfg.layer_kinds)),
            init_params_s=init_s, bitwise=same, chain=chain,
            f32_witness=witness, shallow_chain=shallow,
            prefill_s_by_prompt=graph["prefill_s_by_prompt"],
            graph=dict(later_waves_median_ms=graph["later_waves_median_ms"],
                       ms_per_wave=graph["ms_per_wave"],
                       first_wave_ms=graph["first_wave_ms"],
                       decode_tokens_per_s=graph["decode_tokens_per_s"],
                       peak_mem_gb=graph["peak_mem_gb"]),
            eager=dict(later_waves_median_ms=eager["later_waves_median_ms"],
                       peak_mem_gb=eager["peak_mem_gb"]))
        out["families"][cfg.name] = fam
        emit(dict(phase="dense_family", card=card, arch=cfg.name, **fam))
        if not (all(same.values()) and chain["ok"] and witness["ok"]
                and shallow["ok"]):
            fail(f"dense_families {cfg.name}: graph == eager {same}, "
                 f"chain {chain}, f32 witness {witness}, shallow chain "
                 f"{shallow}")
        del params
        if dev == "cuda":
            torch.cuda.empty_cache()
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (no serving)")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/csrc under {ROOT}: run this script from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import build, flash_attention, ops, quantized_kv
    from repro_torch.kernels import sectored_attention as sa
    from repro_torch.kernels import vbl_gather
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model, moe
    from repro_torch.runtime import sectored_decode

    records = []
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    records.append(dict(phase="card", nvidia_smi=card, kind=kind,
                        torch=torch.__version__, cuda=torch.version.cuda))
    emit(records[-1])

    build_s = build.build_all()
    records.append(dict(phase="build", seconds=build_s,
                        sources=build.sources(), ptxas=ptxas_lines(build),
                        flash_hgmma=hgmma_count(build)))
    emit(records[-1])

    cases, worst, timing = kernel_phase(torch, sa, quantized_kv)
    records.append(dict(phase="kernels", cases=cases, timing=timing,
                        card=card))
    emit(records[-1])

    t0 = time.perf_counter()
    ops_record, ops_kernels = ops_phase(torch, ops, sa, vbl_gather,
                                        flash_attention)
    records.append(dict(ops_record, seconds=time.perf_counter() - t0,
                        card=card))
    emit(records[-1])

    launches = {"bf16": 0, "int8": 0}
    if not args.quick:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = configs.get("yi-6b")
        t0 = time.perf_counter()
        params = model.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        records.append(dict(phase="init_params",
                            seconds=time.perf_counter() - t0,
                            n_layers=cfg.n_layers, d_model=cfg.d_model,
                            vocab=cfg.vocab))
        emit(records[-1])
        path_records, launches = main_path(torch, np, sa, launch_serve, cfg,
                                           params, card)
        records += path_records
        # legs A and B at LEG_AB_LAYERS of the 32 layers (views of the
        # main path's weights), to keep the script within its time
        cut, cut_params = first_layers(cfg, params, LEG_AB_LAYERS)
        t0 = time.perf_counter()
        records.append(serve_layer_exact(torch, np, sa, launch_serve, cut,
                                         cut_params, card))
        torch.cuda.empty_cache()
        leg_b, leg_b_launches = serve_layer_fused(torch, np, sa, launch_serve,
                                                  cut, cut_params, card)
        records.append(leg_b)
        launches["bf16"] += leg_b_launches
        records.append(dict(phase="serve_layer_seconds",
                            seconds=time.perf_counter() - t0))
        emit(records[-1])
        del params, cut_params
        records.append(memory_line(torch, "after the yi-6b legs"))

        t0 = time.perf_counter()
        leg_c, leg_c_launches = moe_sectored(torch, np, sa, launch_serve,
                                             configs, model, moe, card)
        records.append(dict(leg_c, seconds=time.perf_counter() - t0))
        launches["bf16"] += leg_c_launches
        records.append(memory_line(torch, "after leg C"))
        t0 = time.perf_counter()
        records.append(dense_families(torch, np, sa, launch_serve, configs,
                                      model, card))
        records.append(dict(phase="dense_families_seconds",
                            seconds=time.perf_counter() - t0))
        emit(records[-1])
        records.append(q8_reduced_check(torch, np, configs, model,
                                        sectored_decode, quantized_kv))

        sa.reset_launches()
        stats = launch_serve.main([
            "--arch", "yi-6b", "--reduced", "--requests", "4",
            "--max-new-tokens", "4", "--max-batch", "4", "--true-sectored",
            "--fused-kernel", "--policy", "sectored", "--telemetry",
            "--device", "cuda"])
        cli = dict(phase="cli", stats=stats, launches=dict(sa.launches))
        records.append(cli)
        emit(cli)
        if stats["completed"] != 4 or sa.launches["bf16"] == 0:
            fail(f"CLI run: {stats}, launches {sa.launches}")
        # the serving layer as the CLI drives it: overlap, pool, prefix
        # cache, recorder with command timelines, the looped wave
        trace = ROOT / "build" / "chip_smoke" / "cli_serving_layer.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        sa.reset_launches()
        stats = launch_serve.main([
            "--arch", "yi-6b", "--reduced", "--requests", "6",
            "--max-new-tokens", "8", "--max-batch", "4", "--true-sectored",
            "--fused-kernel", "--policy", "sectored", "--telemetry",
            "--scheduler", "overlap", "--kv-pages", "7", "--kv-page-size",
            "16", "--prefix-cache", "--shared-prefix", "32", "--obs",
            "--obs-commands", "--obs-perfetto-out", str(trace), "--engine",
            "looped", "--device", "cuda"])
        records.append(dict(phase="cli_serving_layer", stats=stats,
                            launches=dict(sa.launches),
                            perfetto_bytes=trace.stat().st_size))
        emit(records[-1])
        # (a looped wave is read before the scheduler's overlap runs, so
        # it counts no overlapped prefill, as in the reference)
        if (stats["completed"] != 6 or stats["preemptions"] == 0
                or sa.launches["bf16"] == 0):
            fail(f"serving-layer CLI run: {stats}, launches {sa.launches}")
        # the dense path with sampling, as the CLI runs it
        stats = launch_serve.main([
            "--arch", "yi-6b", "--reduced", "--requests", "4",
            "--max-new-tokens", "4", "--max-batch", "4", "--temperature",
            "0.8", "--top-p", "0.9", "--seed", "3", "--sample-every", "2",
            "--device", "cuda"])
        records.append(dict(phase="cli_dense_sampled", stats=stats))
        emit(records[-1])
        if stats["completed"] != 4:
            fail(f"dense sampled CLI run: {stats}")
        # the other families as the CLI serves them, on the card by default
        for argv in (["--arch", "qwen3-moe-235b-a22b", "--true-sectored",
                      "--fused-kernel", "--policy", "sectored"],
                     ["--arch", "rwkv6-1.6b"],
                     ["--arch", "recurrentgemma-2b"]):
            sa.reset_launches()
            stats = launch_serve.main([*argv, "--reduced", "--requests", "4",
                                       "--max-new-tokens", "4"])
            records.append(dict(phase="cli_family", argv=argv, stats=stats,
                                launches=dict(sa.launches)))
            emit(records[-1])
            if stats["completed"] != 4 or (
                    ("--fused-kernel" in argv) != (sa.launches["bf16"] > 0)):
                fail(f"CLI run {argv}: {stats}, launches {sa.launches}")

    kernels = []
    for flavor in ("bf16", "int8"):
        t = timing[flavor]
        kernels.append(dict(
            name=f"sectored_attention_paged_{flavor}", route="cuda",
            source=KERNEL_SOURCE, replaces=TPU_KERNEL,
            path=("serving main path, CUDA graph replays: the greedy "
                  "fused leg, the two sampled graph legs, the two "
                  "serve_layer_fused runs and leg C's fused run "
                  "(qwen3-moe, rep = 16)" if flavor == "bf16"
                  else "serving main path, CUDA graph replays"),
            launches=launches[flavor], max_abs_err=worst[flavor],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    if not args.quick and any(k["launches"] == 0 for k in kernels):
        fail(f"a kernel of the main path was never launched: {kernels}")
    kernels += ops_kernels
    if any(not math.isfinite(k[key]) for k in kernels
           for key in ("ms", "plain_ms", "bound_ms")):
        fail("non-finite kernel time or bound")
    records.append(dict(phase="total", seconds=time.perf_counter() - t_start))
    emit(records[-1])
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(records=records, kernels=kernels),
                                   indent=1))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
