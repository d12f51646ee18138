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
   card's bound;
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
4. cli — ``repro_torch.launch.serve.main`` once (reduced config,
   ``--telemetry``: it prints the energy table).

Then a ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without that line. Without CUDA, or without the repository around this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
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
            if name == "serving" and timed:
                timing[flavor] = time_flavor(torch, sa, case, flavor,
                                             args, kw)
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


def schedule_meter(meters, geometry, prompt_lengths, k_per_wave, *,
                   sectored_hw=True):
    """A fresh ``meters.WaveMeter`` driven on the host with the schedule a
    FIFO session runs when every request is admitted before the first wave
    and none stops early: each prompt's prefill in request order, then one
    wave per entry of ``k_per_wave`` (the pages a slot fetches, probe
    included; None for a dense wave), request r in slot r at position
    ``len(prompt_r) + w`` in wave w."""
    m = meters.WaveMeter(geometry, sectored_hw=sectored_hw)
    for rid, n in enumerate(prompt_lengths):
        m.record_prefill(rid, n)
    for w, k in enumerate(k_per_wave):
        m.record_wave(sectored=k is not None, k_pages=k,
                      slots=[(rid, rid, n + w)
                             for rid, n in enumerate(prompt_lengths)])
    return m


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
              specs=None, dense=False):
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
    out = dict(phase="main_path", kernel="dense" if dense else kernel,
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
    from repro_torch.models import model
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
        del params
        torch.cuda.empty_cache()
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

    kernels = []
    for flavor in ("bf16", "int8"):
        t = timing[flavor]
        kernels.append(dict(
            name=f"sectored_attention_paged_{flavor}", route="cuda",
            source=KERNEL_SOURCE, replaces=TPU_KERNEL,
            path=("serving main path, CUDA graph replays: the greedy "
                  "fused leg and the two sampled graph legs" if flavor ==
                  "bf16" else "serving main path, CUDA graph replays"),
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
