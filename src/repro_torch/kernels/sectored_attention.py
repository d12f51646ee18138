"""Sectored decode attention: the CUDA kernels' wrappers and their plain
PyTorch versions, over the paged (serving) and the head-major layout.

Counterpart of the JAX package's ``kernels/sectored_attention.py:
sectored_attention_paged`` (the Pallas ``_paged_kernel``), the one kernel
on the serving path. For each (batch, kv-head) it reads only the K pages
the sector predictor selected from the page-major cache view
``(B, P, page, Hkv, hd)`` — a free reshape of the ``(B, S, Hkv, hd)``
decode cache — masks positions at or past ``length`` (a **count**: the
runtime passes ``cache.length + 1``), runs one softmax over K x page per
query row and returns the output and the per-page attention mass the
sector-history table is updated with.

* :func:`sectored_attention_paged` — the wrapper. On CPU tensors it runs
  :func:`sectored_attention_paged_ref`; on CUDA tensors it launches
  ``csrc/sectored_attention_paged.cu`` (bf16 or int8 flavor) or raises.
  There is no fallback from one to the other.
* :func:`sectored_attention_paged_ref` — the plain version: gathers the
  selected pages and calls :func:`attend_pages`, the same arithmetic the
  runtime's dispatch path uses, so on the CPU the fused path is bitwise
  the dispatch path.

* :func:`sectored_attention` — the same page steering over the
  head-major layout ``(B, Hkv, P, page, hd)``, counterpart of the JAX
  package's ``sectored_attention`` (the Pallas ``_ref_kernel``): q, k and
  v in f32 or bf16, all arithmetic in f32 (``e`` is not rounded before
  the output contraction) and no mass output. CPU tensors take
  :func:`sectored_attention_ref`; CUDA tensors launch
  ``csrc/sectored_attention.cu`` or raise.

``launches`` (paged, per flavor) and ``head_major_launches`` (per input
dtype) count kernel launches; only the wrappers' CUDA branches increment
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, build

NEG_INF = -1e30
SOURCE = "sectored_attention_paged"
FLAVORS = ("bf16", "int8")

HEAD_MAJOR_SOURCE = "sectored_attention"
HEAD_MAJOR_FLAVORS = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: paged kernel launches by flavor since the last :func:`reset_launches`
launches = {flavor: 0 for flavor in FLAVORS}
#: head-major kernel launches by input dtype, reset with the paged ones
head_major_launches = {flavor: 0 for flavor in HEAD_MAJOR_FLAVORS.values()}


def reset_launches() -> None:
    for counts in (launches, head_major_launches):
        for flavor in counts:
            counts[flavor] = 0


def _check_page_idx(page_idx: torch.Tensor, hkv: int) -> bool:
    """Validate page_idx's head axis against the cache and return the
    shared-pages flag (one page set per sequence, walked by every head).

    A silently wrong flag would make every head walk head 0's pages (or
    read out of bounds), so shape-vs-flag agreement is enforced loudly."""
    if page_idx.ndim != 3:
        raise ValueError(
            f"page_idx must be (B, Hkv, K) or (B, 1, K); got shape "
            f"{tuple(page_idx.shape)}")
    heads = page_idx.shape[1]
    if heads not in (1, hkv):
        raise ValueError(
            f"page_idx head axis must be 1 (shared sector set) or Hkv="
            f"{hkv}; got {heads} — a mismatched head axis would steer "
            f"every head through the wrong page schedule")
    return heads == 1 and hkv > 1


def _check_shapes(q, k_pages, v_pages, page_idx, length, k_scale, v_scale):
    if q.ndim != 4 or k_pages.ndim != 5:
        raise ValueError(
            f"q must be (B, Hkv, rep, hd) and k_pages (B, P, page, Hkv, hd); "
            f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, Hkv, _, hd = q.shape
    Bk, _, _, Hk, hdk = k_pages.shape
    if (Bk, Hk, hdk) != (B, Hkv, hd) or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"cache pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do "
            f"not match q {tuple(q.shape)}")
    if page_idx.shape[0] != B or tuple(length.shape) != (B,):
        raise ValueError(
            f"page_idx {tuple(page_idx.shape)} and length "
            f"{tuple(length.shape)} must lead with B={B}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None:
        want = (B, k_pages.shape[1], Hkv)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"k_scale/v_scale must be {want}; got "
                             f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}")


def attend_pages(qg, k_sel, v_sel, valid):
    """Masked softmax attention over gathered pages, and per-page mass.

    qg (B, Hkv, rep, hd); k_sel/v_sel (B, Hkv, K, page, hd) — bf16 on the
    serving path, f32 once dequantized; valid (B, Hkv, K, page) bool.
    Returns ``(out (B, Hkv, rep, hd) f32, mass (B, Hkv, K) f32)``.

    Products of the operands are exact in f32 (the reference's bf16
    einsums with ``preferred_element_type=f32``); ``e`` is cast to the V
    dtype before the output contraction (``e.astype(v.dtype)``: bf16 on
    the serving path, a no-op for dequantized f32 V). The sqrt divisor is a
    0-dim tensor on the device (a fill, no host copy) so CUDA divides
    instead of multiplying by a reciprocal.
    """
    hd = qg.shape[-1]
    scores = torch.einsum("bgrk,bgcpk->bgrcp", qg.to(k_sel.dtype).float(),
                          k_sel.float())
    scores = scores / torch.sqrt(
        torch.full((), hd, dtype=torch.float32, device=scores.device))
    vmask = valid[:, :, None]
    scores = torch.where(vmask, scores, NEG_INF)
    m = torch.amax(scores, dim=(-2, -1), keepdim=True)
    e = torch.where(vmask, torch.exp(scores - m), 0.0)
    num = torch.einsum("bgrcp,bgcpk->bgrk", e.to(v_sel.dtype).float(),
                       v_sel.float())
    den = torch.sum(e, dim=(-2, -1))[..., None]
    out = num / torch.clamp_min(den, 1e-30)
    mass = torch.sum(e, dim=(2, 4)) / torch.clamp_min(
        torch.sum(e, dim=(2, 3, 4))[..., None], 1e-30)
    return out, mass


def gather_pages(pages: torch.Tensor, page_idx: torch.Tensor) -> torch.Tensor:
    """(B, P, page, Hkv, hd) page-major cache + (B, Hkv, K) indices ->
    (B, Hkv, K, page, hd), the selected pages of each head."""
    B, _, _, hkv, _ = pages.shape
    b = torch.arange(B, device=pages.device)[:, None, None]
    h = torch.arange(hkv, device=pages.device)[None, :, None]
    return pages.permute(0, 3, 1, 2, 4)[b, h, page_idx.long()]


def sectored_attention_paged_ref(q, k_pages, v_pages, page_idx, length, *,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`sectored_attention_paged` (same
    arguments, same results up to the order of float sums)."""
    _check_page_idx(page_idx, k_pages.shape[3])
    _check_shapes(q, k_pages, v_pages, page_idx, length, k_scale, v_scale)
    B, Hkv = q.shape[:2]
    page = k_pages.shape[2]
    pages = page_idx.expand(B, Hkv, page_idx.shape[-1])
    k_sel = gather_pages(k_pages, pages)
    v_sel = gather_pages(v_pages, pages)
    if k_scale is not None:
        # dequantize in f32 with the one scale of each (page, head) sector
        ks = gather_pages(k_scale[:, :, None, :, None], pages)
        vs = gather_pages(v_scale[:, :, None, :, None], pages)
        k_sel = k_sel.float() * ks
        v_sel = v_sel.float() * vs
        q = q.float()
    tok_pos = (pages[..., None] * page
               + torch.arange(page, device=pages.device))
    valid = tok_pos < length[:, None, None, None]
    return attend_pages(q, k_sel, v_sel, valid)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


#: the most blocks of one cluster: 8 is portable, 16 needs the
#: non-portable cluster size the kernel asks for
CLUSTER_MAX = 8
CLUSTER_MAX_NONPORTABLE = 16
#: the fewest token slots worth a block of their own
MIN_SLOTS_PER_BLOCK = 32
#: the most shared memory one block may use on the card (227 KB)
SMEM_LIMIT = 232448


def paged_smem_bytes(rep: int, hd: int, K: int, chunk: int,
                     kv_itemsize: int) -> int:
    """Shared memory of one block of the paged kernel (``smem_bytes`` in
    ``csrc/sectored_attention_paged.cu``): the slice's K rows (padded by
    16 bytes) and V rows, each rounded up to 16 rows, then q (rows padded
    by 4), the scores, the partial numerator, row statistics, the page mass
    and per-slot sums and scales (f32), then per-slot cache rows
    (int32)."""
    floats = (rep * (2 * hd + 4) + rep * (chunk + 1) + 4 * rep + K
              + 3 * chunk)
    # whole 16-row tiles of K and V, K's rows padded by 16 bytes
    rows16 = -(-chunk // 16) * 16
    return rows16 * (2 * hd * kv_itemsize + 16) + 4 * floats + 4 * chunk


def cluster_plan(K: int, page: int, rep: int, hd: int,
                 kv_itemsize: int) -> tuple[int, int]:
    """``(C, chunk)``: the paged kernel's cluster of C blocks per
    (batch, kv-head), block r taking token slots ``[r * chunk,
    min((r + 1) * chunk, K * page))``.

    C grows with ``K * page`` up to ``CLUSTER_MAX`` (at least
    ``MIN_SLOTS_PER_BLOCK`` slots a block), and up to
    ``CLUSTER_MAX_NONPORTABLE`` where a block's shared memory needs it;
    every block gets at least one slot. Raises when even 16 blocks cannot
    hold a slice."""
    n = K * page
    for limit in (CLUSTER_MAX, CLUSTER_MAX_NONPORTABLE):
        C = max(1, min(limit, -(-n // MIN_SLOTS_PER_BLOCK)))
        if limit > CLUSTER_MAX:
            C = limit
        chunk = -(-n // C)
        C = -(-n // chunk)
        if paged_smem_bytes(rep, hd, K, chunk, kv_itemsize) <= SMEM_LIMIT:
            return C, chunk
    raise ValueError(
        f"paged kernel: K*page={n} slots with rep={rep}, hd={hd} need more "
        f"shared memory than a cluster of {CLUSTER_MAX_NONPORTABLE} blocks "
        f"holds ({SMEM_LIMIT} bytes a block)")


@functools.cache
def _bind(lib: ctypes.CDLL):
    """The library's C entries with their argument types: the two
    flavors' launchers."""
    fns = {}
    for flavor, n_ptrs in (("bf16", 7), ("int8", 9)):
        fn = getattr(lib, f"sectored_attention_paged_{flavor}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[flavor] = fn
    return fns


def sectored_attention_paged(q, k_pages, v_pages, page_idx, length, *,
                             k_scale=None, v_scale=None):
    """Serving-path attention over predictor-selected KV pages.

    q (B, Hkv, rep, hd) bf16; k_pages/v_pages (B, P, page, Hkv, hd) bf16,
    or int8 with ``k_scale``/``v_scale`` (B, P, Hkv) f32; page_idx
    (B, Hkv, K) or (B, 1, K) int32 (a singleton head axis is one shared
    page set per sequence); length (B,) int32 count of valid tokens,
    including the token appended this step.

    Returns ``(out (B, Hkv, rep, hd) f32, mass (B, Hkv, K) f32)``.

    CPU tensors take :func:`sectored_attention_paged_ref`. CUDA tensors
    launch the kernel on the current stream (no synchronisation) and count
    the launch in ``launches``; anything the kernel does not take raises.
    """
    _check_page_idx(page_idx, k_pages.shape[3])
    _check_shapes(q, k_pages, v_pages, page_idx, length, k_scale, v_scale)
    tensors = [q, k_pages, v_pages, page_idx, length]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if not backend.uses_kernel(*tensors):
        return sectored_attention_paged_ref(q, k_pages, v_pages, page_idx,
                                            length, k_scale=k_scale,
                                            v_scale=v_scale)
    flavor = "bf16" if k_scale is None else "int8"
    kv_dtype = torch.bfloat16 if flavor == "bf16" else torch.int8
    want = {"q": (q, torch.bfloat16), "k_pages": (k_pages, kv_dtype),
            "v_pages": (v_pages, kv_dtype), "page_idx": (page_idx, torch.int32),
            "length": (length, torch.int32)}
    if k_scale is not None:
        want.update(k_scale=(k_scale, torch.float32),
                    v_scale=(v_scale, torch.float32))
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{flavor} kernel: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{flavor} kernel: {name} must be contiguous "
                             f"(the page-major view of a contiguous "
                             f"(B, S, Hkv, hd) cache is)")
    B, Hkv, rep, hd = q.shape
    _, P, page, _, _ = k_pages.shape
    K = page_idx.shape[-1]
    if hd % 32 or hd > 256:
        raise ValueError(f"kernel needs head_dim % 32 == 0 and <= 256; "
                         f"got {hd}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:  # rows are copied in 16-byte pieces
            raise ValueError(f"{flavor} kernel: {name} must be 16-byte "
                             f"aligned")
    C, chunk = cluster_plan(K, page, rep, hd, k_pages.element_size())
    fn = _bind(build.load(SOURCE))[flavor]
    out = torch.empty((B, Hkv, rep, hd), dtype=torch.float32,
                      device=q.device)
    mass = torch.empty((B, Hkv, K), dtype=torch.float32, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = [_ptr(q), _ptr(k_pages), _ptr(v_pages)]
    if flavor == "int8":
        ptrs += [_ptr(k_scale), _ptr(v_scale)]
    ptrs += [_ptr(page_idx), _ptr(length), _ptr(out), _ptr(mass)]
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B, Hkv, rep, hd, P, page, K, page_idx.shape[1], C,
                 chunk, stream)
    if err != 0:
        raise RuntimeError(f"sectored_attention_paged_{flavor} launch "
                           f"failed: CUDA error {err}")
    launches[flavor] += 1
    return out, mass


# -- head-major layout ---------------------------------------------------------


def _check_head_major(q, k_pages, v_pages, page_idx, length):
    if q.ndim != 4 or k_pages.ndim != 5:
        raise ValueError(
            f"q must be (B, Hkv, rep, hd) and k_pages (B, Hkv, P, page, hd); "
            f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, Hkv, _, hd = q.shape
    Bk, Hk, _, _, hdk = k_pages.shape
    if (Bk, Hk, hdk) != (B, Hkv, hd) or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"cache pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do "
            f"not match q {tuple(q.shape)}")
    if page_idx.shape[0] != B or tuple(length.shape) != (B,):
        raise ValueError(
            f"page_idx {tuple(page_idx.shape)} and length "
            f"{tuple(length.shape)} must lead with B={B}")
    if (q.dtype not in HEAD_MAJOR_FLAVORS or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise TypeError(f"q, k_pages and v_pages must all be float32 or all "
                        f"bfloat16; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if page_idx.dtype != torch.int32 or length.dtype != torch.int32:
        raise TypeError(f"page_idx and length must be int32; got "
                        f"{page_idx.dtype} and {length.dtype}")
    if hd % 32 or hd > 256:
        raise ValueError(f"head_dim must be a multiple of 32 and <= 256; "
                         f"got {hd}")


def sectored_attention_ref(q, k_pages, v_pages, page_idx, length):
    """Plain PyTorch version of :func:`sectored_attention`: the JAX
    package's ``ref.sectored_attention_ref`` op for op (gather the selected
    pages, f32 scores, count mask, one softmax over K x page, f32 ``e``
    into the output contraction)."""
    _check_page_idx(page_idx, k_pages.shape[1])
    _check_head_major(q, k_pages, v_pages, page_idx, length)
    B, Hkv = q.shape[:2]
    page = k_pages.shape[3]
    pages = page_idx.expand(B, Hkv, page_idx.shape[-1])
    b = torch.arange(B, device=q.device)[:, None, None]
    h = torch.arange(Hkv, device=q.device)[None, :, None]
    k_sel = k_pages[b, h, pages.long()]
    v_sel = v_pages[b, h, pages.long()]
    tok_pos = (pages[..., None] * page
               + torch.arange(page, device=pages.device))
    valid = tok_pos < length[:, None, None, None]
    # f32 V: attend_pages' cast of e to the V dtype is then a no-op
    out, _ = attend_pages(q.float(), k_sel.float(), v_sel.float(), valid)
    return out


# The head-major kernel's constants (``csrc/sectored_attention.cu``):
#: query rows one block takes (grid y covers more), warps of a block
HM_ROWS = 64
HM_WARPS = 8
#: the slice's scores are kept whole up to this many bytes (else the tiled
#: walk recomputes them tile by tile); the most ring stages
HM_SCORE_BUDGET = 65536
HM_MAX_STAGES = 8
#: tile sizes the tiled walk tries, largest first
HM_TILES = (128, 64, 32, 16)


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def head_major_layout(rep: int, hd: int, itemsize: int, chunk: int,
                      tile: int) -> tuple[int, int, bool]:
    """``(smem bytes, ring stages, scores kept)`` of one block of the
    head-major kernel (``smem_plan`` in ``csrc/sectored_attention.cu``):
    the ring of K / V tiles (reused afterwards for the warps' partial e V
    and row sums), the scores (the slice's, or a tile's where those do not
    fit ``HM_SCORE_BUDGET``), the block's partial e V, four row statistics,
    per-slot validity bytes and one mbarrier per stage. ``tile == chunk``
    loads the slice whole in two stages (K and V)."""
    rows = min(rep, HM_ROWS)
    whole = tile >= chunk
    nt = -(-chunk // tile)
    store = whole or 4 * rows * (chunk + 1) <= HM_SCORE_BUDGET
    sslots = chunk if store else tile
    tile_bytes = tile * hd * itemsize
    partial = 4 * 8 * HM_WARPS * (hd + 1)
    fixed = (_a16(4 * rows * (sslots + 1)) + 4 * rows * hd + _a16(16 * rows)
             + _a16(sslots))
    if whole:
        stages = 2
    else:
        room = max(0, SMEM_LIMIT - fixed - 8 * HM_MAX_STAGES)
        stages = min(room // tile_bytes, (2 if store else 3) * nt,
                     HM_MAX_STAGES)
    ring = _a16(max(stages * tile_bytes, partial))
    return ring + fixed + 8 * stages, stages, store


def head_major_plan(K: int, page: int, rep: int, hd: int,
                    itemsize: int) -> tuple[int, int, int]:
    """``(C, chunk, tile)``: the head-major kernel's cluster of C blocks
    per (batch, kv-head), block r taking token slots ``[r * chunk,
    min((r + 1) * chunk, K * page))`` in tiles of ``tile`` slots.

    Like :func:`cluster_plan`, C grows with ``K * page`` up to
    ``CLUSTER_MAX`` (at least ``MIN_SLOTS_PER_BLOCK`` slots a block), and
    to ``CLUSTER_MAX_NONPORTABLE`` where a block's shared memory needs it;
    ``tile == chunk`` while the slice fits a block whole. Past that, 16
    blocks walk their slices in the largest tile that leaves four ring
    stages (else two, else one). Every shape the kernel takes gets a
    plan."""
    n = K * page
    for limit in (CLUSTER_MAX, CLUSTER_MAX_NONPORTABLE):
        C = max(1, min(limit, -(-n // MIN_SLOTS_PER_BLOCK)))
        if limit > CLUSTER_MAX:
            C = limit
        chunk = -(-n // C)
        C = -(-n // chunk)
        if head_major_layout(rep, hd, itemsize, chunk,
                             chunk)[0] <= SMEM_LIMIT:
            return C, chunk, chunk
    for want in (4, 2, 1):
        for tile in HM_TILES:
            if tile >= chunk:
                continue
            smem, stages, _ = head_major_layout(rep, hd, itemsize, chunk,
                                                tile)
            if stages >= want and smem <= SMEM_LIMIT:
                return C, chunk, tile
    raise ValueError(
        f"head-major kernel: no plan for K*page={n} slots with rep={rep}, "
        f"hd={hd}")


@functools.cache
def _bind_head_major(lib: ctypes.CDLL):
    fns = {}
    for flavor in HEAD_MAJOR_FLAVORS.values():
        fn = getattr(lib, f"sectored_attention_{flavor}")
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[flavor] = fn
    return fns


def sectored_attention(q, k_pages, v_pages, page_idx, length):
    """Attention over predictor-selected pages of a head-major cache.

    q (B, Hkv, rep, hd); k_pages/v_pages (B, Hkv, P, page, hd), all three
    float32 or all bfloat16, hd a multiple of 32 up to 256; page_idx
    (B, Hkv, K) or (B, 1, K) int32 (a singleton head axis is one shared page
    set per sequence); length (B,) int32 count of valid tokens.

    Returns ``out (B, Hkv, rep, hd) f32``; 0 where no selected token is
    valid. A page index repeated in ``page_idx`` is counted each time.

    CPU tensors take :func:`sectored_attention_ref`. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count the launch
    in ``head_major_launches``; anything the kernel does not take raises.
    """
    _check_page_idx(page_idx, k_pages.shape[1])
    _check_head_major(q, k_pages, v_pages, page_idx, length)
    tensors = (q, k_pages, v_pages, page_idx, length)
    if not backend.uses_kernel(*tensors):
        return sectored_attention_ref(*tensors)
    for name, t in zip(("q", "k_pages", "v_pages", "page_idx", "length"),
                       tensors):
        if not t.is_contiguous():
            raise ValueError(f"sectored_attention kernel: {name} must be "
                             f"contiguous")
    B, Hkv, rep, hd = q.shape
    _, _, P, page, _ = k_pages.shape
    K = page_idx.shape[-1]
    flavor = HEAD_MAJOR_FLAVORS[q.dtype]
    fns = _bind_head_major(build.load(HEAD_MAJOR_SOURCE))
    C, chunk, tile = head_major_plan(K, page, rep, hd, q.element_size())
    out = torch.empty((B, Hkv, rep, hd), dtype=torch.float32,
                      device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = [_ptr(t) for t in (*tensors, out)]
    with torch.cuda.device(q.device):
        err = fns[flavor](*ptrs, B, Hkv, rep, hd, P, page, K,
                          page_idx.shape[1], C, chunk, tile, stream)
    if err != 0:
        raise RuntimeError(f"sectored_attention_{flavor} launch failed: "
                           f"CUDA error {err}")
    head_major_launches[flavor] += 1
    return out
