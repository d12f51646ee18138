"""Ranks of the port's tensor-parallel oracle (``tests/test_torch_tp.py``).

Each spawned process is one rank of a gloo process group on the CPU. It
runs every layer case (:data:`LAYER_CASES`) on the mesh of its world
size (``1x2`` on 2 ranks, ``2x2`` on 4): the layer function of the
partitioned program on the rank's operands (its blocks of the leaves
'model' splits, whole leaves elsewhere, gathered over the data axes
as the training step gathers them), on inputs and an output gradient
made from a seed (the same on every rank). It returns the output and
the gradients of the input and of each operand; the test process puts
the blocks together and compares them with the unsplit call, which it
runs itself. It then runs the training-step cases (:data:`STEP_CASES`)
twice, counts one step's FLOPs, and runs ``make_prefill_step`` and
``make_decode_step`` on the mesh. This module imports torch and
``repro_torch`` only.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_mesh_ranks import _finish, _init, _spawn
from _torch_train_ranks import TINY, batch, opt_cfg
from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, griffin, layers, model, moe, rwkv
from repro_torch.optim import adamw
from repro_torch.parallel import comm, sharding, tensor
from repro_torch.runtime.graphs import leaves
from repro_torch.train import step as train_step

#: world size -> the mesh it runs
MESHES = {2: "1x2", 4: "2x2"}
B, S = 2, 8
#: a tiny RWKV whose 3 layers do not divide over 2 ranks: 'model' leaves
#: ``wo``'s layer axis for its input rows, as at full width on 16x16
RWKV_ROWS = dict(n_layers=3)

#: case -> (arch, config overrides, fsdp, what runs, layer). The config is
#: ``TINY`` with the overrides, in f32 (so that a tolerance speaks of the
#: order of a split sum, not of bf16 rounding) unless they say otherwise.
LAYER_CASES = {
    # vocab rows over 'model'
    "embed": ("yi-6b", {}, False, "embed", None),
    "logits": ("yi-6b", {}, False, "logits", None),
    "loss": ("yi-6b", {}, False, "loss", None),
    "logits-tied": ("recurrentgemma-2b", {}, False, "logits", None),
    # attention: q heads and wo's head rows split; wk/wv on the layer axis
    "attn-heads": ("yi-6b", {}, False, "attn", 0),
    # wk/wv on their kv heads (4 heads, 2 kv heads)
    "attn-kv-heads": ("yi-6b", dict(n_heads=4, n_kv_heads=2), False,
                      "attn", 0),
    # a hybrid's per-layer wk: on d (a contraction) without fsdp, on hd
    # with it
    "attn-wk-d": ("recurrentgemma-2b", {}, False, "attn", 2),
    "attn-wk-hd": ("recurrentgemma-2b", {}, True, "attn", 2),
    "decode": ("yi-6b", dict(n_heads=4, n_kv_heads=2), False, "decode", 0),
    # SwiGLU: columns and rows split (a hybrid's 2-D FFN); whole (a
    # stacked dense FFN, 'model' on its layer axis)
    "swiglu-split": ("recurrentgemma-2b", {}, True, "mlp", 0),
    "swiglu-whole": ("yi-6b", {}, False, "mlp", 0),
    # experts and the router's columns
    "moe": ("qwen3-moe-235b-a22b", dict(dtype="bfloat16"), True, "moe", 0),
    "rglru": ("recurrentgemma-2b", {}, False, "rec", 0),
    # RWKV: wo on the layer axis (tiny), on its input rows (3 layers)
    "rwkv-wo-layer": ("rwkv6-1.6b", {}, False, "rwkv", 1),
    "rwkv-wo-rows": ("rwkv6-1.6b", dict(rwkv_head_dim=16, **RWKV_ROWS),
                     False, "rwkv", 1),
}

#: step case -> (arch, fsdp)
STEP_CASES = {"yi-6b": ("yi-6b", False), "moe": ("qwen3-moe-235b-a22b", True),
              "hybrid": ("recurrentgemma-2b", True)}


def step_cfg(arch: str):
    """A step case's config: ``TINY`` in bf16 (3 layers for the hybrid,
    one of each kind)."""
    extra = dict(n_layers=3) if arch == "recurrentgemma-2b" else {}
    return configs.get(arch).reduced(**{**TINY, **extra})


def case_cfg(arch: str, overrides: dict):
    extra = dict(n_layers=3) if arch == "recurrentgemma-2b" else {}
    kw = {**TINY, **extra, "dtype": "float32", **overrides}
    return configs.get(arch).reduced(**kw)


def _normal(shape, seed: int, dtype):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def inputs(case: str, cfg) -> dict:
    """The case's inputs (the same on every rank and in the test)."""
    what = LAYER_CASES[case][3]
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    x = _normal((B, S, cfg.d_model), 11, dtype)
    if what == "decode":
        x = x[:, :1]
    return dict(tokens=tokens, labels=tokens.roll(-1, 1), x=x)


def operands(params: dict, cfg, case: str):
    """The (sub)tree of ``params`` the case reads, and its path."""
    what, layer = LAYER_CASES[case][3], LAYER_CASES[case][4]
    if layer is None:
        return {k: v for k, v in params.items() if k != "layers"}, ()
    lp = model.layer_params(params, layer)
    key = {"attn": "attn", "decode": "attn", "mlp": "mlp", "moe": "moe",
           "rec": "rec", "rwkv": None}[what]
    return (lp if key is None else lp[key]), (() if key is None else (key,))


def call(case: str, cfg, ops: dict, inp: dict, tp):
    """The case's function on its operands; ``tensor.UNSPLIT`` runs the
    unsplit program. Returns the output (whole on every rank)."""
    what = LAYER_CASES[case][3]
    x = inp["x"]
    pos = torch.arange(x.shape[1]).expand(x.shape[0], -1)
    if what == "embed":
        return layers.embed(ops, inp["tokens"], tp)
    if what == "logits":
        return model.logits_fn(ops, cfg, x, tp)
    if what == "loss":
        return _loss(ops, cfg, x, inp["labels"], tp)
    if what == "attn":
        window = 0 if cfg.uniform_layers else cfg.local_window
        return attention.attend(ops, cfg, x, pos, window=window, tp=tp)
    if what == "decode":
        with torch.no_grad():
            return _decode(ops, cfg, x, tp)
    if what == "mlp":
        return layers.swiglu(ops, x, tp)
    if what == "moe":
        return moe.moe_ffn(ops, cfg, x, tp)
    if what == "rec":
        y, h = griffin.rglru(ops, x, torch.zeros(B, cfg.d_model), tp)
        return torch.cat([y, h[:, None]], 1)
    st = rwkv.init_state(cfg, B, dtype=x.dtype)
    st["S"] = _normal(st["S"].shape, 13, torch.float32)
    y, new = rwkv.rwkv_block(ops, cfg, x, st, tp)
    return torch.cat([y.flatten(), new["S"].flatten()])


def _loss(ops, cfg, hidden, labels, tp):
    """``lm_loss``'s head: the loss of ``hidden`` (the final norm's
    output) against ``labels``."""
    def forward(params, cfg, tokens, **kw):
        return hidden
    real = model.forward
    model.forward = forward
    try:
        return model.lm_loss(ops, cfg, labels, labels, tp=tp)
    finally:
        model.forward = real


def _decode(ops, cfg, x, tp):
    """One decode step of attention against a 5-row cache."""
    cache = attention.init_cache(cfg, B, 16, dtype=x.dtype)
    cache.k[:, :5] = _normal(cache.k[:, :5].shape, 17, x.dtype)
    cache.v[:, :5] = _normal(cache.v[:, :5].shape, 19, x.dtype)
    cache.length.fill_(5)
    out, _ = attention.decode_attend(ops, cfg, x, cache, tp=tp)
    return torch.cat([out.flatten(), cache.k.flatten(), cache.v.flatten()])


def grad_seed(out: torch.Tensor) -> torch.Tensor:
    return _normal(out.shape, 23, out.dtype)


def run_layer_case(case: str, mesh) -> dict:
    """The case's output and gradients on this rank: ``out``, ``gx`` (the
    input's gradient; None for the token cases), and for each operand
    leaf (in ``leaves`` order) its gradient and its landing."""
    arch, over, fsdp, what, layer = LAYER_CASES[case]
    cfg = case_cfg(arch, over)
    params = model.init_params(cfg, seed=0, device="cpu")
    pspec = sharding.param_shardings(mesh, params, fsdp=fsdp)
    tp, lands = train_step.split_context(mesh, cfg, pspec)
    mc = comm.MeshComm(mesh)
    blocks = sharding.place(params, pspec, mesh)
    tree, hook = train_step.mesh_params(
        blocks, cfg, list(sharding.spec_leaves(pspec)),
        lambda t, s, key: mc.gather(t, s), lands)
    if layer is not None:
        tree = {**tree, "layers": [hook(i, model.layer_params(tree, i))
                                   for i in range(cfg.n_layers)]}
    ops, path = operands(tree, cfg, case)
    ctp = tp if layer is None else tp.layer(layer)
    for key in path:
        ctp = ctp.at(key)
    ops = _leafy(ops)
    inp = inputs(case, cfg)
    x = inp["x"].requires_grad_(what not in ("embed",))
    out = call(case, cfg, ops, inp, ctp)
    gx, gops = _grads(out, x, ops)
    return dict(out=out.detach(), gx=gx, grads=gops,
                lands=sharding.landing_leaves(_lands_at(ctp.lands)),
                model_index=ctp.index)


def _lands_at(lands):
    return {k: v for k, v in lands.items() if k != "layers"} \
        if isinstance(lands, dict) and "layers" in lands else lands


def _leafy(ops):
    """The operands as leaf tensors that take a gradient."""
    from repro_torch.runtime.graphs import unflatten
    return unflatten(ops, [t.detach().clone().requires_grad_(True)
                           for t in leaves(ops)])


def reference_call(case: str) -> dict:
    """The unsplit call of ``case`` (the test process's side)."""
    arch, over, fsdp, what, layer = LAYER_CASES[case]
    cfg = case_cfg(arch, over)
    params = model.init_params(cfg, seed=0, device="cpu")
    ops, _ = operands(params, cfg, case)
    ops = _leafy(ops)
    inp = inputs(case, cfg)
    x = inp["x"].requires_grad_(what not in ("embed",))
    out = call(case, cfg, ops, inp, tensor.UNSPLIT)
    gx, gops = _grads(out, x, ops)
    return dict(out=out.detach(), gx=gx, grads=gops)


def _grads(out, x, ops):
    """The gradients of ``x`` (None where it takes none) and of each
    operand leaf under the seeded output gradient (none for a call
    without autograd, the decode step)."""
    if not out.requires_grad:
        return None, []
    want = [t for t in [x] + list(leaves(ops)) if t.requires_grad]
    grads = torch.autograd.grad(out, want, grad_seed(out), allow_unused=True)
    if x.requires_grad:
        return grads[0], list(grads[1:])
    return None, list(grads)



def run_step_case(case: str, mesh) -> dict:
    """Two steps of the case from seed-0 parameters: the losses, the
    global state after them, the rank's parameter blocks (and which
    leaves 'model' leaves whole in storage), its final hidden states
    (replicated activations), and one step's counted FLOPs beside the
    count the landings imply, and its ``tp`` collectives."""
    arch, fsdp = STEP_CASES[case]
    cfg = step_cfg(arch)
    ocfg = opt_cfg(False, 1e6)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, ins, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg,
                                            fsdp=fsdp)
    p = sharding.place(params, ins[0], mesh)
    o = sharding.place(adamw.init_state(params, ocfg), ins[1], mesh)
    shard, n = fn.mesh_comm.data_shard()
    losses, calls = [], None
    for step in range(2):
        comm.reset_launches()
        comm.reset_bytes()
        p, o, m = fn(p, o, batch(step, shard, n))
        losses.append(m["loss"])
        if calls is None:
            calls = dict(tp=comm.launches["tp"],
                         bytes=dict(comm.collective_bytes))
    b = batch(0, shard, n)
    with FlopCounterMode(display=False) as flops:
        fn(p, o, b)
    tree, tp = train_step.serving_params(cfg, mesh, ins[0])(p)
    with torch.no_grad():
        hidden = model.forward(tree, cfg, b["tokens"], tp=tp)
    mc = fn.mesh_comm
    state = [mc.gather(t, s, purpose="checkpoint") for t, s in zip(
        leaves(dict(params=p, opt=o)),
        sharding.spec_leaves(dict(params=ins[0], opt=ins[1])))]
    return dict(losses=losses, state=state, flops=flops.get_total_flops(),
                rows=b["tokens"].shape[0], calls=calls, hidden=hidden,
                local=[t.clone() for t in leaves(p)],
                replicated=["model" not in sharding.spec_axes(s)
                            for s in sharding.spec_leaves(ins[0])],
                coords=dict(fn.mesh_comm.coords),
                implied=tensor.step_flops(cfg, fn.tp, *b["tokens"].shape))


def ref_case(mesh, dtype: str) -> dict:
    """The tiny yi-6b's loss and gradients (gathered whole) on the step-1
    batch, and one step's loss: the port's side of the reference
    comparison (``tests/_torch_tp_reference.py``)."""
    cfg = configs.get("yi-6b").reduced(**TINY, dtype=dtype)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    params = model.init_params(cfg, seed=0, device="cpu")
    fn, ins, _ = train_step.make_train_step(cfg, mesh, opt_cfg=ocfg)
    specs = list(sharding.spec_leaves(ins[0]))
    p = sharding.place(params, ins[0], mesh)
    b = batch(1)
    lands = sharding.landing_leaves(fn.tp.lands)
    with train_step.deterministic():
        loss, g = train_step.mesh_value_and_grad(
            p, cfg, b["tokens"], b["labels"], fn.mesh_comm, specs,
            tp=fn.tp, lands=lands)
    grads = [fn.mesh_comm.gather(x, s) for x, s in zip(g, specs)]
    # the clip's global norm, as the update takes it on the rank's blocks
    gnorm = torch.sqrt(fn.mesh_comm.sum_of_shards(
        [adamw._sum_squares(x) for x in g], specs))
    _, _, m = fn(p, sharding.place(adamw.init_state(params, ocfg), ins[1],
                                   mesh), b)
    return dict(loss=loss, grads=grads, step_loss=m["loss"], gnorm=gnorm)


#: serve case -> (arch, config overrides): a uniform stack with its kv
#: heads split, a hybrid's per-layer caches and RG-LRU states, and an
#: RWKV stack's recurrent states
SERVE_CASES = {"yi-6b": ("yi-6b", dict(n_heads=4, n_kv_heads=2)),
               "hybrid": ("recurrentgemma-2b", {}),
               "rwkv": ("rwkv6-1.6b", {})}


def serve_case(case: str, mesh) -> dict:
    """``make_prefill_step`` and ``make_decode_step`` on the mesh (the
    partitioned program on the rank's blocks): the rank's rows, their
    prefill logits and state (the rank's rows, whole over 'model'), one
    decode step's logits on that state placed by the step's own state
    specs, the new state's blocks and each block's index in the whole
    state."""
    arch, over = SERVE_CASES[case]
    cfg = case_cfg(arch, over)
    params = model.init_params(cfg, seed=0, device="cpu")
    prefill, (pspec, _) = train_step.make_prefill_step(cfg, mesh)
    decode, (_, sspec, _), _ = train_step.make_decode_step(
        cfg, mesh, batch=B, seq_len=S)
    blocks = sharding.place(params, pspec, mesh)
    mc = comm.MeshComm(mesh)
    shard, n = mc.data_shard()
    rows = slice(shard * B // n, (shard + 1) * B // n)
    tokens = inputs("embed", cfg)["tokens"][rows]
    # the prefill's state holds the rank's rows: its block under the
    # decode step's specs is its block over 'model'
    over_model = train_step._map_specs(lambda s: sharding.P(*(
        "model" if "model" in sharding._axes_of(e) else None for e in s)),
        sspec)
    with torch.no_grad():
        logits, state = prefill(blocks, tokens)
        whole = [t.clone() for t in leaves(state)]
        index = [sharding.local_slice(spec, tuple(t.shape), mesh, mc.coords)
                 for spec, t in zip(sharding.spec_leaves(over_model), whole,
                                    strict=True)]
        step, new = decode(blocks, sharding.place(state, over_model, mesh),
                           tokens[:, :1])
    return dict(rows=rows, prefill=logits, state=whole, decode=step,
                after=[t.clone() for t in leaves(new)], index=index)


def rank_main(rank: int, world: int, store: str, outdir: str) -> None:
    _init(rank, world, store)
    mesh = mesh_mod.make_serving_mesh(MESHES[world], device="cpu")
    results = {("layer", c): run_layer_case(c, mesh) for c in LAYER_CASES}
    for c in STEP_CASES:
        results[("step", c)] = [run_step_case(c, mesh) for _ in range(2)]
    for c in SERVE_CASES:
        results[("serve", c)] = serve_case(c, mesh)
    if world == 2:
        for dtype in ("float32", "bfloat16"):
            results[("ref", dtype)] = ref_case(mesh, dtype)
    _finish(rank, outdir, results)


def spawn_tp(world: int, tmpdir: str, timeout: float = 300.0) -> list:
    return _spawn(rank_main, world, tmpdir, timeout=timeout)
