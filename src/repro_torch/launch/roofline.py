"""Roofline terms of a dry-run cell (counterpart of the JAX package's
``launch/roofline.py``).

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes accessed per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

Where the reference reads a compiled program's cost and memory analyses
and parses the collectives off its HLO text, the port traces the rank-0
program over fake tensors (``launch/dryrun.py``) and hands
:func:`analyze` a :class:`StepCost`: FLOPs counted by PyTorch's
``FlopCounterMode``, the bytes every op reads and writes, the peak of
the live bytes, and the collective bytes :mod:`repro_torch.parallel.comm`
counts (:func:`collective_bytes`; there is no HLO text to parse).

Hardware constants are NVIDIA's datasheet figures for one H100 SXM5, not
measurements: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink
per direction. Every time a row gives is an estimate on these figures.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 per card (datasheet)
HBM_BW = 3.35e12  # bytes/s per card (datasheet)
LINK_BW = 450e9  # NVLink bytes/s per direction per card (datasheet)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class StepCost:
    """What tracing one rank's step over fake tensors measured."""

    flops: float  # FlopCounterMode's count
    bytes_accessed: float  # every op's input and output bytes
    peak_bytes: int  # the most bytes live at once (arguments included)
    arg_bytes: int  # the step's arguments
    coll: dict  # collective output bytes by kind


def collective_bytes() -> dict[str, int]:
    """Bytes of every collective kind since ``parallel.comm``'s counters
    were reset (the port has no HLO text to parse)."""
    from repro_torch.parallel import comm
    return {k: int(comm.collective_bytes[k]) for k in _COLLECTIVES}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict[str, int]
    peak_memory_bytes: int  # per device
    model_flops: float  # 6*N*D (dense) / 6*N_active*D (MoE), whole step

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — catches remat/redundancy
        waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (the §Perf score)."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.roofline_time if self.roofline_time else 0.0

    def row(self) -> dict:
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            chips=self.chips,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            model_flops=self.model_flops,
            hlo_flops_total=self.flops_per_device * self.chips,
            useful_fraction=self.useful_flops_fraction,
            roofline_fraction=self.roofline_fraction,
            peak_memory_gib=self.peak_memory_bytes / 2**30,
            coll=self.coll_breakdown,
        )


def model_flops_for(cfg, shape_cfg) -> float:
    """Analytic useful FLOPs of one step (6ND + attention terms)."""
    n_active = cfg.active_param_count()
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        # attention score/value FLOPs (causal): 12 * L * H * hd * S/2 per tok
        if not cfg.attn_free:
            n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
            w = cfg.local_window or S
            eff = min(w, S)
            flops += 12.0 * n_attn * cfg.n_heads * cfg.head_dim_ * eff / 2 * tokens
        return flops
    if shape_cfg.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        if not cfg.attn_free:
            n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
            w = cfg.local_window or S
            flops += 4.0 * n_attn * cfg.n_heads * cfg.head_dim_ * min(w, S) / 2 * tokens
        return flops
    # decode: one token per sequence
    flops = 2.0 * n_active * B
    if not cfg.attn_free:
        n_attn = sum(1 for k in cfg.layer_kinds if k == "attn")
        w = cfg.local_window or S
        flops += 4.0 * n_attn * cfg.n_heads * cfg.head_dim_ * min(w, S) * B
    return flops


def analyze(cost: StepCost, *, arch, shape, mesh_name, chips,
            model_flops) -> Roofline:
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes_accessed),
        coll_bytes_per_device=float(sum(cost.coll.values())),
        coll_breakdown=dict(cost.coll),
        peak_memory_bytes=int(cost.peak_bytes),
        model_flops=model_flops,
    )
