"""Config system for the CoRD-JAX framework.

Plain dataclasses (no external deps), with:
  * ``ModelConfig``   — architecture description covering every assigned family
  * ``ShapeConfig``   — (seq_len, global_batch, kind) input-shape cells
  * ``MeshConfig``    — mesh shape/axis names (single-pod / multi-pod)
  * ``DataplaneConfig`` — CoRD dataplane mode + policies + technique toggles
  * ``TrainConfig`` / ``ServeConfig`` / ``RunConfig``
  * ``apply_overrides`` — ``key.subkey=value`` CLI override support
  * ``reduced``       — shrink any ModelConfig to a CPU-smoke-test size
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    # Arctic-style: a dense residual MLP runs in parallel with the expert MLPs.
    dense_residual: bool = False
    dense_residual_ff: int = 0
    # capacity factor for fixed-capacity dispatch (EP all-to-all friendly)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block parameters (mamba, mLSTM, sLSTM)."""
    state_size: int = 16          # N in mamba; per-head state for mLSTM
    conv_width: int = 4           # depthwise conv width in mamba
    expand: int = 2               # inner expansion factor
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    num_heads: int = 4            # heads for mLSTM/sLSTM
    block_pattern: str = "m"      # xlstm: string over {"m","s"} cycled across layers


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0             # 0 -> d_model // num_heads
    # sliding-window pattern: window>0 enables local attention;
    # local_global_ratio = k means layers cycle [k local, 1 global].
    sliding_window: int = 0
    local_global_ratio: int = 0   # 0 -> all layers global (or all local if window>0)
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 uses a larger theta on global layers
    logit_softcap: float = 0.0
    qk_norm: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32_000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    max_seq_len: int = 131_072
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act_fn: str = "silu"          # silu | gelu
    gated_mlp: bool = True        # SwiGLU/GeGLU (3 mats) vs classic MLP (2 mats)
    # enc-dec (whisper): encoder layer count; decoder uses num_layers.
    encoder_layers: int = 0
    encoder_max_len: int = 1500   # whisper: 1500 frames after conv frontend
    # modality frontend stub: "none" | "audio_frames" | "image_patches"
    frontend: str = "none"
    frontend_dim: int = 0         # embedding dim delivered by the (stub) frontend
    num_patches: int = 0          # vlm: patches per image (anyres tiling stub)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # hybrid (hymba): attention and mamba run in parallel in every block
    hybrid_parallel: bool = True

    @property
    def head_dim(self) -> int:
        a = self.attention
        return a.head_dim if a.head_dim else self.d_model // max(a.num_heads, 1)

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state does not grow ~ O(seq) for *all* layers.

        Used to decide long_500k applicability (see configs/__init__.py
        LONG_CONTEXT_ARCHS)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True
        a = self.attention
        # sliding-window archs with a local:global pattern: local layers have
        # O(window) KV; we treat them as runnable for long_500k.
        return a.sliding_window > 0 and a.local_global_ratio > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        a = self.attention
        hd = self.head_dim
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        att = self.d_model * hd * (a.num_heads + 2 * a.num_kv_heads) \
            + a.num_heads * hd * self.d_model
        nmat = 3 if self.gated_mlp else 2
        if self.family == "moe":
            m = self.moe
            ff_exp = nmat * self.d_model * self.d_ff * m.num_experts
            ff_dense = (nmat * self.d_model * m.dense_residual_ff
                        if m.dense_residual else 0)
            router = self.d_model * m.num_experts
            ff = ff_exp + ff_dense + router
        elif self.family == "ssm":
            # xlstm: inner projections replace FFN; approximate with expand factor
            inner = self.ssm.expand * self.d_model
            ff = 2 * self.d_model * inner + inner * self.d_model \
                + 4 * inner * self.ssm.state_size
        else:
            ff = nmat * self.d_model * self.d_ff
        if self.family == "hybrid":
            inner = self.ssm.expand * self.d_model
            ff += 2 * self.d_model * inner + inner * self.d_model
        layers = self.num_layers + self.encoder_layers
        return emb + out + layers * (att + ff + 2 * self.d_model) + self.d_model

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        nmat = 3 if self.gated_mlp else 2
        ff_all = nmat * self.d_model * self.d_ff * m.num_experts * self.num_layers
        ff_act = nmat * self.d_model * self.d_ff * m.top_k * self.num_layers
        return full - ff_all + ff_act


# ---------------------------------------------------------------------------
# Input shapes (the four assigned cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / dataplane / run configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # Axis sizes for the production meshes (see launch/mesh.py). For local CPU
    # runs, ``local_devices`` overrides with a (data, model) mesh of that many
    # host devices.
    local_devices: int = 0
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: str = "pod"


@dataclass(frozen=True)
class DataplaneConfig:
    """CoRD dataplane configuration — the paper's knobs."""
    mode: str = "cord"            # bypass | cord | socket
    # Technique toggles (paper Fig. 1). True = technique active (fast path).
    # Effective value = mode preset AND toggle, so setting one False
    # "removes" that technique from any mode (cord/socket presets already
    # remove kernel_bypass / zero_copy+polling respectively).
    zero_copy: bool = True
    polling: bool = True
    kernel_bypass: bool = True
    # Fuse the pipeline's pure-cost stages into one delay chain + one
    # staged-copy pass per side (bit-identical, smaller per-op HLO).
    # False keeps one chain/copy per stage (the pre-fusion shape, kept
    # for ablation and the fusion-equivalence tests).
    fuse_mediation: bool = True
    # Pallas dataplane kernels (kernels/dataplane): "auto" runs the real
    # bounce-copy / in-kernel-cost kernels on TPU and the XLA emulation
    # elsewhere; "on" forces the kernels everywhere (interpret mode
    # off-TPU — the bit-equivalence test path); "off" keeps the XLA
    # emulation.  Value-identical in all three settings.
    pallas_dataplane: str = "auto"
    # Policy set enforced in cord mode.
    policies: tuple[str, ...] = ("telemetry",)
    # Tenants sharing this dataplane (per-tenant runtime accounting/QoS).
    # The Dataplane's own tenant is always included.
    tenants: tuple[str, ...] = ()
    # Chunked-collective scheduling (QoS + compute/comm overlap).
    chunk_bytes: int = 0          # 0 = no chunking
    # Cost emulation (perftest/NPB measured paths only; off for model paths
    # so dry-run cost analysis stays clean).
    emulate_costs: bool = False
    # Emulated interrupt cost in microseconds when polling is disabled
    # (the paper's wait-for-event path).
    interrupt_cost_us: float = 8.0
    # Per-op mediation cost emulation: the user->kernel crossing.
    syscall_cost_ns: float = 400.0
    # Extra per-op cost of the full socket/IPoIB kernel network stack.
    socket_stack_ns: float = 3000.0
    # IPoIB bandwidth degradation: extra ns per payload byte on the
    # socket path (calibrated against the measured bypass bandwidth).
    socket_ns_per_byte: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 1024
    global_batch: int = 8
    microbatch: int = 0           # 0 = no grad accumulation
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    opt_dtype: str = "float32"    # adam mu/nu dtype ("bfloat16" halves opt mem)
    seed: int = 0
    remat: str = "none"           # none | full | dots
    grad_compression: str = "none"  # none | int8
    checkpoint_every: int = 0     # 0 = disabled
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    prefill_chunk: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0
    kv_cache_len: int = 4096
    # Slot scheduler: "continuous" = persistent decode slots with
    # mid-decode WFQ refill (fixed-shape decode step, compiled once);
    # "gang" = legacy batch-to-completion scheduling (convoy effect,
    # shape-derived recompiles) — kept as the benchmark baseline.
    scheduler: str = "continuous"
    # Host-bucket admission charges len(prompt) tokens per request; rate
    # and burst from QoSPolicy.rates (defined in ops) scale by this many
    # tokens per traced-rate unit.
    admission_token_scale: float = 4.0
    # Per-tenant cap on concurrently held decode slots (0 = uncapped) —
    # the hard ceiling on a tenant's decode-step budget per engine step.
    max_slots_per_tenant: int = 0
    # Paged KV cache (docs/serving.md).  block_size > 0 switches the
    # continuous engine from per-slot fixed stripes to a shared block
    # pool with per-slot block tables; 0 keeps the legacy stripe layout.
    block_size: int = 0
    # Usable pool blocks (0 = auto: max_batch * kv_cache_len/block_size,
    # i.e. the same token capacity the stripe layout preallocates).
    n_blocks: int = 0

    def __post_init__(self):
        if self.block_size < 0:
            raise ValueError(f"block_size must be >= 0, got {self.block_size}")
        if self.block_size > 0 and self.kv_cache_len % self.block_size:
            raise ValueError(
                f"block_size={self.block_size} must divide "
                f"kv_cache_len={self.kv_cache_len} — partial trailing "
                f"blocks would silently truncate a slot's cache")
        if self.n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0, got {self.n_blocks}")
        if self.n_blocks > 0 and self.block_size == 0:
            raise ValueError(
                f"n_blocks={self.n_blocks} requires block_size > 0 — the "
                f"pool is only allocated under the paged layout")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.prefill_chunk > 0:
            if self.prefill_chunk < 8 or (
                    self.prefill_chunk & (self.prefill_chunk - 1)):
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be 0 (off) or "
                    f"a power of two >= 8 (the minimum prompt bucket) so "
                    f"chunk covers nest inside prompt buckets")
            if self.block_size > 0 and self.prefill_chunk % self.block_size:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a multiple "
                    f"of block_size={self.block_size} so chunk scatters stay "
                    f"block-aligned")


@dataclass(frozen=True)
class ObsConfig:
    """Per-tenant observability timelines (core/obs.py).

    Opt-in and provably free when off: snapshots read host/device arrays
    only *between* steps, never inside traced code, so traced results are
    bit-identical with the toggle on or off (tests/test_obs.py)."""
    timeline: bool = False        # snapshot per-tenant counters each step
    every: int = 1                # snapshot every N steps / engine ticks
    out_dir: str = "runs"         # where *_timeline.json artifacts land
    spark_width: int = 48         # console sparkline panel width
    panel: bool = True            # print per-tenant panels at end of run


@dataclass(frozen=True)
class ElasticConfig:
    """Observability-triggered elastic remesh — the closed control loop
    (docs/elasticity.md): a ThresholdWatcher (core/obs.py) over the
    timeline's rate series drives runtime/elastic.py remesh, with live
    QP migration for in-flight verbs connections (core/verbs.py).

    ``thresholds`` are CLI-friendly ``"rate_field=level"`` strings over
    the derived rate series (``obs.RATE_FIELDS``); ``release_thresholds``
    (same format, levels strictly below their trigger counterparts) arm
    the grow-back half of the cycle — sustained quiet under every release
    level restores a shrunken tenant to its pre-shrink slice (or, on the
    serve side, its pre-shrink slot budget).  Empty = shrink-only, the
    pre-pod-control-plane behaviour."""
    enabled: bool = False
    thresholds: tuple[str, ...] = ("denied_pct=50",)
    sustain: int = 3              # consecutive over-threshold windows to trip
    cooldown: int = 8             # windows a tripped tenant cannot re-trip
    shrink_factor: int = 2        # device shrink per remesh (largest axis)
    min_devices: int = 2          # never shrink below this many devices
    max_remesh: int = 1           # shrink remeshes per run (0 = unlimited);
    # grow-backs close the cycle and are not counted against the budget
    tenants: tuple[str, ...] = ()  # watched tenants; empty = all
    release_thresholds: tuple[str, ...] = ()  # grow-back arm; empty = off
    release_sustain: int = 3      # consecutive under-release windows to grow
    release_cooldown: int = 8     # windows before a grown tenant re-grows
    # Observe-only byte budget wired by ``launch/train.py --elastic``: a
    # QuotaPolicy(hard=False) marks runtime traffic over this budget in
    # the tenant's `denied` counter — the default trigger signal.
    meter_quota_bytes: int = 0    # 0 = no metering policy added


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    shape: ShapeConfig = SHAPES["train_4k"]
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dataplane: DataplaneConfig = field(default_factory=DataplaneConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink an architecture to CPU smoke-test size, preserving its family
    and structural quirks (GQA ratio, local:global pattern, MoE top-k, dense
    residual, hybrid parallelism, enc-dec split...)."""
    a = cfg.attention
    heads = max(2, min(4, a.num_heads))
    kv = max(1, min(heads, max(1, round(heads * a.num_kv_heads / max(a.num_heads, 1)))))
    # keep the head-grouping divisible
    while heads % kv:
        kv -= 1
    att = replace(
        a,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        sliding_window=min(a.sliding_window, 8) if a.sliding_window else 0,
    )
    moe = cfg.moe
    if moe.num_experts:
        moe = replace(moe, num_experts=4, top_k=min(2, moe.top_k),
                      dense_residual_ff=64 if moe.dense_residual else 0)
    ssm = replace(cfg.ssm, state_size=min(cfg.ssm.state_size, 8), num_heads=2)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4 if not cfg.encoder_layers else 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        attention=att,
        moe=moe,
        ssm=ssm,
        max_seq_len=512,
        encoder_max_len=32,
        num_patches=8 if cfg.num_patches else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        dtype="float32",
    )


# ---------------------------------------------------------------------------
# CLI overrides: "train.steps=10" / "dataplane.mode=bypass" / "model.d_model=128"
# ---------------------------------------------------------------------------

def _coerce(val: str, typ: Any) -> Any:
    if typ is bool or isinstance(typ, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    if typ is tuple or (hasattr(typ, "__origin__") and typ.__origin__ is tuple):
        return tuple(v for v in val.split(",") if v)
    return val


def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
    """Apply ``a.b.c=value`` overrides to a (possibly nested) frozen dataclass."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        cfg = _set_path(cfg, key.split("."), val)
    return cfg


def _set_path(obj: Any, path: list[str], val: str) -> Any:
    name, rest = path[0], path[1:]
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot descend into non-dataclass at {name!r}")
    fld = {f.name: f for f in fields(obj)}.get(name)
    if fld is None:
        raise KeyError(f"unknown config field {name!r} on {type(obj).__name__}")
    cur = getattr(obj, name)
    if rest:
        new = _set_path(cur, rest, val)
    else:
        typ = fld.type if isinstance(fld.type, type) else type(cur)
        new = _coerce(val, typ if cur is None else type(cur))
    return replace(obj, **{name: new})
