"""Model configuration: :class:`ModelConfig`, the registry,
:meth:`ModelConfig.reduced` and the assigned shapes (:class:`ShapeConfig`,
``SHAPES``).

A copy of the dataclass logic of ``repro.models.config`` (the JAX
reference), so that ``repro_torch`` imports nothing of that package.
``src/repro_torch/configs/<arch>.py`` instantiates each ported
architecture and registers it here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# Block kinds used in per-layer patterns.  Sliding-window vs full attention
# is NOT a separate kind: it is a per-layer ``windows`` scalar (0 = full),
# so mixed local:global stacks still compile as a single scanned body.
ATTN = "attn"            # (self-)attention + MLP transformer block
ATTN_CROSS = "attn_cross"  # decoder block: self-attn + cross-attn + MLP
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
HYMBA = "hymba"          # parallel attention ∥ SSM heads + MLP


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- block structure -----------------------------------------------------
    block_pattern: tuple[str, ...] = ()   # per-layer kinds; () -> all ATTN
    mlp: str = "swiglu"            # swiglu | geglu | squared_relu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- attention -----------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3: separate theta for global layers
    sliding_window: int = 0          # window for SWA layers (windows != 0)
    windows: tuple[int, ...] = ()    # per-layer window; 0 = full attention

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "lacin_ep"       # lacin_ep | dense (no EP comms)
    expert_pad_to: int = 16          # pad expert STORE to a multiple of the
                                     # EP axis (granite: 40 -> 48); router
                                     # never selects padding experts

    # --- SSM / recurrent -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    num_meta_tokens: int = 0         # hymba learnable prefix tokens

    # --- encoder-decoder / frontends ------------------------------------------
    encoder_layers: int = 0
    encoder_seq_len: int = 0         # stub frontend sequence length (frames)
    num_patch_tokens: int = 0        # vlm stub prefix length

    # --- execution knobs (not architecture) -----------------------------------
    vocab_pad_to: int = 16           # pad the embedding/unembedding STORE so
                                     # the vocab dim shards evenly (Megatron-
                                     # style); pad logits are masked to -inf
    # beyond-paper perf knobs (default OFF = paper-faithful baseline):
    attn_skip_diagonal: bool = False  # skip above-diagonal KV blocks (causal)
    attn_banded: bool = False         # band KV blocks for static windows;
                                      # splits mixed-window stacks into
                                      # uniform-window runs
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"              # full | dots | none
    attention_impl: str = "reference"  # reference | pallas
    scan_layers: bool = True
    # decode-time KV layout: "full" keeps seq-len cache on every layer;
    # "windowed" keeps only sliding_window entries for SWA layers.
    swa_cache: str = "full"

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", (ATTN,) * self.num_layers)
        if not self.windows:
            object.__setattr__(self, "windows", (0,) * self.num_layers)
        if len(self.block_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: block_pattern has {len(self.block_pattern)} entries "
                f"for {self.num_layers} layers")
        if len(self.windows) != self.num_layers:
            raise ValueError(f"{self.name}: windows must have one entry per layer")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads must be divisible by kv heads")

    # -- derived ---------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def vocab_padded(self) -> int:
        pad = max(self.vocab_pad_to, 1)
        return -(-self.vocab_size // pad) * pad

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def kinds(self) -> tuple[str, ...]:
        return self.block_pattern

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, h, kv, dh = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.block_pattern:
            if kind in (ATTN, ATTN_CROSS, HYMBA):
                attn = d * dh * (h + 2 * kv) + h * dh * d
                if kind == HYMBA:
                    inner = self.ssm_expand * d
                    attn += (d * inner * 2 + inner * self.conv_kernel
                             + inner * (2 * self.ssm_state + 1) + inner * d)
                total += attn
                if self.is_moe:
                    gated = 3 if self.mlp in ("swiglu", "geglu") else 2
                    total += self.num_experts * gated * d * self.d_ff + d * self.num_experts
                elif self.d_ff:
                    gated = 3 if self.mlp in ("swiglu", "geglu") else 2
                    total += gated * d * self.d_ff
            elif kind == MLSTM:
                inner = self.ssm_expand * d
                total += d * inner * 2              # up gate/val
                total += inner * self.conv_kernel   # depthwise conv
                total += inner * inner * 3          # q, k, v over inner
                total += inner * 3                  # i, f gates + skip scale
                total += inner * d                  # down
            elif kind == SLSTM:
                total += d * d * 4                  # input gates
                total += self.num_heads * (d // self.num_heads) ** 2 * 4  # recurrent
                total += inner_ffn(d)
        if self.is_encdec:
            # encoder blocks (ATTN) + decoder cross-attention
            attn = d * dh * (h + 2 * kv) + h * dh * d
            gated = 3 if self.mlp in ("swiglu", "geglu") else 2
            total += self.encoder_layers * (attn + gated * d * self.d_ff)
            total += self.num_layers * attn       # cross-attn per decoder layer
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        gated = 3 if self.mlp in ("swiglu", "geglu") else 2
        moe_total = self.num_layers * self.num_experts * gated * d * self.d_ff
        moe_active = self.num_layers * self.top_k * gated * d * self.d_ff
        return self.param_count() - moe_total + moe_active

    # -- reduced (smoke-test) variant -------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        layers = min(self.num_layers, 4)
        pattern = _reduce_pattern(self.block_pattern, layers)
        kv = min(self.num_kv_heads, 2)   # keep GQA grouping (1 or 2 kv heads)
        heads = 4                        # 4 query heads, q_per_kv = 4 or 2
        wins = [min(w, 8) for w in self.windows[:layers]]
        if 0 in self.windows and any(self.windows) and 0 not in wins:
            wins[-1] = 0  # keep the local:global mix in the reduced config
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            block_pattern=pattern,
            windows=tuple(wins),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_pad_to=1,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 16),
            num_patch_tokens=min(self.num_patch_tokens, 8),
            num_meta_tokens=min(self.num_meta_tokens, 4),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            remat="none",
            scan_layers=self.scan_layers,
        )


def inner_ffn(d: int) -> int:
    """sLSTM post-FFN (xLSTM uses a 4/3 gated projection)."""
    ff = int(d * 4 / 3)
    return 3 * d * ff


def _reduce_pattern(pattern: tuple[str, ...], layers: int) -> tuple[str, ...]:
    """Keep the *variety* of block kinds in a shorter pattern."""
    kinds = []
    for k in pattern:
        if k not in kinds:
            kinds.append(k)
    out = list(pattern[:layers])
    # make sure every kind appears at least once
    for idx, k in enumerate(kinds):
        if k not in out and idx < layers:
            out[-(idx + 1)] = k
    return tuple(out)


# ---------------------------------------------------------------------------
# Shapes (assigned): four cells per architecture.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in
                                  (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

#: Architectures with sub-quadratic sequence handling, eligible for the
#: ``long_500k`` cell (others are skipped per the assignment, see DESIGN.md).
LONG_CONTEXT_OK = frozenset({"xlstm-350m", "hymba-1.5b", "gemma3-1b"})


def cell_is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("pure full-attention architecture: 524k-token decode "
                       "needs sub-quadratic attention (DESIGN.md §6)")
    return True, ""


# ---------------------------------------------------------------------------
# Registry (populated by repro_torch.configs modules).
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
