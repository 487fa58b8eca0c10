"""Architecture configuration system (the port's copy of the JAX
package's ``configs/base.py``: pure data, no JAX).

Every architecture is expressed as an ``ArchConfig``. The port registers
every configuration the JAX package does; CPU tests use ``reduced()``
variants of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Block kinds used by the transformer assembler.
ATTN = "attn"          # attention + MLP block (dense)
MOE = "moe"            # attention + MoE block
MAMBA = "mamba"        # Mamba2 (SSD) block
SHARED_ATTN = "shared_attn"  # weight-shared full transformer block (zamba2)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    source: str                 # citation (paper / model card)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # every n-th block is MoE (llama4 interleaves)
    shared_expert: bool = False

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256        # SSD chunk length

    # --- hybrid (zamba2): shared transformer block every n mamba blocks ---
    hybrid_attn_every: int = 0

    # --- attention variants ---
    sliding_window: int = 0     # 0 = full causal attention
    global_attn_every: int = 0  # llama4 iRoPE: every n-th layer global

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_tokens: int = 0     # fixed frame count from the audio frontend

    # --- modality frontend stub ---
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_tokens: int = 0         # patch/frame embeddings prepended

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, in order."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append(MAMBA)
            elif self.family == "hybrid":
                if self.hybrid_attn_every and i % self.hybrid_attn_every == 0:
                    kinds.append(SHARED_ATTN)
                kinds.append(MAMBA)
            elif self.num_experts > 0 and (i % self.moe_every) == self.moe_every - 1:
                kinds.append(MOE)
            else:
                kinds.append(ATTN)
        return tuple(kinds)

    def supports_long_context(self) -> bool:
        """Sub-quadratic attention available -> long_500k is runnable."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def supports_decode(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = min(self.num_kv_heads, n_heads)
        # keep the GQA ratio flavour: at least 1 kv head
        n_kv = max(1, min(n_kv, n_heads))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_every=1 if self.num_experts else self.moe_every,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=32,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_tokens=16 if self.encoder_tokens else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            dtype="float32",
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches the model builders)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.act == "silu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff + self.d_ff + d
        norms = 2 * d
        total = 0
        for kind in self.block_kinds():
            if kind == ATTN:
                total += attn + mlp + norms
            elif kind == MOE:
                router = d * self.num_experts
                experts = self.num_experts * 3 * d * self.d_ff
                shared = 3 * d * self.d_ff if self.shared_expert else 0
                total += attn + router + experts + shared + norms
            elif kind == MAMBA:
                total += self._mamba_params()
            elif kind == SHARED_ATTN:
                pass  # counted once below
        if self.family == "hybrid" and self.hybrid_attn_every:
            total += attn + mlp + norms  # single shared copy
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + norms)       # enc self-attn
            total += len(self.block_kinds()) * (attn + d)             # cross-attn per dec layer
        total += self.vocab_size * d                                  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                              # lm head
        total += d                                                    # final norm
        return total

    def _mamba_params(self) -> int:
        d = self.d_model
        d_inner = self.ssm_expand * d
        nheads = d_inner // self.ssm_head_dim
        in_proj = d * (2 * d_inner + 2 * nheads * self.ssm_state + nheads)
        conv = self.ssm_conv_width * (d_inner + 2 * nheads * self.ssm_state)
        out = d_inner * d
        extra = 2 * nheads + d_inner  # A_log, D, dt_bias-ish + norm
        return in_proj + conv + out + extra + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe = sum(1 for k in self.block_kinds() if k == MOE)
        dead = n_moe * (self.num_experts - self.experts_per_token) * 3 * self.d_model * self.d_ff
        return full - dead


_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
