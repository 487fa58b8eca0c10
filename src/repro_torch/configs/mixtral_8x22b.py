"""Mixtral 8x22B — 8 experts top-2 MoE, GQA, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ArchConfig, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    head_dim=128,
    num_experts=8,
    experts_per_token=2,
    moe_every=1,              # every block is MoE
    sliding_window=4096,
    rope_theta=1_000_000.0,
    act="silu",
))
