"""Zamba2-1.2B — hybrid: Mamba2 backbone + a single weight-SHARED full
transformer block applied periodically. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_1_2B = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,            # mamba blocks
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,          # shared block is MHA
    d_ff=8192,
    vocab_size=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,      # shared transformer block every 6 mamba blocks
    act="silu",
    tie_embeddings=True,
))
