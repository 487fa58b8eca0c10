"""Mamba2-130M — attention-free SSM with state-space duality (SSD).
[arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, register

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
))
