"""StarCoder2-15B — dense code model, GQA, RoPE, 4k sliding window.
[arXiv:2402.19173]"""
from repro_torch.configs.base import ArchConfig, register

STARCODER2_15B = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49_152,
    head_dim=128,
    sliding_window=4096,
    rope_theta=100_000.0,
    act="gelu",
))
