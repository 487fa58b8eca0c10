"""TinyLlama 1.1B — llama2-architecture dense model, GQA kv=4.
[arXiv:2401.02385]"""
from repro_torch.configs.base import ArchConfig, register

TINYLLAMA_1_1B = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="arXiv:2401.02385",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    head_dim=64,
    rope_theta=10_000.0,
    act="silu",
))
