"""GLM-4 9B — dense, RoPE, aggressive GQA (kv=2). [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import ArchConfig, register

GLM4_9B = register(ArchConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151_552,
    head_dim=128,
    rope_theta=10_000.0,
    act="silu",
))
