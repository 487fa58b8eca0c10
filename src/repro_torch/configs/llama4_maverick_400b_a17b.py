"""Llama-4 Maverick 400B-A17B — MoE, 128 experts top-1, interleaved MoE
layers, iRoPE-style chunked-local attention with periodic global layers.
[hf:meta-llama/Llama-4-Scout-17B-16E (family card); Maverick variant]"""
from repro_torch.configs.base import ArchConfig, register

LLAMA4_MAVERICK = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,              # Maverick interleaves dense / MoE blocks
    shared_expert=True,       # Llama-4 routed + shared expert
    sliding_window=8192,      # chunked local attention (iRoPE)
    global_attn_every=4,      # every 4th layer attends globally (NoPE)
    rope_theta=500_000.0,
    act="silu",
))
