"""PaliGemma-3B — gemma LM consuming SigLIP patch embeddings; the vision
tower + projector are a STUB (input_specs provides 256 patch embeddings).
[arXiv:2407.07726]"""
from repro_torch.configs.base import ArchConfig, register

PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,           # gemma-2b MQA
    d_ff=16384,
    vocab_size=257_216,
    head_dim=256,
    frontend="vision",
    frontend_tokens=256,      # 224px / 14 SigLIP patches
    act="gelu",
    tie_embeddings=True,
))
