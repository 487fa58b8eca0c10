"""MiniCPM-2B — llama-like dense arch trained with the WSD schedule
(the schedule lives in repro_torch.optim.schedules.wsd). [arXiv:2404.06395]"""
from repro_torch.configs.base import ArchConfig, register

MINICPM_2B = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    act="silu",
    tie_embeddings=True,
))
