"""Whisper-tiny — encoder-decoder audio model; mel+conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, register

WHISPER_TINY = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,             # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    head_dim=64,
    encoder_layers=4,
    encoder_tokens=1500,      # 30 s of audio at 50 Hz after conv frontend
    frontend="audio",
    frontend_tokens=1500,
    act="gelu",
    tie_embeddings=True,
))
