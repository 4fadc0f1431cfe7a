"""Gemma-3-12B [hf:google/gemma-3-12b-pt]: 48L d=3840 16H GQA kv=8,
5 local (SWA w=1024) : 1 global, qk-norm, vocab 262144, 128k context.
The same numbers as `repro.configs.gemma3_12b`.

At bf16 the 48 layers hold 11,765,395,200 parameters (23.5 GB): one card
serves it whole (`chip_smoke.py` phase 4e); its head_dim of 256 is one of
the flash kernel's.
"""
from repro_torch.configs.base import ATTN, DENSE, SWA, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    head_dim=256,
    pattern=(SWA, SWA, SWA, SWA, SWA, ATTN),
    ffn_pattern=(DENSE,) * 6,
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    # 5/6 layers windowed; global layers are O(S) at decode -> long_500k runs
    sub_quadratic=True,
    opt_state_dtype="float32",
    remat_policy="dots",
    train_microbatch=64,
)

SMOKE = CONFIG.scaled(num_layers=6, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=512, window_size=16)
