"""Phi-3-medium-14B [arXiv:2404.14219]: 40L d=5120 40H GQA kv=10, SwiGLU.
The same numbers as `repro.configs.phi3_medium_14b`.

At bf16 the 40 layers hold 14,659,507,200 parameters (29.3 GB): one card
serves it whole (`chip_smoke.py` phase 4g).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17_920,
    vocab_size=100_352,
    pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=10_000.0,
    sub_quadratic=False,
    opt_state_dtype="float32",
    remat_policy="dots",
    train_microbatch=128,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256)
