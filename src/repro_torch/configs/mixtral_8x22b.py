"""Mixtral-8x22B [arXiv:2401.04088]: 56L d=6144 48H GQA kv=8, 8 experts
top-2, SWA w=4096. The same numbers as `repro.configs.mixtral_8x22b`.

At bf16 the 56 layers hold 140,630,071,296 parameters (281 GB): one card
serves the config cut to 8 layers at full width (20,435,146,752, 40.9 GB)
and trains it cut to 1 (`chip_smoke.py` phases 4d and 5b).
"""
from repro_torch.configs.base import MOE, SWA, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    head_dim=128,
    pattern=(SWA,),
    ffn_pattern=(MOE,),
    window_size=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16_384),
    rope_theta=1_000_000.0,
    sub_quadratic=True,
    opt_state_dtype="bfloat16",   # 141B total params
    train_microbatch=64,
    fsdp_over_pod=True,
    remat_policy="dots",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256, window_size=16,
                      moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                                    dispatch="dense"),
                      opt_state_dtype="float32")
