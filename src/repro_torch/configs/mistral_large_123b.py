"""Mistral-Large-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407]:
88L d=12288 96H GQA kv=8 d_ff=28672 vocab=32768.
The same numbers as `repro.configs.mistral_large_123b`.

At bf16 one card serves the config cut to 8 of its 88 layers at full width
(11,878,477,824 parameters, 23.8 GB; `chip_smoke.py` phase 4g).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    head_dim=128,
    pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    opt_state_dtype="bfloat16",   # 123B: fp32 m/v would not fit 16GB/chip
    train_microbatch=64,     # §Perf: fewer FSDP re-gathers (opt2)
    fsdp_over_pod=True,
    remat_policy="nothing",  # §Perf: memory headroom for micro=64 (opt3)
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256,
                      opt_state_dtype="float32")
