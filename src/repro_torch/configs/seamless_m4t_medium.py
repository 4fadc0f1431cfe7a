"""SeamlessM4T-medium [arXiv:2308.11596]: enc-dec, d=1024 16H d_ff=4096,
vocab 256206. '12L' interpreted as 12 encoder + 12 decoder layers
(UnitY-medium-like; assumption noted in DESIGN.md). Speech frontend is a
stub: inputs are precomputed frame embeddings (B, T, d).
The same numbers as `repro.configs.seamless_m4t_medium`.

At bf16 the 12 + 12 layers hold 979,433,472 parameters (2.0 GB;
`chip_smoke.py` phase 4g).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    input_mode="frames",
    sub_quadratic=False,
    opt_state_dtype="float32",
)

SMOKE = CONFIG.scaled(num_layers=2, encoder_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
                      vocab_size=256)
