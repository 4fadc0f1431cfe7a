"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: 24L d=2048 32H MHA,
partial rotary 25%. The same numbers as `repro.configs.stablelm_1_6b`."""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    partial_rotary_factor=0.25,
    sub_quadratic=False,
    opt_state_dtype="float32",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=256)
