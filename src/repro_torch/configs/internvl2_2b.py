"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B backbone, 24L d=2048
16H GQA kv=8 d_ff=8192 vocab=92553. InternViT frontend is a stub: inputs
include 256 precomputed projected patch embeddings prepended to the text.
The same numbers as `repro.configs.internvl2_2b`.

At bf16 it holds 1,893,828,608 parameters (3.8 GB; `chip_smoke.py` phase
4g).
"""
from repro_torch.configs.base import ATTN, DENSE, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    pattern=(ATTN,),
    ffn_pattern=(DENSE,),
    input_mode="tokens+image",
    num_image_tokens=256,
    rope_theta=1_000_000.0,
    sub_quadratic=False,
    opt_state_dtype="float32",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256,
                      num_image_tokens=16)
