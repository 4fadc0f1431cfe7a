"""Jamba-1.5-Large 398B [arXiv:2403.19887]: 72L d=8192 64H GQA kv=8,
1 attention : 7 Mamba per 8-layer group, MoE 16e top-2 every other layer.
The same numbers as `repro.configs.jamba_1_5_large_398b`.

`Model(CONFIG)` builds, MoE layers included, but one card cannot hold even
one 8-layer group of it: its four MoE layers of 16 experts at d_ff 24,576
come to about 77 GB of bf16 experts. So the card serves a cut with dense
SwiGLU FFNs in place of the experts, `CONFIG.scaled(num_layers=8,
ffn_pattern=(DENSE,) * 8, moe=None)`: one 8-layer group at full width; the
MoE layers run at smoke widths (`SMOKE`).
"""
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, MambaConfig,
                                      MoEConfig, ModelConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    # 8-layer Jamba block: attn at position 4 (per paper), mamba elsewhere;
    # MoE every other layer.
    pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    ffn_pattern=(DENSE, MOE, DENSE, MOE, DENSE, MOE, DENSE, MOE),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, scan_chunk=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24_576),
    sub_quadratic=True,
    sequence_parallel=False,
    train_microbatch=16,
    fsdp_over_pod=True,
    opt_state_dtype="bfloat16",
    remat_policy="nothing",
)

SMOKE = CONFIG.scaled(num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256,
                      mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
                      moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                                    dispatch="dense"),
                      opt_state_dtype="float32")
