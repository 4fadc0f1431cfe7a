"""DeepSeek-V2 236B [arXiv:2405.04434]: 60L d=5120, MLA (kv_lora=512,
rope_dim=64, 128 heads), 2 shared + 160 routed experts top-6, first layer
dense d_ff... assignment gives d_ff=1536 = per-expert width; dense first
layer uses 4*rank heuristic (10944 in the release; we use 12288-aligned
10752 for MXU tiling — noted deviation).
The same numbers as `repro.configs.deepseek_v2_236b`.

One card serves the config cut to its dense first layer and 4 MoE layers
(`num_layers=5` of 60) at full width: 17,243,571,200 bf16 parameters,
34.5 GB (`chip_smoke.py` phase 4f). As in the reference's model, the
dense first layer's FFN is `_dense_ffn_width`, 2 * d_model = 10,240 wide.
"""
from repro_torch.configs.base import (DENSE, MLA, MOE, MLAConfig, MoEConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-assignment kv=128 (no GQA grouping)
    d_ff=1536,          # routed-expert width
    vocab_size=102_400,
    head_dim=128,       # nope head dim
    pattern=(MLA,),
    ffn_pattern=(MOE,),
    first_k_dense=1,    # layer 0: MLA + dense FFN (width 10752)
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128, absorb_decode=True),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, capacity_factor=1.0),
    rope_theta=10_000.0,
    sub_quadratic=False,   # MLA compresses KV but attention is full
    opt_state_dtype="bfloat16",
    remat_policy="nothing",  # §Perf B4: memory headroom
    train_microbatch=32,      # §Perf: memory-feasibility frontier (opt4)
    fsdp_over_pod=True,
)

SMOKE = CONFIG.scaled(
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=64, vocab_size=256, first_k_dense=1,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, dispatch="dense"),
    opt_state_dtype="float32")
