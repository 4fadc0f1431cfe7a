"""xLSTM-125M [arXiv:2405.04517]: 12L d_model=768, alternating sLSTM/mLSTM.
The same numbers as `repro.configs.xlstm_125m`.

`d_ff=0`: xLSTM blocks carry their own up/down projections (proj factor 2)
instead of a separate FFN. 4 heads for both cell types (the kv=4 is
vestigial for the recurrent mixers).
"""
from repro_torch.configs.base import (MLSTM, NONE, SLSTM, ModelConfig,
                                      XLSTMConfig)

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=768 // 4,
    pattern=(SLSTM, MLSTM),
    ffn_pattern=(NONE, NONE),
    xlstm=XLSTMConfig(proj_factor_mlstm=2.0, proj_factor_slstm=2.0,
                      conv1d_kernel=4, num_heads_slstm=4),
    tie_embeddings=True,
    sub_quadratic=True,
    sequence_parallel=False,
    opt_state_dtype="float32",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                      head_dim=32, vocab_size=256)
