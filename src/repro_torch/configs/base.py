"""Model/run configuration dataclasses: the port's own copy of
`repro.configs.base`, field for field, so a config file fully determines the
architecture on both sides.

Layer structure is a repeating *pattern group*: ``pattern`` is a tuple of
mixer kinds (one entry per layer in the group) and ``ffn_pattern`` a
parallel tuple of FFN kinds. ``num_layers`` must be ``first_k_dense`` plus a
multiple of ``len(pattern)``; the model loops over pattern-group repetitions
whose parameters are stacked along a leading ``num_groups`` axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# mixer kinds
ATTN = "attn"        # global softmax attention
SWA = "swa"          # sliding-window attention (window_size)
MLA = "mla"          # DeepSeek multi-head latent attention
MAMBA = "mamba"      # Mamba selective SSM
MLSTM = "mlstm"      # xLSTM matrix-LSTM
SLSTM = "slstm"      # xLSTM scalar-LSTM

# ffn kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch: str = "dropping"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    scan_chunk: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 2.0
    conv1d_kernel: int = 4
    num_heads_slstm: int = 4


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    absorb_decode: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # layer structure
    pattern: Tuple[str, ...] = (ATTN,)
    ffn_pattern: Tuple[str, ...] = (DENSE,)
    first_k_dense: int = 0           # leading layers forced to (pattern[0], DENSE)

    # attention options
    rope_theta: float = 10_000.0
    partial_rotary_factor: float = 1.0
    window_size: int = 0             # for SWA layers
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = False

    # sub-configs
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    mla: Optional[MLAConfig] = None

    # encoder-decoder
    encoder_layers: int = 0          # >0 -> enc-dec; decoder = num_layers
    # modality frontend stub
    input_mode: str = "tokens"       # tokens | frames | tokens+image
    num_image_tokens: int = 0        # for tokens+image
    frame_dim: int = 0               # for frames (0 -> d_model)

    # numerics / memory
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    norm_eps: float = 1e-6
    remat_policy: str = "nothing"    # nothing | dots | full(=no remat)
    logit_softcap: float = 0.0       # final-logit softcap
    train_microbatch: int = 0        # 0 = no gradient accumulation
    sequence_parallel: bool = True
    fsdp_over_pod: bool = False

    # serving
    sub_quadratic: bool = False      # eligible for long_500k

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if len(self.pattern) != len(self.ffn_pattern):
            raise ValueError(f"{self.name}: pattern/ffn_pattern length mismatch")
        if (self.num_layers - self.first_k_dense) % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} minus "
                f"first_k_dense {self.first_k_dense} not divisible by "
                f"pattern {len(self.pattern)}")

    @property
    def num_groups(self) -> int:
        return (self.num_layers - self.first_k_dense) // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def scaled(self, **kw) -> "ModelConfig":
        """Return a copy with overrides (used for reduced smoke configs)."""
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shape cells that apply to this architecture (long_500k only for
    sub-quadratic archs)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)
