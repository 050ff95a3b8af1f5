"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (no separate FFN; blocks carry their own up/down projections).
[arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    d_ff=0,                         # xLSTM blocks have internal projections
    vocab_size=50_304,
    attention=AttentionConfig(      # nominal GQA spec (used for head grouping)
        num_heads=4,
        num_kv_heads=4,
    ),
    ssm=SSMConfig(
        state_size=64,              # mLSTM per-head matrix-memory dim
        expand=2,
        num_heads=4,
        block_pattern="mmms",       # 3 mLSTM : 1 sLSTM, cycled over 24 layers
    ),
    max_seq_len=131_072,
    tie_embeddings=True,
    act_fn="gelu",
)
