"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262_144,
    attention=AttentionConfig(
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,               # gemma3 uses explicit head_dim=256
        sliding_window=1024,
        local_global_ratio=5,       # 5 local : 1 global
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        qk_norm=True,
    ),
    max_seq_len=131_072,
    tie_embeddings=True,
    act_fn="gelu",
)
