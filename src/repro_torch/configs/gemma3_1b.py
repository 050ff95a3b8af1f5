"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    d_ff=6912,
    vocab_size=262_144,
    attention=AttentionConfig(
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        sliding_window=512,
        local_global_ratio=5,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        qk_norm=True,
    ),
    max_seq_len=131_072,
    tie_embeddings=True,
    act_fn="gelu",
)
