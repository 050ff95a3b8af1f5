"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131_072,
    attention=AttentionConfig(
        num_heads=48,
        num_kv_heads=8,
        rope_theta=10_000.0,
        logit_softcap=30.0,         # grok attention logit soft-capping
    ),
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        capacity_factor=1.25,
    ),
    max_seq_len=8_192,
    tie_embeddings=True,
    act_fn="gelu",
)
