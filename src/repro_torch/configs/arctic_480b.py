"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a dense residual MLP in parallel (arctic's
dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    d_ff=4864,                      # per-expert FFN width
    vocab_size=32_000,
    attention=AttentionConfig(
        num_heads=56,
        num_kv_heads=8,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        dense_residual=True,
        dense_residual_ff=7168,     # arctic residual dense MLP (assumption)
        capacity_factor=1.25,
    ),
    max_seq_len=4_096,
    tie_embeddings=False,
    act_fn="silu",
)
