"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 / MQA) d_ff=24576
vocab=49152 — llama-architecture code model. [arXiv:2405.04324; hf]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    d_ff=24576,
    vocab_size=49_152,
    attention=AttentionConfig(
        num_heads=48,
        num_kv_heads=1,             # MQA
        rope_theta=10_000.0,
    ),
    max_seq_len=8_192,
    gated_mlp=False,            # GPT-BigCode-style 2-matrix MLP (hits ~34B)
    tie_embeddings=True,
    act_fn="silu",
)
