"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres tiling; the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf family; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64_000,
    attention=AttentionConfig(
        num_heads=56,
        num_kv_heads=8,
        rope_theta=1_000_000.0,
    ),
    frontend="image_patches",
    frontend_dim=1024,              # CLIP-large patch embedding dim (stub)
    num_patches=2880,               # anyres: base 576 + 4 tiles * 576
    max_seq_len=32_768,
    tie_embeddings=False,
    act_fn="silu",
)
