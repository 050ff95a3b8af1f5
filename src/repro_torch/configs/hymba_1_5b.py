"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads in every block.
[arXiv:2411.13676; hf]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32_001,
    attention=AttentionConfig(
        num_heads=25,
        num_kv_heads=5,
        sliding_window=1024,        # hymba uses SWA on most layers
        local_global_ratio=0,       # handled as all-local + hybrid global state
        rope_theta=10_000.0,
    ),
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2),
    hybrid_parallel=True,
    max_seq_len=8_192,
    tie_embeddings=True,
    act_fn="silu",
)
