"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 — enc-dec.

Conv frontend is a STUB: input_specs() provides precomputed frame embeddings
(1500 frames after the conv downsampling). [arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,                  # decoder layers
    encoder_layers=12,
    encoder_max_len=1500,
    d_model=768,
    d_ff=3072,
    vocab_size=51_865,
    attention=AttentionConfig(
        num_heads=12,
        num_kv_heads=12,
        rope_theta=0.0,             # whisper uses learned/sinusoidal positions
    ),
    frontend="audio_frames",
    frontend_dim=80,                # mel bins delivered by the (stub) frontend
    max_seq_len=448,
    tie_embeddings=True,
    act_fn="gelu",
)
