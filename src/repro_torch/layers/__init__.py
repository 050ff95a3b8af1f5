"""Neural network layers: plain functions over dicts of tensors."""

from repro_torch.layers.attention import (
    attend,
    attend_naive,
    attention_init,
    make_mask,
    output_project,
    qkv_project,
)
from repro_torch.layers.common import (
    act_fn,
    constrain,
    dense_init,
    dtype_of,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
)
from repro_torch.layers.embedding import embed, embedding_init, logits
from repro_torch.layers.kvcache import (
    cache_positions,
    cache_validity,
    kv_cache_init,
    kv_update,
)
from repro_torch.layers.mamba import mamba, mamba_init, mamba_state_init
from repro_torch.layers.mlp import mlp, mlp_init
from repro_torch.layers.moe import moe, moe_init, route
from repro_torch.layers.rope import apply_rope
