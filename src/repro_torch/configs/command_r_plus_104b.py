"""command-r-plus-104b [dense] — GQA, no biases, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33792,
    vocab=256000,
    norm="layernorm",
    norm_bias=False,
    act="swiglu",
    rope=True,
    tie_embeddings=True,
)
