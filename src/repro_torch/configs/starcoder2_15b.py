"""starcoder2-15b [dense] — GQA, RoPE, layernorm+bias, GeLU MLP.
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    norm_bias=True,
    act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    rope=True,
)
