"""qwen2-7b [dense] — GQA with QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    norm="rmsnorm",
    act="swiglu",
    qkv_bias=True,
    rope=True,
    rope_theta=1_000_000.0,
)
