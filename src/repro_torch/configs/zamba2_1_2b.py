"""zamba2-1.2b [hybrid] — Mamba-2 backbone with a single shared attention
block applied every 6th layer.  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,          # shared block is MHA
    d_head=64,
    d_ff=8192,              # shared block MLP width
    vocab=32000,
    norm="rmsnorm",
    act="swiglu",
    rope=True,
    ssm=SSMConfig(state=64, head_dim=64, conv=4),
    shared_attn_every=6,
)
