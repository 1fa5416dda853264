"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent per-channel decay.
[arXiv:2404.05892; hf]"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    norm="layernorm",
    norm_bias=True,
    act="gelu",                 # unused by rwkv blocks (channel-mix is fixed)
    rope=False,
    ssm=SSMConfig(state=64, head_dim=64, decay_lora=64),
)
