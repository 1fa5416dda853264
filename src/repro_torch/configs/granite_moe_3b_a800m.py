"""granite-moe-3b-a800m [moe] — 40 experts top-8, narrow per-expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,                       # per-expert width
    vocab=49155,
    norm="rmsnorm",
    act="swiglu",
    rope=True,
    moe=MoEConfig(n_experts=40, top_k=8, expert_ff=512),
)
