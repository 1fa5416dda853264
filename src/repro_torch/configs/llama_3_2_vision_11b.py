"""llama-3.2-vision-11b [vlm] — text backbone with gated cross-attention
image layers every 5th layer; vision frontend is a STUB (input_specs supplies
precomputed patch embeddings projected to d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    norm="rmsnorm",
    act="swiglu",
    rope=True,
    rope_theta=500_000.0,
    xattn_every=5,
    n_img_tokens=4096,
)
