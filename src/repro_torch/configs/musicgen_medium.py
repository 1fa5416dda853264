"""musicgen-medium [audio] — decoder-only over 4 EnCodec codebooks; the
EnCodec frontend is a STUB (input_specs supplies token streams with the delay
pattern already applied).  [arXiv:2306.05284; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,          # MHA
    d_head=64,
    d_ff=6144,
    vocab=2048,
    norm="layernorm",
    norm_bias=True,
    act="gelu",
    mlp_bias=True,
    rope=False,             # sinusoidal absolute positions
    n_codebooks=4,
    max_seq=32768,
)
