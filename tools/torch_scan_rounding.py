#!/usr/bin/env python3
"""How far a rounding-sized difference in the scan carries through a random
rwkv6 stack of the port, in bf16, on the CPU.

The prefill is run twice on one set of random parameters: once as it is,
once with the scan's f32 output multiplied by (1 + 1e-6 * noise) before it
is rounded to bf16, which is the size of the difference between two f32
implementations of the scan (the CUDA kernel and its plain version).  It
prints the relative L2 distance of the two runs' last-token logits for each
depth and width.  The model is the smoke rwkv6-3b config at the widths
given, with 64-wide heads as in the published config.

    PYTHONPATH=src python tools/torch_scan_rounding.py [--layers 8 32] [--d-model 512 1024]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import LM
from repro_torch.models.config import SSMConfig


def _perturbed(gen):
    def scan(q, k, v, w, *, chunk, strict, h0=None, return_state=False, **_):
        y, h = ssd_ref.linear_scan_chunked(q.float(), k.float(), v.float(), w.float(), h0=h0,
                                           chunk=chunk, strict=strict)
        y = (y * (1 + 1e-6 * torch.randn(y.shape, generator=gen))).to(q.dtype)
        return (y, h) if return_state else y
    return scan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--d-model", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    plain = ssd_ops.ssd_scan
    for n_layers in args.layers:
        for d in args.d_model:
            cfg = get_smoke_config("rwkv6-3b").scaled(
                dtype="bfloat16", n_layers=n_layers, d_model=d, d_ff=2 * d,
                ssm=SSMConfig(state=64, head_dim=64, decay_lora=64))
            model = LM(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(args.seed))
            tokens = torch.randint(0, cfg.vocab, (2, args.tokens),
                                   generator=torch.Generator().manual_seed(args.seed + 1))
            logits = []
            for scan in (plain, _perturbed(torch.Generator().manual_seed(args.seed + 5))):
                ssd_ops.ssd_scan = scan
                try:
                    with torch.no_grad():
                        hid, _, _ = model.hidden_states(params, tokens)
                        logits.append(model._logits(params, hid[:, -1:]).float())
                finally:
                    ssd_ops.ssd_scan = plain
            a, b = logits
            print(f"layers {n_layers} d_model {d}: relative L2 {((a - b).norm() / a.norm()).item()}")


if __name__ == "__main__":
    main()
