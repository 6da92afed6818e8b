"""Serving entry point: batched prefill + greedy decode with a KV/state
cache (counterpart of ``repro/launch/serve.py``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu [--arch ARCH]

Runs an arch's smoke configuration with weights and prompt tokens drawn
from seeded ``torch.Generator``s, on ``cuda`` unless ``--device`` says
otherwise.  Every arch serves (qwen3-1.7b is the default); a vlm batch
adds four zero vision embeddings and text positions on all three M-RoPE
rows, an encdec batch zero frame embeddings as long as the prompt, as
the reference's launcher does.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.model import build
from repro_torch.serve.serve_step import greedy_generate
from repro_torch.tree import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = build(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(42), dtype=torch.int32)
    batch = {"tokens": tokens.to(device)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((args.batch, 4, cfg.d_model), dtype=torch.bfloat16,
                                             device=device)
        batch["mrope_pos"] = torch.arange(args.prompt_len, dtype=torch.int32,
                                          device=device).expand(3, args.batch, -1)
    if cfg.family == "encdec":
        batch["enc_feats"] = torch.zeros((args.batch, args.prompt_len, cfg.d_model),
                                         dtype=torch.bfloat16, device=device)
    t0 = time.time()
    toks = greedy_generate(model, params, batch, steps=args.gen,
                           pad_to=args.prompt_len + args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"arch={cfg.name} device={device}  generated {tuple(toks.shape)} tokens in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", toks[0, :12].tolist())
    return toks


if __name__ == "__main__":
    main()
