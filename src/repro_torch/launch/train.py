"""End-to-end training driver (counterpart of ``repro/launch/train.py``,
plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu [--arch ARCH]

Trains any ``--arch`` (its smoke configuration by default, ``--full`` for
the published one, scaled with ``--layers``/``--d-model``) with AdamW,
microbatching, checkpoints and auto-resume, on ``cuda`` unless
``--device`` says otherwise (without a card it raises).  Parameters come
from ``torch.Generator(0)``, the optimizer state starts at zeros.

Fault tolerance: ``--fail-at-step N`` exits with code 17 after step N;
running again with the same ``--ckpt-dir`` resumes from the newest valid
checkpoint (atomic writes and checksums, ``train/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import torch

from repro_torch import tree as T
from repro_torch.common import init_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.model import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, batch_at
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step, state_specs
from repro_torch.tree import resolve_device


def extras_for(cfg, batch, seq, device=None):
    """The family's extra inputs, as the reference's launcher makes them:
    zero vision embeddings and text positions on all three M-RoPE rows
    (vlm), zero frame embeddings as long as the sequence (encdec)."""
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.zeros((batch, min(cfg.n_vision_tokens, seq // 2),
                                            cfg.d_model), dtype=torch.bfloat16, device=device)
        out["mrope_pos"] = torch.arange(seq, dtype=torch.int32, device=device).expand(
            3, batch, seq).contiguous()
    if cfg.family == "encdec":
        out["enc_feats"] = torch.zeros((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                                       device=device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=0, help="failure injection")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
    if over:
        cfg = dataclasses.replace(cfg, **over)
    model = build(cfg)
    oc = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                   moments_dtype=cfg.moments_dtype)
    sspecs = state_specs(model, oc)
    n_params = sum(math.prod(s.shape) for _, s in T.leaves(model.specs))
    print(f"arch={cfg.name}  params={n_params / 1e6:.1f}M  steps={args.steps}  "
          f"batch={args.batch}x{args.seq}  device={device}")

    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, start_step = ckpt.restore(args.ckpt_dir, sspecs, device=device)
        print(f"resumed from checkpoint step {start_step}")
    else:
        state = {"params": model.init(torch.Generator(device).manual_seed(0), device),
                 "opt": init_params(sspecs["opt"], torch.Generator(device).manual_seed(1),
                                    device)}

    step_fn = make_train_step(model, oc, accum_steps=args.accum)
    dc = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=7)
    ex = extras_for(cfg, args.batch, args.seq, device)
    t0 = time.time()
    metrics = None
    for step in range(start_step, args.steps):
        batch = {**{k: v.to(device) for k, v in batch_at(dc, step).items()}, **ex}
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            tput = args.batch * args.seq * (step + 1 - start_step) / max(time.time() - t0, 1e-9)
            print(f"step {step + 1:5d}  loss {loss:7.4f}  grad_norm "
                  f"{float(metrics['grad_norm']):8.3f}  tok/s {tput:9.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state)
        if args.fail_at_step and step + 1 == args.fail_at_step:
            print(f"INJECTED FAILURE at step {step + 1} (resume with the same --ckpt-dir)")
            sys.exit(17)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
    print("training complete")
    return None if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
