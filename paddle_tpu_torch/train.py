"""The GPT training step of ``bench.py::bench_gpt``, and a CLI that runs it.

    python -m paddle_tpu_torch.train --model gpt_345m --batch 16 --seq 1024 --steps 8
    python -m paddle_tpu_torch.train --model gpt_tiny --batch 2 --seq 64 --steps 4 --device cpu

The step: ``GPTForCausalLM`` (recompute per block, dropout 0.1 on the
hidden states and the attention probabilities), AMP O2 in bf16, the
causal-LM loss in f32, the backward pass, and ``AdamW(1e-4)`` with f32
master weights and weight decay 0.01 on every parameter.  Token ids and
labels come from ``np.random.RandomState(0)``; one generator seeded with
0 draws the weights and then every dropout mask.  The CLI
prints each step's loss and time, then the median step time and
tokens per second.  It runs on ``cuda`` unless ``--device cpu`` is
given, and raises when there is no GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .amp import decorate
from .device import resolve_device
from .framework.random import make_generator
from .incubate.models import (GPTConfig, GPTForCausalLM,
                              GPTPretrainingCriterion, gpt_345m, gpt_tiny)
from .optimizer import AdamW, Optimizer

__all__ = ["TrainStep", "build_train_step", "make_batch", "main"]

CONFIGS = {"gpt_tiny": gpt_tiny, "gpt_345m": gpt_345m}


class TrainStep:
    """One optimizer step: loss of ``model`` on a batch, its gradients,
    and the optimizer's update of every parameter, in place.  The
    optimizer state lives in ``self.state``; ``generator`` feeds every
    dropout."""

    def __init__(self, model: torch.nn.Module, criterion: torch.nn.Module,
                 optimizer: Optimizer, generator: torch.Generator):
        self.model = model.train()
        self.criterion = criterion
        self.optimizer = optimizer
        self.generator = generator
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.state = optimizer.init_state_tree(self.params)

    def __call__(self, ids: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        """Run the step; returns the f32 loss (before the update)."""
        logits = self.model(ids, generator=self.generator)
        loss = self.criterion(logits, labels).float()
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        self.optimizer.apply_gradients_tree(self.params, grads, self.state)
        for p in self.params.values():
            p.grad = None
        return loss.detach()


def build_train_step(cfg: GPTConfig, *, device=None, seed: int = 0,
                     amp_o2: bool = True) -> TrainStep:
    """bench_gpt's step for ``cfg`` on ``device`` (``cuda`` unless the
    CPU is asked for): weights from ``seed``, bf16 O2 unless ``amp_o2``
    is false (f32 then), ``AdamW(1e-4, multi_precision=True)``."""
    gen = make_generator(seed, device)
    model = GPTForCausalLM(cfg, generator=gen)
    if amp_o2:
        decorate(model, level="O2", dtype="bfloat16")
    return TrainStep(model, GPTPretrainingCriterion(),
                     AdamW(learning_rate=1e-4, multi_precision=True),
                     gen)


def make_batch(cfg: GPTConfig, batch: int, seq: int, seed: int = 0,
               device=None):
    """bench_gpt's fixed batch: ids, then labels, uniform over the
    vocabulary from ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=sorted(CONFIGS), default="gpt_345m")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # bench_gpt sizes the position table to the sequence at gpt_345m
    pos = {"max_position_embeddings": args.seq} \
        if args.model == "gpt_345m" else {}
    cfg = CONFIGS[args.model](use_recompute=True, **pos)
    step = build_train_step(cfg, device=dev)
    ids, labels = make_batch(cfg, args.batch, args.seq, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{args.model} on {name}: batch {args.batch} x seq {args.seq}, "
          f"{sum(p.numel() for p in step.params.values())} parameters, "
          f"AMP O2 bf16, AdamW(1e-4), recompute", flush=True)
    times, losses = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = step(ids, labels).item()    # .item() waits for the card
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"step {i + 1} loss {loss:.6f} {times[-1] * 1e3:.2f} ms",
              flush=True)
    med = statistics.median(times[1:] if len(times) > 1 else times)
    print(json.dumps({"model": args.model, "device": name,
                      "batch": args.batch, "seq": args.seq,
                      "losses": losses, "median_step_ms": med * 1e3,
                      "tokens_per_s": args.batch * args.seq / med}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
