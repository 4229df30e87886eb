"""Where a decode step's time goes on the card.

    python -m paddle_tpu_torch.serving.profile

Builds a ``ServingEngine`` at the ``gpt_345m`` widths (24 layers, random
weights, seed 0) at fp32, bf16 and int8, prefills 16 sequences of 512
tokens, then runs 8 decode steps twice each way, in one process: on the
engine's CUDA graph of the bucket (its replay), and eagerly (the same
step uncaptured): once timed by the host clock (each step ends in
copying the next tokens to the host, as the engine's steps do), once
under ``torch.profiler``.  Prints, per precision and way, the median
step wall time, the device time summed over the step's kernels, their
ratio (the device's busy share; the rest is idle, waiting on the host),
the number of device operations (kernels and copies) per step, and the
kernels that take the most device time.  Needs a CUDA device; there is
no CPU mode.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..device import resolve_device
from ..jit import capture_enabled
from ..ops.paged_attention import KERNEL_NAMES as PAGED_KERNELS
from .engine import ServeConfig, ServingEngine
from .model import ModelSpec, init_params

GPT_345M = dict(vocab_size=50304, hidden=1024, layers=24, heads=16,
                max_seq_len=2048, ffn_mult=4)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _profile_steps(step, steps, device):
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
    torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_us = sum(_device_us(e) for e in kernels) / steps
    paged_us = sum(_device_us(e) for e in kernels
                   if any(n in e.key for n in PAGED_KERNELS)) / steps
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=_device_us, reverse=True)[:6]
    wall_ms = statistics.median(walls) * 1e3
    return {
        "step_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_ops_per_step": launches,
        "paged_attention_device_ms": paged_us / 1e3,
        "top_kernels": [{"name": e.key[:80],
                         "device_ms_per_step": _device_us(e) / steps / 1e3,
                         "calls_per_step": e.count / steps} for e in top],
    }


def profile_precision(spec, params, precision, rows, context, steps, device):
    ps = 16
    cfg = ServeConfig(decode_buckets=(rows,), prefill_buckets=(context,),
                      kv_pages=1 + rows * (-(-(context + 4 * steps + 1) // ps)),
                      page_size=ps, max_inflight=rows, precision=precision)
    if not capture_enabled():
        raise RuntimeError("PT_CAPTURE=0: the engine would capture no graph")
    eng = ServingEngine(spec, params, cfg, device=device)
    rng = np.random.RandomState(0)
    need = eng.pool.pages_needed(context + 4 * steps + 1)
    tables = np.stack([eng.pool.null_padded_table(eng.pool.alloc(need),
                                                  eng.max_pages_per_seq)
                       for _ in range(rows)])
    tokens = np.asarray([eng.prefill(rng.randint(1, spec.vocab_size,
                                                 size=context).tolist(), t)
                         for t in tables], np.int32)
    pos = np.full((rows,), context, np.int32)

    def graph_step():
        nonlocal tokens, pos
        tokens = eng.decode(tokens, pos, tables)  # ends in a device sync
        pos = pos + 1

    def eager_step():
        # the bucket's step uncaptured, on the engine's tensors; rows fill
        # the bucket, so nothing is padded
        nonlocal tokens, pos
        tokens = eng._decode_on({
            "tokens": eng._tensor(tokens), "positions": eng._tensor(pos),
            "page_tables": eng._tensor(tables)}).cpu().numpy()
        pos = pos + 1

    out = {"precision": precision, "rows": rows, "context": context,
           "layers": spec.layers}
    for way, step in (("graph", graph_step), ("eager", eager_step)):
        out[way] = _profile_steps(step, steps, device)
    eng.close()
    return out


def main():
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = ModelSpec(**GPT_345M)
    params = init_params(spec, seed=0, device=device)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for prec in ("fp32", "bf16", "int8"):
        print(json.dumps(profile_precision(spec, params, prec, rows=16,
                                           context=512, steps=8,
                                           device=device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
