#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line is printed:

 1. card     the card's name and power limit (nvidia-smi); TF32 off.
 2. build    every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
             with nvcc for sm_90a; build seconds and ptxas' report.
 3. kernels  each kernel against its plain PyTorch version on the card at
             the shapes of its path at ``gpt_345m`` width (serving: 16
             heads of 64, page size 16, 128 pages per sequence; training:
             LayerNorm over 4096 rows of 1024): max abs error
             against the stated tolerance, times with CUDA events (median
             of 30 after warm-up, L2 flushed before each launch), and the
             least time the card could take (bytes over 3.35 TB/s or
             operations over the peak for their type).
 4. model    prefill + decode logits on the card against the same steps
             on the CPU, at a small width, fp32 and int8.
 5. serve    ``ServingEngine`` on cuda at the gpt_345m widths (24 layers,
             random weights from seed 0) at fp32, bf16 and int8: 32
             prompts of 16..500 tokens, 32 new tokens each; every kernel
             counter is set to 0 just before ``generate`` and read just
             after; the join/leave contract (solo == inside the batch).
 6. http     one ``/v1/generate`` and one ``/healthz`` over the fp32 engine.
 7. train    the training step of ``bench.py::bench_gpt`` on the card:
             first a small width (gpt_tiny, f32, dropout 0) against the
             same weights' 3-step loss trajectory on the CPU; then
             attention at S = 512 must raise (the flash kernels' range,
             not ported yet); then gpt_345m at full width and depth
             (batch 16 x seq 256, AMP O2 bf16, AdamW with f32 masters,
             recompute, dropout 0.1) for 8 steps on a fixed batch, the
             kernel counters set to 0 just before and read just after:
             every loss finite, the last below the first, the LayerNorm
             launches per step as the model's structure implies.

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``.  Exits non-zero when no CUDA device
is present, and when run without the ``paddle_tpu_torch`` package beside
it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores, dense
TIMED_ITERS = 30
GPT_345M = dict(vocab_size=50304, hidden=1024, layers=24, heads=16,
                max_seq_len=2048, ffn_mult=4)
PAGE_SIZE = 16
TOL = {"f32": 2e-5, "int8": 2e-5, "bf16": 2e-2}
MODEL_TOL = {"fp32": 1e-4, "int8": 1e-2}

LN_TOL = {"f32": dict(abs=1e-5, rel_dw_db=1e-4),
          "bf16": dict(abs=2e-2, rel=2e-2)}   # |err| <= abs + rel * |ref|
TRAIN_TOL = 1e-4                            # card vs CPU loss, f32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 256, 8

REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:144",
    "paged_attention_int8": "paddle_tpu/ops/paged_attention.py:303",
    "w8a16_matmul": "paddle_tpu/ops/quant_kernels.py:132",
    "layer_norm_fwd": "paddle_tpu/ops/fused_kernels.py:198",
    "layer_norm_bwd": "paddle_tpu/ops/fused_kernels.py:245",
}
SOURCES = {
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_int8": "paddle_tpu_torch/csrc/paged_attention.cu",
    "w8a16_matmul": "paddle_tpu_torch/csrc/w8a16.cu",
    "layer_norm_fwd": "paddle_tpu_torch/csrc/layer_norm.cu",
    "layer_norm_bwd": "paddle_tpu_torch/csrc/layer_norm.cu",
}
SERVE_KERNELS = ("paged_attention", "paged_attention_int8", "w8a16_matmul")
TRAIN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd")


def log(*args):
    print(*args, flush=True)


# -- timing ------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events.

    Before each timed call the L2 cache is flushed (a 256 MB write) and
    the stream is held busy by a spin kernel, so the host has enqueued
    the call before the start event fires: the pair measures the device
    work, not the host's launch overhead.
    """

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn, iters=TIMED_ITERS, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("[card]", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "| cuda", torch.version.cuda, "| devices", torch.cuda.device_count())
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] TF32 off for matmul and cuDNN")
    return smi


def phase_build():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build(_build.SOURCES, verbose=True)
    secs = time.perf_counter() - t0
    for name, (path, out) in built.items():
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log(f"[build] {name}: {path.name}")
        for ln in lines:
            log("   ", ln)
    log(f"[build] {len(built)} libraries in {secs:.2f} s")


def _paged_inputs(gen, kv_dtype):
    """Serve shapes: B = 16 rows, H = 16, D = 64, ps = 16, 128 pages per
    row, ragged lengths from 1 to 2048 with an exact page and partly
    filled last pages; every row's table has dead pages."""
    from paddle_tpu_torch.ops.quant_kernels import quantize_kv
    b, h, d, ps, maxp = 16, 16, 64, PAGE_SIZE, 128
    n_pages = 1 + b * maxp
    lengths = torch.tensor([1, 16, 17, 100, 255, 256, 511, 700, 1000, 1023,
                            1024, 1500, 1777, 2000, 2047, 2048],
                           dtype=torch.int32, device=DEVICE)
    perm = torch.randperm(n_pages - 1, generator=gen, device=DEVICE) + 1
    tables = perm.reshape(b, maxp).to(torch.int32).contiguous()
    qdt = torch.bfloat16 if kv_dtype == torch.bfloat16 else torch.float32
    q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(qdt)
    k = torch.randn(n_pages, ps, h, d, generator=gen, device=DEVICE)
    v = torch.randn(n_pages, ps, h, d, generator=gen, device=DEVICE)
    if kv_dtype == torch.int8:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return q, kq, vq, ks, vs, tables, lengths
    return q, k.to(kv_dtype), v.to(kv_dtype), None, None, tables, lengths


def _paged_bytes_flops(q, k, ks, tables, lengths):
    b, h, d = q.shape
    ps = k.shape[1]
    live = lengths.long().sum().item()
    live_pages = ((lengths.long() + ps - 1) // ps).sum().item()
    nbytes = (2 * q.numel() * q.element_size()        # q in, out
              + 2 * live * h * d * k.element_size()   # live K and V
              + 4 * live_pages + 4 * b)               # page ids, lengths
    if ks is not None:
        nbytes += 2 * live * h * 4                    # live K/V scales
    return nbytes, 4.0 * live * h * d


def phase_kernels(timer):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_int8, paged_attention_int8_reference,
        paged_attention_reference)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}

    for tag, kv_dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                          ("int8", torch.int8)):
        q, k, v, ks, vs, pt, ln = _paged_inputs(gen, kv_dtype)
        if ks is None:
            name = "paged_attention"
            run = lambda: paged_attention(q, k, v, pt, ln)  # noqa: E731
            ref = lambda: paged_attention_reference(q, k, v, pt, ln)  # noqa: E731
        else:
            name = "paged_attention_int8"
            run = lambda: paged_attention_int8(q, k, v, ks, vs, pt, ln)  # noqa: E731
            ref = lambda: paged_attention_int8_reference(  # noqa: E731
                q, k, v, ks, vs, pt, ln)
        out, want = run(), ref()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and err <= TOL[tag]
        nbytes, flops = _paged_bytes_flops(q, k, ks, pt, ln)
        t_bound, by = bound_ms(nbytes, flops, torch.float32)
        ms, plain = timer(run), timer(ref)
        log(f"[kernel] {name}[{tag}] B=16 H=16 D=64 ps=16 lengths 1..2048: "
            f"max_abs_err {err:.3e} (tol {TOL[tag]:.0e}) kernel {ms:.4f} ms "
            f"plain {plain:.4f} ms bound {t_bound:.4f} ms ({by}); no single "
            f"PyTorch call computes paged attention")
        if not ok:
            raise AssertionError(f"{name}[{tag}] disagrees with its plain "
                                 f"version: {err} > {TOL[tag]}")
        results.setdefault(name, []).append(dict(
            variant=tag, max_abs_err=err, tol=TOL[tag], ms=ms, plain_ms=plain,
            bound_ms=t_bound, bound_by=by, library_ms=None))

    hid, ffn = GPT_345M["hidden"], GPT_345M["hidden"] * 4
    # one layer's six products: q, k, v, o, then the MLP's w1 and w2
    layer = [(hid, hid)] * 4 + [(hid, ffn), (ffn, hid)]
    rows = results["w8a16_matmul"] = []
    for m in (16, 512):
        ops = [_w8a16_operands(gen, m, kk, nn, torch.float32)
               for kk, nn in layer]
        rows.append(_w8a16_entry(timer, ops, f"one layer's 6 products at "
                                 f"M={m}, timed as one call", TOL["f32"]))
        for i in (0, 4, 5):   # each shape alone
            kk, nn = layer[i]
            rows.append(_w8a16_entry(timer, ops[i:i + 1],
                                     f"M={m} K={kk} N={nn}", TOL["f32"]))
    for kk, nn in layer[3:]:  # bf16 activations, at decode
        ops = [_w8a16_operands(gen, 16, kk, nn, torch.bfloat16)]
        rows.append(_w8a16_entry(timer, ops, f"bf16 x, M=16 K={kk} N={nn}",
                                 TOL["bf16"]))

    # the training step's LayerNorm: batch 16 x seq 256 rows of hidden
    # 1024, bf16 under O2 (the main path) and f32
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd, bwd = _layer_norm_entries(timer, gen, tag, dtype)
        results.setdefault("layer_norm_fwd", []).append(fwd)
        results.setdefault("layer_norm_bwd", []).append(bwd)
    return results


def _ln_err(out, want, tag, rel_to_max=False):
    """Max abs error and whether it is within the tolerance: bf16
    ``abs + rel * |ref|`` per element; f32 abs, or relative to the
    largest |ref| for the row sums dw and db."""
    err = (out.float() - want.float()).abs()
    finite = bool(torch.isfinite(out.float()).all())
    if tag == "bf16":
        t = LN_TOL["bf16"]
        ok = bool((err <= t["abs"] + t["rel"] * want.float().abs()).all())
    elif rel_to_max:
        ok = err.max().item() <= (LN_TOL["f32"]["rel_dw_db"]
                                  * want.float().abs().max().item())
    else:
        ok = err.max().item() <= LN_TOL["f32"]["abs"]
    return err.max().item(), finite and ok


def _layer_norm_entries(timer, gen, tag, dtype):
    """The LayerNorm kernels against their plain versions at (4096, 1024):
    errors on y, dx, dw and db, dw and db bit-identical over two runs,
    and the kernel, plain and library times."""
    from paddle_tpu_torch.ops.fused_kernels import (
        layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_fwd_reference)
    rows, d, eps = TRAIN_BATCH * TRAIN_SEQ, GPT_345M["hidden"], 1e-5
    x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 2 + 0.5
         ).to(dtype)
    w = (1 + 0.3 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    b = (0.2 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
    y, mean, rstd = layer_norm_fwd(x, w, b, eps)
    y_ref, mean_ref, rstd_ref = layer_norm_fwd_reference(x, w, b, eps)
    grads = layer_norm_bwd(g, x, w, mean, rstd)
    again = layer_norm_bwd(g, x, w, mean, rstd)
    grads_ref = layer_norm_bwd_reference(g, x, w, mean, rstd)
    torch.cuda.synchronize()
    errs = {"y": _ln_err(y, y_ref, tag), "mean": _ln_err(mean, mean_ref, tag),
            "rstd": _ln_err(rstd, rstd_ref, tag),
            "dx": _ln_err(grads[0], grads_ref[0], tag),
            "dw": _ln_err(grads[1], grads_ref[1], tag, rel_to_max=True),
            "db": _ln_err(grads[2], grads_ref[2], tag, rel_to_max=True)}
    same_bits = torch.equal(grads[1], again[1]) and torch.equal(grads[2],
                                                                again[2])
    es = x.element_size()
    fwd_bytes = 2 * rows * d * es + 2 * d * es + 2 * rows * 4
    bwd_bytes = 3 * rows * d * es + 3 * d * es + 2 * rows * 4
    fwd_bound = bound_ms(fwd_bytes, 8.0 * rows * d, torch.float32)
    bwd_bound = bound_ms(bwd_bytes, 12.0 * rows * d, torch.float32)
    lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(x, [d], w, b,
                                                          eps)[1:]
    times = {
        "fwd": timer(lambda: layer_norm_fwd(x, w, b, eps)),
        "fwd_plain": timer(lambda: layer_norm_fwd_reference(x, w, b, eps)),
        "fwd_lib": timer(lambda: torch.nn.functional.layer_norm(
            x, (d,), w, b, eps)),
        "bwd": timer(lambda: layer_norm_bwd(g, x, w, mean, rstd)),
        "bwd_plain": timer(lambda: layer_norm_bwd_reference(g, x, w, mean,
                                                            rstd)),
        "bwd_lib": timer(lambda: torch.ops.aten.native_layer_norm_backward(
            g, x, [d], lib_mean, lib_rstd, w, b, [True, True, True])),
    }
    tol = LN_TOL[tag]
    log(f"[kernel] layer_norm[{tag}] ({rows}, {d}): max_abs_err "
        + " ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (tol {tol}); dw/db bit-identical over two runs: {same_bits}; "
        f"fwd kernel {times['fwd']:.4f} ms plain {times['fwd_plain']:.4f} "
        f"library(F.layer_norm) {times['fwd_lib']:.4f} bound "
        f"{fwd_bound[0]:.4f} ({fwd_bound[1]}); bwd kernel {times['bwd']:.4f} "
        f"ms plain {times['bwd_plain']:.4f} library(native_layer_norm_"
        f"backward) {times['bwd_lib']:.4f} bound {bwd_bound[0]:.4f} "
        f"({bwd_bound[1]})")
    bad = [k for k, (_, ok) in errs.items() if not ok]
    if bad or not same_bits:
        raise AssertionError(f"layer_norm[{tag}] disagrees with its plain "
                             f"version on {bad}, or dw/db differ between "
                             f"runs (bit-identical: {same_bits})")
    fwd = dict(variant=tag, max_abs_err=errs["y"][0],
               errors={k: errs[k][0] for k in ("y", "mean", "rstd")},
               tol=tol, ms=times["fwd"], plain_ms=times["fwd_plain"],
               bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
               library_ms=times["fwd_lib"])
    bwd = dict(variant=tag, max_abs_err=max(errs[k][0] for k in
                                            ("dx", "dw", "db")),
               errors={k: errs[k][0] for k in ("dx", "dw", "db")},
               bit_identical=same_bits, tol=tol, ms=times["bwd"],
               plain_ms=times["bwd_plain"], bound_ms=bwd_bound[0],
               bound_by=bwd_bound[1], library_ms=times["bwd_lib"])
    return fwd, bwd


def _w8a16_operands(gen, m, k, n, x_dtype):
    """x (M, K), an int8 (K, N) weight with its (N,) scale, and the
    weight dequantized ahead for the library call.  bf16 x is scaled to
    keep |out| < 4, where a bf16 step is at most 2^-6 < its tolerance."""
    from paddle_tpu_torch.ops.quant_kernels import quantize_weight
    x = torch.randn(m, k, generator=gen, device=DEVICE)
    if x_dtype == torch.bfloat16:
        x = (x * 0.25).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=DEVICE) * 0.02
    wq, sc = quantize_weight(w, axis=1)
    return x, wq, sc, (wq.float() * sc).to(x_dtype)


def _w8a16_entry(timer, ops, variant, tol):
    """Check the kernel against its plain version on every product of
    ``ops`` and time the products as one call: the kernel, the plain
    version, and the library call (matmul on the dequantized weight)."""
    from paddle_tpu_torch.ops.quant_kernels import (w8a16_matmul,
                                                    w8a16_matmul_reference)

    def run(fn):
        return [fn(x, wq, sc) for x, wq, sc, _ in ops]

    outs, wants = run(w8a16_matmul), run(w8a16_matmul_reference)
    torch.cuda.synchronize()
    err = max((o.float() - w.float()).abs().max().item()
              for o, w in zip(outs, wants))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    nbytes = sum(x.numel() * x.element_size() + wq.numel() + sc.numel() * 4
                 + x.shape[0] * wq.shape[1] * x.element_size()
                 for x, wq, sc, _ in ops)
    flops = sum(2.0 * x.shape[0] * x.shape[1] * wq.shape[1]
                for x, wq, _, _ in ops)
    t_bound, by = bound_ms(nbytes, flops, torch.float32)
    ms = timer(lambda: run(w8a16_matmul))
    plain = timer(lambda: run(w8a16_matmul_reference))
    lib = timer(lambda: [torch.matmul(x, wd) for x, _, _, wd in ops])
    log(f"[kernel] w8a16_matmul {variant}: max_abs_err {err:.3e} (tol "
        f"{tol:.0e}) kernel {ms:.4f} ms plain {plain:.4f} ms library(matmul "
        f"on the dequantized weight) {lib:.4f} ms bound {t_bound:.4f} ms "
        f"({by})")
    if not (finite and err <= tol):
        raise AssertionError(f"w8a16_matmul {variant} disagrees with its "
                             f"plain version: {err} > {tol}")
    return dict(variant=variant, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain, bound_ms=t_bound, bound_by=by, library_ms=lib)


def phase_model():
    """The step functions on the card (kernels) against the same steps on
    the CPU (plain versions), at a small width, from the same weights."""
    from paddle_tpu_torch.serving import model as M
    from paddle_tpu_torch.serving.quant import quantize_params
    spec = M.ModelSpec(vocab_size=512, hidden=256, layers=2, heads=4,
                       max_seq_len=256)
    ps, pages = PAGE_SIZE, 1 + 4 * 16
    cpu_params = M.init_params(spec, seed=1, device="cpu")
    rng = np.random.RandomState(1)
    lens = [5, 16, 33, 100]
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, pages))[:4 * 16].reshape(4, 16)
        .astype(np.int32))
    for prec in ("fp32", "int8"):
        params = (quantize_params(cpu_params, spec) if prec == "int8"
                  else cpu_params)
        logits = {}
        for dev in ("cpu", DEVICE):
            p = {k: v.to(dev) for k, v in params.items()}
            kv_dtype = torch.int8 if prec == "int8" else torch.float32
            shape = (spec.layers, pages * ps, spec.heads, spec.head_dim)
            kf = torch.zeros(shape, dtype=kv_dtype, device=dev)
            vf = torch.zeros(shape, dtype=kv_dtype, device=dev)
            kw = ({"k_scale": torch.zeros(shape[:3], device=dev),
                   "v_scale": torch.zeros(shape[:3], device=dev)}
                  if prec == "int8" else {})
            outs = []
            for row, n in enumerate(lens):
                toks = torch.from_numpy(
                    rng_tokens(row, 128, spec.vocab_size)).to(dev)
                *_, lg = M.prefill_step(spec, p, kf, vf, toks, n,
                                        tables[row].to(dev), page_size=ps,
                                        **kw)
                outs.append(lg)
            pos = torch.tensor(lens, dtype=torch.int32, device=dev)
            toks = torch.tensor([3, 7, 11, 13], dtype=torch.int32, device=dev)
            *_, lg = M.decode_step(spec, p, kf, vf, toks, pos, tables.to(dev),
                                   page_size=ps, **kw)
            outs.append(lg.reshape(-1))
            logits[dev] = torch.cat([o.reshape(-1).float().cpu()
                                     for o in outs])
        err = (logits["cpu"] - logits[DEVICE]).abs().max().item()
        log(f"[model] {prec}: prefill+decode logits, card vs CPU, max_abs_err "
            f"{err:.3e} (tol {MODEL_TOL[prec]:.0e})")
        if not (math.isfinite(err) and err <= MODEL_TOL[prec]):
            raise AssertionError(f"model {prec}: card and CPU disagree: {err}")


def rng_tokens(seed, n, vocab):
    return np.random.RandomState(100 + seed).randint(1, vocab, size=n) \
        .astype(np.int32)


def _serve_prompts(vocab):
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 501, size=32)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


def phase_serve(smi):
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine, init_params)
    spec = ModelSpec(**GPT_345M)
    prompts = _serve_prompts(spec.vocab_size)
    launches = {name: 0 for name in KERNELS}
    params = init_params(spec, seed=0, device=DEVICE)
    fp32_engine = None
    for prec in ("fp32", "bf16", "int8"):
        cfg = ServeConfig(decode_buckets=(2, 4, 8, 16),
                          prefill_buckets=(64, 128, 256, 512),
                          kv_pages=1024, page_size=PAGE_SIZE,
                          max_inflight=64, max_new_tokens=32,
                          precision=prec)
        t0 = time.perf_counter()
        engine = ServingEngine(spec, params, cfg, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sched = engine.scheduler
        sched._step_times.clear()
        steps0 = sched.stats["steps"]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in KERNELS.items()}
        steps = sched.stats["steps"] - steps0
        step_times = list(sched._step_times)
        if len(outs) != 32 or any(
                len(o) != 32 or not all(0 <= t < spec.vocab_size for t in o)
                for o in outs):
            raise AssertionError(f"serve {prec}: malformed output")
        want = ["paged_attention_int8", "w8a16_matmul"] if prec == "int8" \
            else ["paged_attention"]
        for name in want:
            if counts[name] < spec.layers * steps:
                raise AssertionError(
                    f"serve {prec}: {name} launched {counts[name]} times, "
                    f"fewer than layers x decode steps = {spec.layers * steps}")
        for name in KERNELS:
            launches[name] += counts[name]
        decode_tokens = sum(len(o) - 1 for o in outs)
        log(f"[serve] {prec}: 32 requests x 32 tokens, {steps} decode steps, "
            f"decode {decode_tokens / sum(step_times):.1f} tok/s, median step "
            f"{statistics.median(step_times) * 1e3:.2f} ms, generate wall "
            f"{wall:.2f} s, engine build+warm-up {build_s:.2f} s, launches "
            f"{counts} | {smi}")

        # join/leave: prompts decoded alone (bucket 2) give the tokens
        # they got inside the batch (bucket 16)
        solo = [engine.generate([p], max_new_tokens=32)[0]
                for p in prompts[:4]]
        if solo == outs[:4]:
            log(f"[serve] {prec}: join/leave holds across buckets "
                f"(4 solo == in batch)")
        else:
            log(f"[serve] {prec}: join/leave FAILS across buckets 2 and 16; "
                f"checking within one bucket")
            one = ServingEngine(spec, params, cfg.replace(decode_buckets=(16,)),
                                device=DEVICE)
            batched = one.generate(prompts, max_new_tokens=32)
            solo = [one.generate([p], max_new_tokens=32)[0]
                    for p in prompts[:4]]
            one.close()
            del one
            if solo != batched[:4]:
                raise AssertionError(f"serve {prec}: join/leave fails even "
                                     f"within one bucket")
            log(f"[serve] {prec}: join/leave holds within bucket 16 only")
        if prec == "fp32":
            fp32_engine = engine
        else:
            engine.close()
            del engine
            torch.cuda.empty_cache()
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"serve path")
    return fp32_engine, launches, prompts


def phase_http(engine, prompt):
    from paddle_tpu_torch.serving.http import ServeHTTPServer
    srv = ServeHTTPServer(engine, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"tokens": prompt, "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body = r.status, json.loads(r.read())
        if status != 200 or len(body["tokens"]) != 8:
            raise AssertionError(f"/v1/generate: {status} {body}")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or not health["ok"]:
            raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"[http] /v1/generate 200 with 8 tokens in "
            f"{body['latency_ms']:.1f} ms; /healthz ok")
    finally:
        srv.stop()
        engine.close()


def phase_train(smi):
    """The training path on the card: card against CPU at a small width,
    the S = 512 refusal, then 8 steps of gpt_345m (the main path)."""
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import (GPTForCausalLM, gpt_345m,
                                                  gpt_tiny)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import KERNELS, reset_launch_counts
    from paddle_tpu_torch.train import build_train_step, make_batch

    # same weights, f32, dropout 0: the 3-step loss trajectory
    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   use_recompute=True)
    steps = {dev: build_train_step(cfg, device=dev, seed=1, amp_o2=False)
             for dev in ("cpu", DEVICE)}
    steps[DEVICE].model.load_state_dict(steps["cpu"].model.state_dict())
    ids, labels = make_batch(cfg, 4, 64, seed=1, device="cpu")
    traj = {dev: [st(ids.to(dev), labels.to(dev)).item() for _ in range(3)]
            for dev, st in steps.items()}
    err = max(abs(a - b) for a, b in zip(traj["cpu"], traj[DEVICE]))
    log(f"[train] gpt_tiny f32 3-step loss, card {traj[DEVICE]} vs CPU "
        f"{traj['cpu']}: max diff {err:.3e} (tol {TRAIN_TOL:.0e})")
    if not err <= TRAIN_TOL:
        raise AssertionError(f"train: card and CPU trajectories differ by "
                             f"{err}")
    del steps

    # attention at the flash kernels' lengths raises on the card
    long_cfg = dataclasses.replace(gpt_tiny(),
                                   max_position_embeddings=F.FLASH_MIN_SEQ)
    model = GPTForCausalLM(long_cfg, generator=make_generator(0, DEVICE))
    ids, _ = make_batch(long_cfg, 1, F.FLASH_MIN_SEQ, device=DEVICE)
    try:
        model(ids, generator=make_generator(0, DEVICE))
    except NotImplementedError as e:
        log(f"[train] S={F.FLASH_MIN_SEQ} on the card raises: {e}")
    else:
        raise AssertionError(f"train: attention ran at S="
                             f"{F.FLASH_MIN_SEQ} on the card")
    del model

    # the main path: gpt_345m, batch 16 x seq 256, O2 bf16, recompute
    cfg = gpt_345m(use_recompute=True, max_position_embeddings=TRAIN_SEQ)
    t0 = time.perf_counter()
    step = build_train_step(cfg, device=DEVICE, seed=0)
    ids, labels = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                             device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in step.params.values())
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())   # waits for the card
        times.append(time.perf_counter() - t0)
    launches = {name: KERNELS[name].launches for name in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    layers = cfg.num_layers
    # per step: 2 per block and the final one, the blocks' 2 again in the
    # backward pass's recompute; one backward each
    want = {"layer_norm_fwd": TRAIN_STEPS * (4 * layers + 1),
            "layer_norm_bwd": TRAIN_STEPS * (2 * layers + 1)}
    log(f"[train] gpt_345m ({n_params} parameters) batch {TRAIN_BATCH} x "
        f"seq {TRAIN_SEQ}, O2 bf16, AdamW, recompute: losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(t * 1e3, 2) for t in times]}; median step (2..{TRAIN_STEPS}) "
        f"{med * 1e3:.2f} ms, {tokens / med:.1f} tokens/s; first step "
        f"{times[0] * 1e3:.1f} ms; build {build_s:.2f} s; peak memory "
        f"{peak_gb:.2f} GB; launches {launches} | {smi}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss not finite and falling: {losses}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times in {TRAIN_STEPS} steps, want {n}")
    _profile_train_step(step, ids, labels, med, smi)
    del step
    torch.cuda.empty_cache()
    return launches


def _profile_train_step(step, ids, labels, step_s, smi, steps=2):
    """Where a gpt_345m step's time goes: device time summed over the
    step's kernels under ``torch.profiler``, its share of the median
    step wall time, device operations per step, the largest kernels, and
    the LayerNorm kernels' share."""
    from paddle_tpu_torch.serving.profile import _device_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(ids, labels).item()
    torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("train: the profiler recorded no device time")
    busy_ms = sum(_device_us(e) for e in kernels) / steps / 1e3
    ops = sum(e.count for e in kernels) / steps
    ln = [e for e in kernels if "ln_fwd_kernel" in e.key
          or "ln_bwd_kernel" in e.key or "ln_bwd_reduce_kernel" in e.key]
    ln_ms = sum(_device_us(e) for e in ln) / steps / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:8] + ln
    log(f"[train] profile of {steps} gpt_345m steps: device busy "
        f"{busy_ms:.3f} ms per step, {busy_ms / (step_s * 1e3):.3f} of the "
        f"median step wall {step_s * 1e3:.2f} ms; {ops:.0f} device ops per "
        f"step; LayerNorm kernels {ln_ms:.3f} ms per step | {smi}")
    for e in top:
        log(f"    {_device_us(e) / steps / 1e3:8.3f} ms {e.count / steps:6.0f}"
            f" calls  {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    timer = Timer()
    results = phase_kernels(timer)
    del timer
    phase_model()
    engine, launches, prompts = phase_serve(smi)
    phase_http(engine, prompts[0][:64])
    del engine
    torch.cuda.empty_cache()
    train_launches = phase_train(smi)
    for name in TRAIN_KERNELS:
        launches[name] = train_launches[name]
    kernels = []
    for name, rows in results.items():
        top = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": top["max_abs_err"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "measured_at": top["variant"],
            "variants": rows,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
