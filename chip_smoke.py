#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line is printed:

 1. card     the card's name and power limit (nvidia-smi); TF32 off.
 2. build    every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
             with nvcc for sm_90a; build seconds and ptxas' report.
 3. kernels  each kernel against its plain PyTorch version on the card at
             the serve shapes of ``gpt_345m`` (hidden 1024, 16 heads of
             64, page size 16, 128 pages per sequence): max abs error
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

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``.  Exits non-zero when no CUDA device
is present, and when run without the ``paddle_tpu_torch`` package beside
it.
"""
from __future__ import annotations

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

REPLACES = {
    "paged_attention": "paddle_tpu/ops/paged_attention.py:144",
    "paged_attention_int8": "paddle_tpu/ops/paged_attention.py:303",
    "w8a16_matmul": "paddle_tpu/ops/quant_kernels.py:132",
}
SOURCES = {
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_int8": "paddle_tpu_torch/csrc/paged_attention.cu",
    "w8a16_matmul": "paddle_tpu_torch/csrc/w8a16.cu",
}


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
    return results


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
    for name, n in launches.items():
        if n == 0:
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
