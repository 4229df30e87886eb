"""int8 calibration, weight quantization and the quantized served-model
directory.

The counterpart of ``paddle_tpu/serving/quant.py``, in three moves:

 1. **Calibrate**: :func:`calibrate` replays a prefill/decode trace
    eagerly through the same :mod:`.model` step functions the engine
    captures, their ``tap`` hook feeding the observers of
    :mod:`..quantization.observers`: a
    :class:`~..quantization.observers.PerChannelAbsmaxObserver` per
    weight matrix and an :class:`~..quantization.observers.AbsmaxObserver`
    per activation site.  It never touches an engine.
 2. **Quantize**: :func:`quantize_params` rewrites the flat weight dict:
    each projection and MLP matrix ``name`` becomes ``name::q`` (int8) +
    ``name::scale`` (f32 per out channel); the activation scales ride
    along as ``act::<site>::scale`` leaves of shape (1,).  The model's
    matrix-product helper dispatches on the ``::q`` key, so one set of
    step functions serves every precision.
 3. **Save/load**: :func:`save_quantized_model` writes a served-model
    directory whose ``serve_config.json`` carries a ``precision`` block
    and whose checkpoint holds the quantized tree, in the JAX package's
    format: either package serves the other's directory
    (:func:`.engine.load_engine`).

Quality is the largest logit gap of the int8 path from the fp32 one
(:func:`logit_divergence`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.quant_kernels import quantize_weight
from ..quantization.observers import AbsmaxObserver, PerChannelAbsmaxObserver
from .model import (QUANT_WEIGHT_NAMES, ModelSpec, _param_shapes,
                    decode_step, prefill_step)

__all__ = ["calibrate", "quantize_params", "is_quantized_params",
           "quantized_template", "save_quantized_model",
           "logit_divergence", "default_calibration_prompts",
           "PRECISION_SCHEME"]

PRECISION_SCHEME = {
    "mode": "int8",
    "weights": "per-channel-absmax (out-channel), symmetric, no zero-point",
    "activations": "per-tensor-absmax, recorded for a8 follow-on",
    "kv_cache": "int8 per-(token,head) dynamic scales in shadow scale pages",
}


def default_calibration_prompts(spec: ModelSpec, n: int = 4,
                                seed: int = 0) -> List[List[int]]:
    """A fixed calibration set (the JAX package's: the same prompts)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, spec.vocab_size,
                        size=int(rng.randint(3, 13))).tolist()
            for _ in range(n)]


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
class _TapObservers:
    """The ``tap(site, activation)`` hook: one per-tensor absmax
    observer per activation site (each product's input, and the head's
    input)."""

    def __init__(self):
        self.observers: Dict[str, AbsmaxObserver] = {}
        self.samples = 0

    def __call__(self, site: str, x) -> None:
        obs = self.observers.get(site)
        if obs is None:
            obs = self.observers[site] = AbsmaxObserver()
        obs.observe(x)
        self.samples += 1

    def scales(self) -> Dict[str, float]:
        return {site: float(o.scales())
                for site, o in sorted(self.observers.items())}


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


class _Pools:
    """Throwaway KV pools for one prompt of ``total`` positions: f32
    (and, with ``int8``, int8 with their scale pools), the prompt's
    pages ``1..pages-1``."""

    def __init__(self, spec, total, page_size, device, int8=False):
        pages = 1 + -(-total // page_size)
        shape = (spec.layers, pages * page_size, spec.heads, spec.head_dim)
        self.kv = [torch.zeros(shape, device=device) for _ in range(2)]
        self.q = ([torch.zeros(shape, dtype=torch.int8, device=device)
                   for _ in range(2)]
                  + [torch.zeros(shape[:-1], device=device)
                     for _ in range(2)]) if int8 else None
        self.table = torch.arange(1, pages, dtype=torch.int32,
                                  device=device)


def _prefill(spec, params, pools, prompt, page_size, tap=None, int8=False):
    """Prefill ``prompt`` into ``pools``: (next token, logits)."""
    dev = pools.table.device
    tokens = torch.tensor(prompt, dtype=torch.int32, device=dev)
    if int8:
        kq, vq, ks, vs = pools.q
        out = prefill_step(spec, params, kq, vq, tokens, len(prompt),
                           pools.table, page_size=page_size, k_scale=ks,
                           v_scale=vs, tap=tap)
    else:
        out = prefill_step(spec, params, *pools.kv, tokens, len(prompt),
                           pools.table, page_size=page_size, tap=tap)
    return out[-2].reshape(1), out[-1]


def _decode(spec, params, pools, tok, pos, page_size, tap=None, int8=False):
    """One decode step of the row at ``pos``: (next token, logits)."""
    dev = pools.table.device
    positions = torch.tensor([pos], dtype=torch.int32, device=dev)
    tables = pools.table[None, :]
    if int8:
        kq, vq, ks, vs = pools.q
        out = decode_step(spec, params, kq, vq, tok, positions, tables,
                          page_size=page_size, k_scale=ks, v_scale=vs,
                          tap=tap)
    else:
        out = decode_step(spec, params, *pools.kv, tok, positions, tables,
                          page_size=page_size, tap=tap)
    return out[-2], out[-1]


@torch.no_grad()
def calibrate(spec: ModelSpec, params, prompts: Sequence[Sequence[int]],
              *, max_new: int = 4, page_size: int = 8) -> Dict[str, Any]:
    """Run the PTQ observers over a prefill/decode trace.

    Replays each prompt through :func:`.model.prefill_step` and
    ``max_new`` :func:`.model.decode_step` calls eagerly (fp32, on the
    weights' device, throwaway KV pools sized per prompt), tapping every
    quantizable product's input, and folds each weight matrix through a
    :class:`PerChannelAbsmaxObserver`.

    Returns ``{"act_scales", "weight_scales", "samples", "prompts"}``.
    """
    prompts = [list(p) for p in prompts]
    tap = _TapObservers()
    weight_obs: Dict[str, PerChannelAbsmaxObserver] = {}
    for name in QUANT_WEIGHT_NAMES(spec):
        obs = PerChannelAbsmaxObserver(quant_axis_=1)
        obs.observe(params[name])
        weight_obs[name] = obs
    dev = _device_of(params)
    for prompt in prompts:
        pools = _Pools(spec, len(prompt) + max_new, page_size, dev)
        tok, _ = _prefill(spec, params, pools, prompt, page_size, tap)
        for j in range(max_new):
            tok, _ = _decode(spec, params, pools, tok, len(prompt) + j,
                             page_size, tap)
    return {
        "act_scales": tap.scales(),
        "weight_scales": {n: np.asarray(o.scales(), np.float32)
                          for n, o in sorted(weight_obs.items())},
        "samples": tap.samples,
        "prompts": len(prompts),
    }


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------
def is_quantized_params(params) -> bool:
    return any(str(k).endswith("::q") for k in params)


def quantize_params(params, spec: ModelSpec,
                    act_scales: Optional[Dict[str, float]] = None
                    ) -> Dict[str, Any]:
    """Rewrite a flat fp32 weight dict into the int8 serve layout.

    Each quantizable matrix is replaced, in place in the key order, by
    ``name::q`` + ``name::scale``; everything else passes through.
    ``act_scales`` (from :func:`calibrate`) are appended as
    ``act::<site>::scale`` f32 leaves of shape (1,).  Deterministic: the
    same weights always give the same bytes (the JAX package's too)."""
    if is_quantized_params(params):
        return dict(params)
    targets = set(QUANT_WEIGHT_NAMES(spec))
    out: Dict[str, Any] = {}
    for name, w in params.items():
        if name in targets:
            q, s = quantize_weight(w, axis=1)
            out[name + "::q"] = q
            out[name + "::scale"] = s
        else:
            out[name] = w
    dev = _device_of(params)
    for site, scale in sorted((act_scales or {}).items()):
        out[f"act::{site}::scale"] = torch.tensor(
            [scale], dtype=torch.float32, device=dev)
    return out


def quantized_template(spec: ModelSpec,
                       act_sites: Optional[Sequence[str]] = None,
                       device=None) -> Dict[str, Any]:
    """The names, shapes and dtypes of a quantized checkpoint's tree
    (zeros; ``act_sites`` the calibration sites of the directory's
    precision block), on ``device`` (the CPU by default)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    base = quantize_params({n: torch.zeros(s, device=dev)
                            for n, s in _param_shapes(spec).items()}, spec)
    for site in act_sites or ():
        base[f"act::{site}::scale"] = torch.zeros(1, device=dev)
    return base


# ---------------------------------------------------------------------------
# quantized served-model dirs
# ---------------------------------------------------------------------------
def save_quantized_model(path: str, spec: ModelSpec, params,
                         config=None, prompts=None, *, max_new: int = 4,
                         step: int = 0) -> str:
    """Calibrate, quantize and write a quantized served-model directory.

    ``serve_config.json`` gains a ``precision`` block (the scheme, the
    calibration corpus' size, the per-tensor activation scales, the
    quantized weights' names) and its ``serve.precision`` is ``int8``;
    the checkpoint holds the quantized tree.  Calibration runs on the
    weights' device."""
    from ..distributed.checkpoint_manager import CheckpointManager
    from .engine import SERVE_CONFIG_NAME, ServeConfig
    os.makedirs(path, exist_ok=True)
    cfg = (config or ServeConfig.from_env()).replace(precision="int8")
    if prompts is None:
        prompts = default_calibration_prompts(spec)
    cal = calibrate(spec, params, prompts, max_new=max_new,
                    page_size=cfg.page_size)
    qparams = quantize_params(params, spec, act_scales=cal["act_scales"])
    meta = {
        "model": spec.to_dict(),
        "serve": cfg.to_dict(),
        "precision": {
            **PRECISION_SCHEME,
            "act_scales": cal["act_scales"],
            "calibration": {"prompts": cal["prompts"],
                            "samples": cal["samples"],
                            "max_new": max_new},
            "quantized_weights": QUANT_WEIGHT_NAMES(spec),
        },
    }
    with open(os.path.join(path, SERVE_CONFIG_NAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    mgr = CheckpointManager(os.path.join(path, "weights"))
    mgr.save(step, dict(qparams), block=True)
    return path


# ---------------------------------------------------------------------------
# quality: the largest logit gap from the fp32 path
# ---------------------------------------------------------------------------
@torch.no_grad()
def logit_divergence(spec: ModelSpec, params, prompts=None, *,
                     max_new: int = 4, page_size: int = 8,
                     qparams=None) -> float:
    """The largest absolute logit gap between the int8 serve path
    (quantized weights, int8 KV pool) and the fp32 path, over prefill and
    ``max_new`` decode steps of each prompt.  The int8 run is fed the
    fp32 run's greedy tokens, so both score the same sequence."""
    if prompts is None:
        prompts = default_calibration_prompts(spec)
    if qparams is None:
        qparams = quantize_params(params, spec)
    dev = _device_of(params)
    worst = torch.zeros((), device=dev)
    for prompt in prompts:
        prompt = list(prompt)
        total = len(prompt) + max_new
        fp = _Pools(spec, total, page_size, dev)
        q8 = _Pools(spec, total, page_size, dev, int8=True)
        tok, lg_f = _prefill(spec, params, fp, prompt, page_size)
        _, lg_q = _prefill(spec, qparams, q8, prompt, page_size, int8=True)
        worst = torch.maximum(worst, (lg_q - lg_f).abs().max())
        for j in range(max_new):
            pos = len(prompt) + j
            nxt, lg_f = _decode(spec, params, fp, tok, pos, page_size)
            _, lg_q = _decode(spec, qparams, q8, tok, pos, page_size,
                              int8=True)
            worst = torch.maximum(worst, (lg_q - lg_f).abs().max())
            tok = nxt
    return float(worst)
