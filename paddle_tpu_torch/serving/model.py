"""Serve-side decoder: plain functions on tensors over a paged KV cache.

The counterpart of ``paddle_tpu/serving/model.py``, with the same
parameter names and ``(in, out)`` layouts, so a weight dict moves
between the packages by name (:func:`params_from_numpy`).

 - :func:`prefill_step`: one prompt padded to a sequence bucket; runs
   the stack under a causal and length mask, writes the prompt's K/V
   into its pages, returns the first generated token.
 - :func:`decode_step`: one padded batch bucket; one new token per row,
   written at the row's slot, attending over the row's pages through
   the paged-attention kernel.

Determinism contract (continuous batching): decode math is row
independent, so a row's logits do not depend on its batch neighbours or
on which physical pages it landed in.  The kernels keep it for any batch
size; the plain matrix products (``torch.matmul``) keep it within one
batch shape, which the engine's fixed bucket ladder provides.

Numerics follow the JAX model: LayerNorm statistics in f32 with eps
1e-5, the result cast back to the compute dtype; tanh-approximated
GELU; a -1e30 mask on prefill scores; ``1/sqrt(head_dim)`` scaling;
greedy argmax takes the first index on ties.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.paged_attention import paged_attention, paged_attention_int8
from ..ops.quant_kernels import quantize_kv, w8a16_matmul

__all__ = ["ModelSpec", "init_params", "prefill_step", "decode_step",
           "QUANT_WEIGHT_NAMES", "params_from_numpy"]

_LN_EPS = 1e-5
_NEG_INF = -1e30


def QUANT_WEIGHT_NAMES(spec: "ModelSpec"):
    """The weight matrices the int8 serve path quantizes: every
    projection and MLP matrix.  Embedding, positional table, norms and
    biases stay f32."""
    names = []
    for i in range(spec.layers):
        names += [f"h{i}.attn.wq", f"h{i}.attn.wk", f"h{i}.attn.wv",
                  f"h{i}.attn.wo", f"h{i}.mlp.w1", f"h{i}.mlp.w2"]
    return names


def _matmul(params, name, x, tap=None):
    """A weight present as ``name::q`` + ``name::scale`` runs through
    the w8a16 kernel; otherwise a plain dense product.  ``tap`` is the
    calibration hook, called with the product's input under the site
    name ``name`` (None on the engine's path)."""
    if tap is not None:
        tap(name, x)
    qk = name + "::q"
    if qk in params:
        return w8a16_matmul(x, params[qk], params[name + "::scale"])
    return x @ params[name]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture hyperparameters of a served decoder."""

    vocab_size: int = 256
    hidden: int = 64
    layers: int = 2
    heads: int = 4
    max_seq_len: int = 256
    ffn_mult: int = 4

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def __post_init__(self):
        if self.hidden % self.heads:
            raise ValueError(
                f"hidden={self.hidden} not divisible by heads={self.heads}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in names})


def _param_shapes(spec: ModelSpec) -> Dict[str, tuple]:
    ffn = spec.hidden * spec.ffn_mult
    hd = spec.hidden
    shapes = {"embed": (spec.vocab_size, hd), "pos": (spec.max_seq_len, hd)}
    for i in range(spec.layers):
        shapes.update({
            f"h{i}.ln1.w": (hd,), f"h{i}.ln1.b": (hd,),
            f"h{i}.attn.wq": (hd, hd), f"h{i}.attn.wk": (hd, hd),
            f"h{i}.attn.wv": (hd, hd), f"h{i}.attn.wo": (hd, hd),
            f"h{i}.ln2.w": (hd,), f"h{i}.ln2.b": (hd,),
            f"h{i}.mlp.w1": (hd, ffn), f"h{i}.mlp.b1": (ffn,),
            f"h{i}.mlp.w2": (ffn, hd), f"h{i}.mlp.b2": (hd,),
        })
    shapes["lnf.w"] = (hd,)
    shapes["lnf.b"] = (hd,)
    return shapes


def init_params(spec: ModelSpec, seed: int = 0, device=None
                ) -> Dict[str, torch.Tensor]:
    """Flat ``name -> tensor`` dict of random weights from ``seed``.

    Drawn from a ``torch.Generator`` on ``device`` (``cuda`` unless the
    CPU is asked for): the same names, shapes and scales as the JAX
    package, not the same bits.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    p: Dict[str, torch.Tensor] = {}
    for name, shape in _param_shapes(spec).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("b", "b1", "b2"):
            p[name] = torch.zeros(shape, device=dev)
        elif leaf == "w" and len(shape) == 1:
            p[name] = torch.ones(shape, device=dev)
        else:
            p[name] = torch.randn(shape, generator=gen, device=dev) * 0.02
    return p


def params_from_numpy(np_params, device=None, dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """Carry a flat serve weight dict (numpy arrays or tensors) onto
    ``device``, checking names and shapes.

    Takes the fp32 tree and the int8 tree (``name::q`` int8 ``(in, out)``
    plus ``name::scale`` f32 ``(out,)``; calibration leaves
    ``act::<site>::scale`` pass through).  The spec is read from the
    shapes; every name it implies must be present and no other.
    ``dtype`` casts the floating leaves other than the int8 scales.
    """
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, a in np_params.items():
        t = torch.from_numpy(np.array(a)) \
            if isinstance(a, np.ndarray) else torch.as_tensor(a)
        if (dtype is not None and t.is_floating_point()
                and not name.endswith("::scale")):
            t = t.to(dtype)
        out[name] = t.to(dev)
    if "embed" not in out or "pos" not in out or "h0.mlp.b1" not in out:
        raise ValueError("not a serve weight dict: embed, pos or "
                         "h0.mlp.b1 missing")
    vocab, hidden = out["embed"].shape
    layers = sum(1 for k in out if k.endswith(".ln1.w"))
    spec = ModelSpec(vocab_size=vocab, hidden=hidden, layers=layers, heads=1,
                     max_seq_len=out["pos"].shape[0],
                     ffn_mult=out["h0.mlp.b1"].shape[0] // hidden)
    want = _param_shapes(spec)
    for name in QUANT_WEIGHT_NAMES(spec):
        if name + "::q" in out:
            k_in, n_out = want.pop(name)
            want[name + "::q"] = (k_in, n_out)
            want[name + "::scale"] = (n_out,)
    got = {k: tuple(v.shape) for k, v in out.items()
           if not k.startswith("act::")}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"serve weights do not match the spec: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}, wrong "
                         f"shape {wrong[:4]}")
    for name, t in out.items():
        if name.endswith("::q") and t.dtype != torch.int8:
            raise ValueError(f"{name} must be int8, got {t.dtype}")
    return out


def _ln(x, w, b):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + _LN_EPS) * w + b


def _mlp(params, i, x, tap=None):
    h = _matmul(params, f"h{i}.mlp.w1", x, tap) + params[f"h{i}.mlp.b1"]
    h = F.gelu(h, approximate="tanh")
    return _matmul(params, f"h{i}.mlp.w2", h, tap) + params[f"h{i}.mlp.b2"]


def _flat_dest(page_table, positions, page_size):
    """Flat pool row of each position through its page table: position
    ``t`` lives at ``pt[t // ps] * ps + t % ps``.  Batched
    (``(B, maxp)``, ``(B,)``) or single (``(maxp,)``, ``(S,)``)."""
    idx = (positions // page_size).long()
    if page_table.dim() == 2:
        page = torch.gather(page_table, 1, idx[:, None])[:, 0]
    else:
        page = page_table[idx]
    return page.long() * page_size + (positions % page_size).long()


def _write_kv(k_flat, v_flat, k_scale, v_scale, layer, dest, k, v):
    """Write K/V (quantized per (token, head) on an int8 pool) into the
    pool rows ``dest`` of ``layer`` (all layers when ``layer`` is None),
    in place."""
    sel = (slice(None), dest) if layer is None else (layer, dest)
    if k_flat.dtype == torch.int8:
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        k_flat[sel] = kq
        v_flat[sel] = vq
        k_scale[sel] = ksc
        v_scale[sel] = vsc
    else:
        k_flat[sel] = k.to(k_flat.dtype)
        v_flat[sel] = v.to(v_flat.dtype)


def prefill_step(spec: ModelSpec, params, k_flat, v_flat, tokens, length,
                 page_table, *, page_size: int, k_scale=None, v_scale=None,
                 tap=None):
    """Run one prompt (padded to a seq bucket) and seed its KV pages.

    Args:
      k_flat/v_flat: pools ``(L, P*ps, H, D)``, updated in place.
      tokens: ``(S,)`` int, the padded prompt (bucket size S).
      length: the true prompt length (1 <= length <= S), a 0-d int32
        tensor on the device, as the JAX step takes it (an int is put
        there); it is read on the device only, so a CUDA graph of the
        step serves every length of its bucket.
      page_table: ``(max_pages,)`` int32 pages owned by this sequence
        (unused tail = 0, the null page).
      k_scale/v_scale: scale pools ``(L, P*ps, H)`` f32 when the pool is
        int8, updated in place.
      tap: the calibration hook ``tap(site, activation)``: each
        product's input under its weight's name, and the final
        LayerNorm's output over every position as ``"head"``, the JAX
        step's sites; None on the engine's path.

    Returns ``(k_flat, v_flat, next_token, logits)``, with the scale
    pools after ``v_flat`` when they were passed, as the JAX function
    does.  The returned pools are the tensors passed in, updated in
    place.  Prefill attends over the layer's full-precision K/V; the
    stored pages serve later decode steps.  Padding positions write to
    flat row 0, inside the null page, which no reader sees unmasked.
    """
    s = tokens.shape[0]
    dev = tokens.device
    if not isinstance(length, torch.Tensor):
        length = torch.tensor(int(length), dtype=torch.int32, device=dev)
    length = length.reshape(())
    tokens = tokens.long()
    h = params["embed"][tokens] + params["pos"][:s]
    cdt = params["embed"].dtype
    pos_ids = torch.arange(s, device=dev)
    # key j visible to query i iff j <= i and j < length
    visible = (pos_ids[None, :] <= pos_ids[:, None]) & (pos_ids[None, :] < length)
    scale = 1.0 / math.sqrt(spec.head_dim)
    ks, vs = [], []
    for i in range(spec.layers):
        x = _ln(h, params[f"h{i}.ln1.w"], params[f"h{i}.ln1.b"]).to(cdt)
        q = _matmul(params, f"h{i}.attn.wq", x,
                    tap).reshape(s, spec.heads, spec.head_dim)
        k = _matmul(params, f"h{i}.attn.wk", x,
                    tap).reshape(s, spec.heads, spec.head_dim)
        v = _matmul(params, f"h{i}.attn.wv", x,
                    tap).reshape(s, spec.heads, spec.head_dim)
        att = torch.einsum("ihd,jhd->hij", q.float(), k.float()) * scale
        att = att.masked_fill(~visible[None], _NEG_INF)
        w = torch.softmax(att, dim=-1)
        o = torch.einsum("hij,jhd->ihd", w.to(v.dtype).float(), v.float())
        o = o.reshape(s, spec.hidden).to(cdt)
        h = h + _matmul(params, f"h{i}.attn.wo", o, tap)
        x2 = _ln(h, params[f"h{i}.ln2.w"], params[f"h{i}.ln2.b"]).to(cdt)
        h = h + _mlp(params, i, x2, tap)
        ks.append(k)
        vs.append(v)
    if tap is not None:
        tap("head", _ln(h, params["lnf.w"], params["lnf.b"]).to(cdt))
    last = h.index_select(0, (length - 1).long().reshape(1))[0]
    hf = _ln(last, params["lnf.w"], params["lnf.b"]).to(cdt)
    logits = hf @ params["embed"].T                         # (V,)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)
    dest = torch.where(pos_ids < length,
                       _flat_dest(page_table, pos_ids, page_size),
                       torch.zeros((), dtype=torch.long, device=dev))
    _write_kv(k_flat, v_flat, k_scale, v_scale, None, dest,
              torch.stack(ks), torch.stack(vs))
    if k_scale is not None:
        return k_flat, v_flat, k_scale, v_scale, next_token, logits
    return k_flat, v_flat, next_token, logits


def decode_step(spec: ModelSpec, params, k_flat, v_flat, tokens, positions,
                page_tables, *, page_size: int, k_scale=None, v_scale=None,
                tap=None):
    """One decode step for a padded batch bucket.

    Args:
      k_flat/v_flat: pools ``(L, P*ps, H, D)``, updated in place.
      tokens: ``(B,)`` int current token per row.
      positions: ``(B,)`` int32 position of that token (0-based);
        padding rows point at position 0 with page-table row 0, so their
        writes land in the null page.
      page_tables: ``(B, max_pages)`` int32.
      k_scale/v_scale: scale pools ``(L, P*ps, H)`` f32 for an int8
        pool, updated in place; the step's K/V quantize per (token,
        head) at write time.
      tap: the calibration hook, as in :func:`prefill_step`.

    Returns ``(k_flat, v_flat, next_tokens, logits)``, with the scale
    pools after ``v_flat`` when they were passed.  The returned pools
    are the tensors passed in, updated in place.
    """
    b = tokens.shape[0]
    num_pages = k_flat.shape[1] // page_size
    quant = k_flat.dtype == torch.int8
    positions = positions.to(torch.int32)
    dest = _flat_dest(page_tables, positions, page_size)   # (B,)
    lengths = positions + 1
    h = params["embed"][tokens.long()] + params["pos"][positions.long()]
    cdt = params["embed"].dtype
    pages = (num_pages, page_size, spec.heads, spec.head_dim)
    for i in range(spec.layers):
        x = _ln(h, params[f"h{i}.ln1.w"], params[f"h{i}.ln1.b"]).to(cdt)
        q = _matmul(params, f"h{i}.attn.wq", x,
                    tap).reshape(b, spec.heads, spec.head_dim)
        k = _matmul(params, f"h{i}.attn.wk", x,
                    tap).reshape(b, spec.heads, spec.head_dim)
        v = _matmul(params, f"h{i}.attn.wv", x,
                    tap).reshape(b, spec.heads, spec.head_dim)
        _write_kv(k_flat, v_flat, k_scale, v_scale, i, dest, k, v)
        if quant:
            o = paged_attention_int8(
                q, k_flat[i].view(pages), v_flat[i].view(pages),
                k_scale[i].view(pages[:3]), v_scale[i].view(pages[:3]),
                page_tables, lengths)
        else:
            o = paged_attention(q, k_flat[i].view(pages),
                                v_flat[i].view(pages), page_tables, lengths)
        h = h + _matmul(params, f"h{i}.attn.wo", o.reshape(b, spec.hidden),
                        tap)
        x2 = _ln(h, params[f"h{i}.ln2.w"], params[f"h{i}.ln2.b"]).to(cdt)
        h = h + _mlp(params, i, x2, tap)
    hf = _ln(h, params["lnf.w"], params["lnf.b"]).to(cdt)
    if tap is not None:
        tap("head", hf)
    logits = hf @ params["embed"].T                        # (B, V)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if k_scale is not None:
        return k_flat, v_flat, k_scale, v_scale, next_tokens, logits
    return k_flat, v_flat, next_tokens, logits
