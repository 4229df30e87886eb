"""MoE routing (the counterpart of
``paddle_tpu/incubate/distributed/models/moe/functional.py``).

The JAX package routes GShard's way: gating gives a dense one-hot
``dispatch`` mask (tokens x experts x capacity) and the routing is two
einsums.  The port computes the same function from each token's choice
of expert, its position in that expert's buffer and its gate weight:
:func:`route` returns those, the layer gathers and scatter-adds by them
(at GPT-345m width the dense form is about 3e14 operations a layer),
and :func:`top1_gating`, :func:`top2_gating`, :func:`dispatch` and
:func:`combine` build the JAX package's dense tensors from them, with
its signatures.

The JAX semantics, kept exactly:

 - a token's position in an expert counts the tokens before it in the
   global token order (the exclusive cumulative sum of the one-hot
   choices, plus ``prior_count``); it is kept while below ``capacity``;
 - the auxiliary loss is Switch's ``E * sum_e(f_e * p_e)``, the share
   of tokens whose first choice is ``e`` (before capacity) times the mean
   gate probability, from the first pass only;
 - top-2's second pass masks out only the first choices that survived
   capacity, so a token its first expert dropped may choose that expert
   again, and is dropped again (its count there is already full); the
   second pass's positions start after the first pass's kept counts;
 - the two gate values are divided by their kept sum, 1 where it is 0.

With tokens spread over several ranks (expert parallelism with data
parallelism), ``offset`` adds the counts of the ranks before this one
and ``totals`` gives the global counts and token number (the layer
exchanges them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

__all__ = ["top1_gating", "top2_gating", "dispatch", "combine", "route",
           "Choice"]


@dataclass
class Choice:
    """One pass of routing over ``T`` tokens: ``expert`` (T,) the chosen
    expert, ``pos`` (T,) its position in that expert's buffer (global),
    ``keep`` (T,) whether it is below capacity, ``gate`` (T,) the gate
    value of the choice (differentiable), ``raw`` (E,) this rank's
    tokens choosing each expert before capacity."""

    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    raw: torch.Tensor


def _pass(logits, capacity, prior=None, exchange=None) -> tuple:
    """One top-1 pass: (Choice, gates (T, E))."""
    e = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(gates, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, e)
    raw = onehot.sum(0)
    before = torch.cumsum(onehot, 0) - onehot        # exclusive, (T, E)
    offset = exchange(raw) if exchange is not None else None
    if offset is not None:
        before = before + offset
    if prior is not None:
        before = before + prior.to(before.dtype)
    pos = before.gather(1, idx[:, None])[:, 0]
    keep = pos < capacity
    gate = gates.gather(1, idx[:, None])[:, 0]
    return Choice(idx, pos, keep, gate, raw), gates


def route(logits, capacity: int, top_k: int, *, exchange=None,
          total_tokens: Optional[int] = None, gate_sum=None):
    """The routing of ``logits`` (T, E): ``(choices, weights, aux)``.

    ``choices``: one :class:`Choice` a pass (``top_k`` of them);
    ``weights``: each pass's combine weight (T,), 0 where dropped;
    ``aux``: the auxiliary loss (0-d, differentiable).  With tokens on
    several ranks, ``exchange(raw)`` returns (offset (E,), totals (E,)):
    the counts of the ranks before this one and of all, for each pass in
    turn; ``total_tokens`` the global token number; ``gate_sum(sums)``
    the gate probabilities summed over every rank's tokens."""
    t, e = logits.shape
    offsets = []

    def offset_of(raw):
        if exchange is None:
            offsets.append((None, raw))
            return None
        off, tot = exchange(raw)
        offsets.append((off, tot))
        return off

    first, gates = _pass(logits, capacity, exchange=offset_of)
    total = t if total_tokens is None else total_tokens
    counts = offsets[0][1].float()
    sums = gates.sum(0)
    if gate_sum is not None:
        sums = gate_sum(sums)
    aux = torch.sum(counts / total * (sums / total)) * e
    k1 = first.keep.float()
    if top_k == 1:
        return [first], [first.gate * k1], aux
    kept1 = torch.nn.functional.one_hot(first.expert, e).bool() & \
        first.keep[:, None]
    logits2 = torch.where(kept1, torch.full_like(logits.float(),
                                                 float("-inf")),
                          logits.float())
    # the second pass starts after the first pass's kept tokens
    count1 = torch.clamp(offsets[0][1], max=capacity)
    second, _ = _pass(logits2, capacity, prior=count1, exchange=offset_of)
    k2 = second.keep.float()
    denom = first.gate * k1 + second.gate * k2
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return [first, second], [first.gate * k1 / denom,
                             second.gate * k2 / denom], aux


def _dense(choices: List[Choice], weights, e: int, capacity: int):
    t = choices[0].expert.shape[0]
    disp = torch.zeros(t, e, capacity, dtype=torch.bool,
                       device=choices[0].expert.device)
    comb = torch.zeros(t, e, capacity, device=disp.device)
    rows = torch.arange(t, device=disp.device)
    for c, w in zip(choices, weights):
        tok = rows[c.keep]
        disp[tok, c.expert[c.keep], c.pos[c.keep]] = True
        comb = comb.index_put((tok, c.expert[c.keep], c.pos[c.keep]),
                              w[c.keep], accumulate=True)
    return comb, disp


def top1_gating(logits, capacity, prior_count=None):
    """Switch routing, the JAX function's outputs: ``(combine (T, E, C),
    dispatch (T, E, C) bool, aux, gates (T, E), mask (T, E))``, the mask
    the kept one-hot choices.  ``prior_count`` (T, E): tokens already in
    each expert's buffer."""
    t, e = logits.shape
    first, gates = _pass(logits, capacity, prior=prior_count)
    aux = torch.sum(first.raw.float() / t * gates.mean(0)) * e
    k = first.keep.float()
    comb, disp = _dense([first], [first.gate * k], e, capacity)
    mask = torch.nn.functional.one_hot(first.expert, e).float() * k[:, None]
    return comb, disp, aux, gates, mask


def top2_gating(logits, capacity):
    """GShard top-2 routing, the JAX function's outputs: ``(combine,
    dispatch, aux)``."""
    choices, weights, aux = route(logits, capacity, 2)
    comb, disp = _dense(choices, weights, logits.shape[-1], capacity)
    return comb, disp, aux


def dispatch(x, disp):
    """(T, D), (T, E, C) -> expert inputs (E, C, D)."""
    return torch.einsum("tec,td->ecd", disp.to(x.dtype), x)


def combine(expert_out, comb):
    """(E, C, D), (T, E, C) -> (T, D)."""
    return torch.einsum("tec,ecd->td", comb.to(expert_out.dtype),
                        expert_out)
