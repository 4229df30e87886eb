"""GPT for causal language modelling (the counterpart of
``paddle_tpu/incubate/models/gpt.py``).

Parameter names and layouts are the JAX model's
(``gpt.embeddings.word_embeddings.weight``,
``gpt.layers.0.attn.qkv_proj.weight`` ``(hidden, 3 * hidden)``, ...), so
its weights load by name (:func:`params_from_numpy`).  What the JAX
model computes, kept here:

 - learned positions; pre-LN decoder blocks; tanh GELU; the LM head tied
   to the word embedding (``x @ word_embeddings.weight.T``);
 - the QKV projection interleaved per head: its output reshapes to
   ``(B, S, heads, 3 * head_dim)`` and q, k and v are slices of the last
   axis, not three hidden-wide thirds;
 - ``fc2`` drawn with ``std / sqrt(2 * num_layers)``;
 - with ``use_recompute`` each decoder block is recomputed in the
   backward pass, its dropout masks replayed.

Built after ``fleet.init``, the model is one rank's shard over fleet's
model-parallel group (the JAX model's ``tensor_parallel=True``
branches); without fleet it is the unsharded model, as the JAX model is
on a mesh without an mp axis.  In a shard the word embedding is a
``VocabParallelEmbedding``, QKV and ``fc1`` are ``ColumnParallelLinear``
without gathering their outputs, ``out_proj`` and ``fc2`` are
``RowParallelLinear`` on parallel inputs.  QKV's output is interleaved
per head, so a rank's contiguous columns are whole heads and it attends
over ``num_attention_heads / mp`` of them.  The tied head is
``_c_identity(h) @ W_local.T``: vocabulary-local logits, for the sharded
``ParallelCrossEntropy`` of ``GPTPretrainingCriterion`` on the model's
``mp_group``.  Each layer
draws its whole weight and keeps its slice, so a shard holds the slices
of the unsharded model drawn from the same seed.  Attention dropout
draws from :meth:`GPTForCausalLM.set_attention_generator`'s generator
when one is set (the local stream of
``fleet.meta_parallel.random``), every other dropout from the generator
passed to ``forward``.

Built after ``fleet.init`` with a sep degree above 1, the model runs on
one rank's positions of each sequence (``local_batch``): attention goes
around the sep ring (:class:`RingFlashAttention`, its dropout seed from
the attention generator, the same on every sep rank), and the default
position ids start at ``sep_rank * S_local``.

For pipeline parallelism :meth:`GPTForCausalLM.pipeline_blocks` names
the decoder stack (the JAX adapter), :meth:`GPTForCausalLM.keep_stage`
keeps one rank's virtual stages of a model built whole (so every stage
holds the weights the unsplit model draws from the same seed):
virtual stage ``k`` of ``pp * v`` runs blocks ``[k L / (pp v), (k + 1) L
/ (pp v))``, the first also the embeddings, the last ``final_ln`` and
the tied head (the word embedding is kept on the first and the last
stage), and :meth:`GPTForCausalLM.forward_chunk` runs one.

Not ported: rotary positions, an untied head, attention masks other
than causal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...distributed.fleet import recompute
from ...distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                                ParallelCrossEntropy,
                                                RowParallelLinear,
                                                VocabParallelEmbedding)
from ...distributed.fleet.meta_parallel.mp_ops import _c_identity
from ...distributed.fleet.meta_parallel.parallel_layers.mp_layers import \
    mp_group_of
from ...distributed.fleet.meta_parallel.sequence_parallel import (
    RingFlashAttention, sep_group_of)
from ...nn import Dropout, Embedding, LayerNorm, Linear
from ...nn import functional as F
from ...nn.initializer import Normal

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_345m",
           "params_from_numpy", "split_axes", "gather_params"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 0       # 0 -> 4 * hidden
    max_position_embeddings: int = 2048
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_recompute: bool = False

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size


def _degree(group) -> int:
    return 1 if group is None else group.nranks


class GPTAttention(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 mp_group=None):
        super().__init__()
        h = cfg.hidden_size
        self.head_dim = h // cfg.num_attention_heads
        init = Normal(std=cfg.initializer_range)
        if mp_group is not None:
            n = _degree(mp_group)
            if cfg.num_attention_heads % n:
                raise ValueError(f"{cfg.num_attention_heads} heads do not "
                                 f"split over {n} model-parallel ranks")
            self.num_heads = cfg.num_attention_heads // n
            self.qkv_proj = ColumnParallelLinear(
                h, 3 * h, init, generator=generator, gather_output=False,
                mp_group=mp_group)
            self.out_proj = RowParallelLinear(
                h, h, init, generator=generator, input_is_parallel=True,
                mp_group=mp_group)
        else:
            self.num_heads = cfg.num_attention_heads
            self.qkv_proj = Linear(h, 3 * h, init, generator=generator)
            self.out_proj = Linear(h, h, init, generator=generator)
        self.attn_dropout_p = cfg.attention_probs_dropout_prob
        self.attn_generator: Optional[torch.Generator] = None
        sep = sep_group_of()
        self.ring = None if sep is None else RingFlashAttention(
            causal=True, group=sep)

    def forward(self, x, generator=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, self.num_heads,
                                       3 * self.head_dim)
        hd = self.head_dim
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        if self.attn_generator is not None:
            generator = self.attn_generator
        if self.ring is not None:
            out = self.ring(q, k, v, dropout_p=self.attn_dropout_p,
                            training=self.training, generator=generator)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.attn_dropout_p, is_causal=True,
                training=self.training, generator=generator)
        return self.out_proj(out.reshape(b, s, self.num_heads * hd))


class GPTMLP(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 mp_group=None):
        super().__init__()
        init = Normal(std=cfg.initializer_range)
        out_init = Normal(
            std=cfg.initializer_range / math.sqrt(2 * cfg.num_layers))
        if mp_group is not None:
            self.fc1 = ColumnParallelLinear(
                cfg.hidden_size, cfg.intermediate_size, init,
                generator=generator, gather_output=False, mp_group=mp_group)
            self.fc2 = RowParallelLinear(
                cfg.intermediate_size, cfg.hidden_size, out_init,
                generator=generator, input_is_parallel=True,
                mp_group=mp_group)
        else:
            self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, init,
                              generator=generator)
            self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size,
                              out_init, generator=generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(torch.nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 mp_group=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.ln1 = LayerNorm(cfg.hidden_size, eps, generator=generator)
        self.attn = GPTAttention(cfg, generator, mp_group)
        self.ln2 = LayerNorm(cfg.hidden_size, eps, generator=generator)
        self.mlp = GPTMLP(cfg, generator, mp_group)
        self.dropout1 = Dropout(cfg.hidden_dropout_prob)
        self.dropout2 = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, generator=None):
        x = x + self.dropout1(self.attn(self.ln1(x), generator), generator)
        return x + self.dropout2(self.mlp(self.ln2(x)), generator)


class GPTEmbeddings(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 mp_group=None):
        super().__init__()
        init = Normal(std=cfg.initializer_range)
        if mp_group is not None:
            self.word_embeddings = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, init, generator=generator,
                mp_group=mp_group)
        else:
            self.word_embeddings = Embedding(cfg.vocab_size,
                                             cfg.hidden_size, init,
                                             generator=generator)
        self.position_embeddings = Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, init,
            generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        sep = sep_group_of()
        # a sep rank's tokens start at this position of the sequence
        self.sep_rank = 0 if sep is None else sep.rank

    def forward(self, input_ids, position_ids=None, generator=None):
        x = self.word_embeddings(input_ids)
        if position_ids is None:
            s = input_ids.shape[1]
            position_ids = torch.arange(self.sep_rank * s,
                                        (self.sep_rank + 1) * s,
                                        device=input_ids.device)[None, :]
        x = x + self.position_embeddings(position_ids)
        return self.dropout(x, generator)


class GPTModel(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, generator: torch.Generator,
                 mp_group=None):
        super().__init__()
        self.config = cfg
        self.embeddings = GPTEmbeddings(cfg, generator, mp_group)
        self.layers = torch.nn.ModuleList(
            [GPTDecoderLayer(cfg, generator, mp_group)
             for _ in range(cfg.num_layers)])
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon,
                                  generator=generator)
        self.use_recompute = cfg.use_recompute
        # the attention's own dropout stream, replayed by recompute too
        self.replay_generators: tuple = ()

    def forward(self, input_ids, position_ids=None, generator=None):
        x = self.embeddings(input_ids, position_ids, generator)
        for layer in self.layers:
            if self.use_recompute:
                x = recompute(layer, x, generator=generator,
                              replay_generators=self.replay_generators)
            else:
                x = layer(x, generator)
        return self.final_ln(x)


class GPTForCausalLM(torch.nn.Module):
    """GPT with the LM head tied to the word embedding.

    Parameters are drawn from ``generator``, on its device, in f32.
    """

    def __init__(self, cfg: GPTConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        # None without fleet: the unsharded model
        self.mp_group = mp_group_of()
        self.gpt = GPTModel(cfg, generator, self.mp_group)

    def set_attention_generator(self, generator: Optional[torch.Generator]
                                ) -> None:
        """Attention dropout draws from ``generator`` (None: from the one
        passed to ``forward``), recompute replays it."""
        for layer in self.gpt.layers:
            layer.attn.attn_generator = generator
        self.gpt.replay_generators = () if generator is None else \
            (generator,)

    def forward(self, input_ids, position_ids=None, generator=None):
        x = self.gpt(input_ids, position_ids, generator)
        return self._head(x)

    def _head(self, x):
        w = self.gpt.embeddings.word_embeddings.weight
        if self.mp_group is not None:
            x = _c_identity(x, self.mp_group)
        return torch.matmul(x, w.t())

    # -- pipeline parallelism ----------------------------------------------
    def pipeline_blocks(self):
        """The decoder stack: each block's parameter prefix, and one
        block (the JAX model's adapter)."""
        n = len(self.gpt.layers)
        return [f"gpt.layers.{i}." for i in range(n)], self.gpt.layers[0]

    def chunk_blocks(self, k: int, chunks: int) -> range:
        """The blocks of virtual stage ``k`` of ``chunks``."""
        n = self.config.num_layers
        if n % chunks:
            raise ValueError(f"{n} blocks do not split into {chunks} "
                             f"pipeline stages")
        per = n // chunks
        return range(k * per, (k + 1) * per)

    def keep_stage(self, pp: int, stage: int, virtual_stages: int = 1
                   ) -> "GPTForCausalLM":
        """Keep what rank ``stage`` of ``pp`` runs, in place: the blocks of
        its virtual stages ``{g * pp + stage}``, the embeddings on the
        first stage, ``final_ln`` on the last, the word embedding on both
        (the tied head).  Names stay the whole model's."""
        chunks = pp * virtual_stages
        self.pipeline = (pp, stage, virtual_stages)
        keep = {i for g in range(virtual_stages)
                for i in self.chunk_blocks(g * pp + stage, chunks)}
        for i in range(len(self.gpt.layers)):
            if i not in keep:
                self.gpt.layers[i] = _Absent()
        first, last = stage == 0, stage == pp - 1
        emb = self.gpt.embeddings
        if not first:
            emb.position_embeddings = _Absent()
        if not (first or last):
            emb.word_embeddings = _Absent()
        if not last:
            self.gpt.final_ln = _Absent()
        return self

    def forward_chunk(self, k: int, x, generator=None):
        """Virtual stage ``k`` (of :meth:`keep_stage`'s ``pp * v``) on
        ``x``: token ids for the first, hidden states otherwise; the last
        returns the logits."""
        pp, _, v = self.pipeline
        gpt = self.gpt
        if k == 0:
            x = gpt.embeddings(x, None, generator)
        for i in self.chunk_blocks(k, pp * v):
            layer = gpt.layers[i]
            if gpt.use_recompute:
                x = recompute(layer, x, generator=generator,
                              replay_generators=gpt.replay_generators)
            else:
                x = layer(x, generator)
        if k == pp * v - 1:
            return self._head(gpt.final_ln(x))
        return x


class _Absent(torch.nn.Module):
    """A part of the model another pipeline stage holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this part of the model is on another pipeline "
                           "stage")


class GPTPretrainingCriterion(torch.nn.Module):
    """Mean causal-LM loss over every token, in the logits' dtype, or
    with ``loss_mask`` the masked mean in f32, ``sum(loss * mask) /
    max(sum(mask), 1e-6)``; over vocabulary-local logits on ``mp_group``
    (by default fleet's, as for the model: pass the model's
    ``mp_group``).  ``cfg`` is the reference's first argument and is not
    read."""

    def __init__(self, cfg: Optional[GPTConfig] = None, *, mp_group=None):
        super().__init__()
        self.ce = ParallelCrossEntropy(mp_group=mp_group)

    def forward(self, logits, labels, loss_mask=None):
        loss = self.ce(logits, labels).reshape(-1)
        if loss_mask is None:
            return loss.mean()
        m = loss_mask.reshape(-1).to(torch.float32)
        return (loss * m).sum() / m.sum().clamp_min(1e-6)


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_attention_heads=4, max_position_embeddings=128, **kw)


def gpt_345m(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_layers=24, num_attention_heads=16,
                     **kw)


def gpt_1p3b(**kw) -> GPTConfig:
    """GPT-3 1.3B: hidden 2048, 24 layers, 16 heads of 128."""
    return GPTConfig(hidden_size=2048, num_layers=24, num_attention_heads=16,
                     **kw)


def gpt_6p7b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=4096, num_layers=32, num_attention_heads=32,
                     **kw)


def gpt_13b(**kw) -> GPTConfig:
    return GPTConfig(hidden_size=5120, num_layers=40, num_attention_heads=40,
                     **kw)


def _as_numpy(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":   # bf16 from ml_dtypes: widen exactly
        a = a.astype(np.float32)
    return a


def params_from_numpy(model: torch.nn.Module,
                      arrays: Dict[str, np.ndarray], *, mp_rank: int = 0,
                      mp_degree: int = 1) -> torch.nn.Module:
    """Copy ``arrays`` (the JAX model's parameters as numpy arrays, by
    name) into ``model`` in place, cast to each parameter's dtype and
    device.  A tensor-parallel shard (``mp_rank`` of ``mp_degree``) takes
    its slice of each split parameter's array along the parameter's
    ``split_axis``.  Names must match exactly and shapes must agree;
    raises ``ValueError`` otherwise.  Returns ``model``."""
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(arrays))
    extra = sorted(set(arrays) - set(named))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"unexpected {extra}")
    if not 0 <= mp_rank < mp_degree:
        raise ValueError(f"mp_rank {mp_rank} of mp_degree {mp_degree}")
    loaded = {}
    for name, p in named.items():
        a = _as_numpy(arrays[name])
        axis = getattr(p, "split_axis", None)
        if axis is not None and mp_degree > 1:
            if a.shape[axis] % mp_degree:
                raise ValueError(f"{name}: axis {axis} of {a.shape} does not "
                                 f"split into {mp_degree}")
            a = np.split(a, mp_degree, axis=axis)[mp_rank]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not "
                             f"match the model's {tuple(p.shape)}")
        loaded[name] = torch.from_numpy(np.array(a))
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(loaded[name])
    return model



def split_axes(model: torch.nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's tensor-parallel split axis (None when whole)."""
    return {n: getattr(p, "split_axis", None)
            for n, p in model.named_parameters()}


def gather_params(shards: Sequence[Dict[str, np.ndarray]],
                  axes: Dict[str, Optional[int]]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`'s slicing: whole arrays
    from the shards of every model-parallel rank (``shards[r]``: rank
    ``r``'s parameters by name), each split parameter concatenated along
    its axis (``axes``, :func:`split_axes`), a whole one taken from rank
    0."""
    out: Dict[str, np.ndarray] = {}
    for name, axis in axes.items():
        parts: List[np.ndarray] = [np.asarray(s[name]) for s in shards]
        out[name] = parts[0] if axis is None else np.concatenate(parts, axis)
    return out
