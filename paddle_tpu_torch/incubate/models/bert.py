"""BERT encoder, pretraining heads and criterion (the counterpart of
``paddle_tpu/incubate/models/bert.py``).

Parameter names and layouts are the JAX model's
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.0.attention.qkv.weight`` ``(hidden, 3 * hidden)``,
``mlm_bias``, ...), so its weights load by name
(:func:`.gpt.params_from_numpy`).  What the JAX model computes, kept
here:

 - word + position + token-type embeddings, LayerNorm, dropout;
 - post-LN blocks: ``ln1(x, residual=attention(x))`` and
   ``ln2(x, residual=dropout(fc2(gelu(fc1(x)))))``, the residual added
   inside the LayerNorm kernels; erf GELU; the QKV projection's output
   reshapes to ``(B, T, 3, heads, head_dim)``;
 - a ``(B, T)`` padding mask becomes the additive ``(m - 1) * 1e4`` in
   f32, added to the scores in their dtype; with a mask attention takes
   the plain branch at every length, without one the flash kernels from
   ``FLASH_MIN_SEQ`` on;
 - the pooler ``tanh(W x[:, 0] + b)``; the MLM head ``gelu`` transform,
   LayerNorm and the decoder tied to the word embedding
   (``h @ word_embeddings.weight.T + mlm_bias``); the NSP head on the
   pooled output;
 - the criterion: the MLM cross-entropy over all ``B * T`` rows (labels
   ``-100`` count 0), a weighted mean with ``masked_lm_weights``, plus
   the NSP cross-entropy, both through ``F.cross_entropy``'s hard-label
   route (the fused softmax cross-entropy kernels).

Weights are drawn from the generator passed at construction, in the JAX
package's families (Xavier-normal matrices and tables, zero biases,
LayerNorm at 1 and 0); every dropout draws from the generator passed to
``forward``.
"""
from __future__ import annotations

import dataclasses

import torch

from ...distributed.fleet import recompute
from ...nn import Dropout, Embedding, LayerNorm, Linear
from ...nn import functional as F
from ...nn.initializer import Constant, XavierNormal

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "BertPretrainingCriterion",
           "additive_attention_mask", "bert_tiny", "bert_base",
           "bert_large"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30528          # 30522 padded to a multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12


def _linear(n_in, n_out, generator):
    return Linear(n_in, n_out, XavierNormal(), generator=generator)


class BertEmbeddings(torch.nn.Module):
    """word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: BertConfig, generator: torch.Generator):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, h, XavierNormal(),
                                         generator=generator)
        self.position_embeddings = Embedding(
            cfg.max_position_embeddings, h, XavierNormal(),
            generator=generator)
        self.token_type_embeddings = Embedding(
            cfg.type_vocab_size, h, XavierNormal(), generator=generator)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps,
                                    generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                generator=None):
        seq_len = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq_len,
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros((1, seq_len), dtype=torch.long,
                                         device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb), generator)


class BertSelfAttention(torch.nn.Module):
    def __init__(self, cfg: BertConfig, generator: torch.Generator):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.qkv = _linear(h, 3 * h, generator)
        self.out = _linear(h, h, generator)
        self.attn_drop = cfg.attention_probs_dropout_prob
        self.proj_drop = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attention_mask=None, generator=None):
        b, t, h = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask, dropout_p=self.attn_drop,
            is_causal=False, training=self.training, generator=generator)
        return self.proj_drop(self.out(ctx.reshape(b, t, h)), generator)


class BertLayer(torch.nn.Module):
    """Post-LN transformer block (BERT's convention)."""

    def __init__(self, cfg: BertConfig, generator: torch.Generator):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, generator)
        self.ln1 = LayerNorm(h, eps, generator=generator)
        self.fc1 = _linear(h, cfg.intermediate_size, generator)
        self.fc2 = _linear(cfg.intermediate_size, h, generator)
        self.ln2 = LayerNorm(h, eps, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attention_mask=None, generator=None):
        x = self.ln1(x, residual=self.attention(x, attention_mask,
                                                generator))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x, residual=self.dropout(h, generator))


def additive_attention_mask(attention_mask):
    """A ``(B, T)`` padding mask (1 keep, 0 pad) becomes the additive f32
    ``(B, 1, 1, T)`` mask ``(m - 1) * 1e4``; any other mask passes as it
    is (shared with the JAX package's ERNIE encoder)."""
    if attention_mask is not None and attention_mask.dim() == 2:
        m = attention_mask.float()
        return (m - 1.0)[:, None, None, :] * 1e4
    return attention_mask


def run_encoder(layers, x, attention_mask, use_recompute, training,
                generator=None):
    """The encoder stack, each block recomputed in the backward pass when
    ``use_recompute`` and training."""
    for layer in layers:
        if use_recompute and training:
            x = recompute(layer, x, attention_mask, generator=generator)
        else:
            x = layer(x, attention_mask, generator)
    return x


class BertModel(torch.nn.Module):
    def __init__(self, cfg: BertConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, generator)
        self.encoder = torch.nn.ModuleList(
            [BertLayer(cfg, generator) for _ in range(cfg.num_layers)])
        self.pooler = _linear(cfg.hidden_size, cfg.hidden_size, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, generator=None):
        attention_mask = additive_attention_mask(attention_mask)
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            generator)
        x = run_encoder(self.encoder, x, attention_mask,
                        getattr(self.cfg, "use_recompute", False),
                        self.training, generator)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(torch.nn.Module):
    """The SST-2-style finetune head on the pooled output."""

    def __init__(self, cfg: BertConfig, num_classes=2, *,
                 generator: torch.Generator):
        super().__init__()
        self.bert = BertModel(cfg, generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = _linear(cfg.hidden_size, num_classes, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask,
                              generator=generator)
        return self.classifier(self.dropout(pooled, generator))


class BertForPretraining(torch.nn.Module):
    """The MLM and NSP heads; returns ``(mlm_logits (B, T, V),
    nsp_logits (B, 2))``.  Parameters are drawn from ``generator``, on
    its device, in f32."""

    def __init__(self, cfg: BertConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.bert = BertModel(cfg, generator)
        self.mlm_transform = _linear(cfg.hidden_size, cfg.hidden_size,
                                     generator)
        self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                generator=generator)
        self.mlm_bias = torch.nn.Parameter(
            Constant(0.0)((cfg.vocab_size,), generator))
        self.nsp = _linear(cfg.hidden_size, 2, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask,
                                generator=generator)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq)))
        # the decoder tied to the word embedding
        w = self.bert.embeddings.word_embeddings.weight
        mlm_logits = F.linear(h, w.t(), self.mlm_bias)
        return mlm_logits, self.nsp(pooled)


class BertPretrainingCriterion(torch.nn.Module):
    """MLM loss over every position plus the NSP loss, f32."""

    def forward(self, mlm_logits, nsp_logits, masked_lm_labels,
                next_sentence_labels, masked_lm_weights=None):
        mlm = F.cross_entropy(mlm_logits.reshape(-1, mlm_logits.shape[-1]),
                              masked_lm_labels.reshape(-1),
                              reduction="none")
        if masked_lm_weights is not None:
            w = masked_lm_weights.reshape(-1).float()
            mlm = (mlm * w).sum() / (w.sum() + 1e-6)
        else:
            mlm = mlm.mean()
        nsp = F.cross_entropy(nsp_logits, next_sentence_labels)
        return mlm + nsp


def bert_tiny(**kw) -> BertConfig:
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_attention_heads=2, intermediate_size=128,
                      max_position_embeddings=128, **kw)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large(**kw) -> BertConfig:
    return BertConfig(hidden_size=1024, num_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)
