"""The analytic cost of a parallel training configuration (the
counterpart of ``paddle_tpu/cost_model/parallel_cost.py``): step time
and memory a card of a transformer's training on a
:class:`~..distributed.auto_parallel.cluster.Cluster`.  It ranks
candidates and prunes those that cannot fit; it is not a timer.

The model (a dict): ``n_params``, ``num_layers``, ``hidden_size``,
``seq_len``, optionally ``vocab_size``.  The configuration (a dict):
``dp_degree``, ``mp_degree``, ``pp_degree``, ``sharding_degree``,
``micro_batch_size``, ``use_recompute``, ``global_batch_size``.

The formulas are the JAX package's.  Only the efficiency differs: the
share of the peak rate a well-fed step reaches, ``_MFU_EFF``, is the
port's own headline step's (PERF.md §5: GPT-345m at 8 x 1024, no
recompute, the fusion pass on, one CUDA graph step in 78.96 ms on an
NVIDIA H100 80GB HBM3 at 700 W).  With this module's count of a token's
work, ``6 N + 6 L S H`` (N = 354,871,296 parameters: the 50304 x 1024
word and 1024 x 1024 position embeddings, 24 blocks of ``12 H^2 + 13
H``, the final LayerNorm), 8192 tokens take 1.8677e16 FLOP, and
1.8677e16 / (0.07896 s x 989e12 FLOP/s) = 0.239.
"""
from __future__ import annotations

__all__ = ["predict_step_time", "predict_memory_bytes", "predict"]

#: the share of the peak rate the port's headline step reaches (above)
_MFU_EFF = 0.239
# bytes of saved activation per token per layer (bf16); with full
# recompute only the layer inputs survive
_ACT_BYTES_FULL = 34.0
_ACT_BYTES_REMAT = 4.0


def _deg(cfg, key):
    v = cfg.get(key)
    return int(v) if v else 1


def predict_memory_bytes(model, cfg, cluster, global_batch_size=None):
    """Bytes a card: bf16 parameters and gradients, the AdamW moments and
    the f32 master (over the sharding degree), and the activations of
    the micro-batches a pipeline stage keeps in flight
    (``min(pp, micro_steps)``), with the head's logits when
    ``vocab_size`` is given."""
    n = float(model["n_params"])
    L = int(model.get("num_layers", 1))
    H = int(model.get("hidden_size", 1))
    S = int(model.get("seq_len", 1))
    V = int(model.get("vocab_size", 0))
    dp, mp = _deg(cfg, "dp_degree"), _deg(cfg, "mp_degree")
    pp, shard = _deg(cfg, "pp_degree"), _deg(cfg, "sharding_degree")
    mbs = int(cfg.get("micro_batch_size") or 1)
    remat = bool(cfg.get("use_recompute", False))
    gbs = global_batch_size or cfg.get("global_batch_size")
    micro_steps = max(int(gbs) // max(dp * shard * mbs, 1), 1) if gbs \
        else pp
    in_flight = min(pp, micro_steps)

    n_local = n / (mp * pp)
    weights = n_local * 2 + n_local * 2
    opt = n_local * 12 / max(shard, 1)
    act_per_tok = _ACT_BYTES_REMAT if remat else _ACT_BYTES_FULL
    acts = mbs * S * H * (L / pp) / mp * act_per_tok * in_flight
    if V:
        acts += mbs * S * V * 6.0 / mp
    return weights + opt + acts


def predict_step_time(model, cfg, cluster, global_batch_size=None):
    """Seconds an optimizer step on ``cluster``: the work at
    ``_MFU_EFF`` of the peak rate over the cards, the pipeline's bubble,
    and the tensor-parallel, data-parallel and pipeline transfers at
    the cluster's bandwidth for each group."""
    n = float(model["n_params"])
    L = int(model.get("num_layers", 1))
    H = int(model.get("hidden_size", 1))
    S = int(model.get("seq_len", 1))
    dp, mp = _deg(cfg, "dp_degree"), _deg(cfg, "mp_degree")
    pp, shard = _deg(cfg, "pp_degree"), _deg(cfg, "sharding_degree")
    mbs = int(cfg.get("micro_batch_size") or 1)
    remat = bool(cfg.get("use_recompute", False))
    gbs = int(global_batch_size or cfg.get("global_batch_size")
              or dp * shard * mbs)
    data_par = dp * shard
    micro_steps = max(gbs // max(data_par * mbs, 1), 1)

    flops_tok = 6.0 * n + 6.0 * L * S * H
    if remat:
        flops_tok *= 4.0 / 3.0
    tokens_step = gbs * S
    compute = (flops_tok * tokens_step
               / (cluster.peak_flops * _MFU_EFF)
               / max(data_par * mp * pp, 1))
    compute *= 1.0 + (pp - 1) / float(micro_steps)

    comm = 0.0
    if mp > 1:
        act_bytes = 2.0 * mbs * S * H
        comm += (4.0 * (L / pp) * act_bytes * (mp - 1) / mp
                 * micro_steps / cluster.bandwidth(mp))
    if data_par > 1:
        grad_bytes = 2.0 * n / (mp * pp)
        comm += (2.0 * grad_bytes * (data_par - 1) / data_par
                 / cluster.bandwidth(data_par))
    if pp > 1:
        comm += (2.0 * mbs * S * H * (pp - 1) * micro_steps
                 / cluster.bandwidth(pp))
    return compute + comm


def predict(model, cfg, cluster, global_batch_size=None):
    """``(seconds_per_step, memory_bytes_per_card, fits)``; it fits when
    the memory is at most 0.92 of the card's (the runtime's reserve)."""
    t = predict_step_time(model, cfg, cluster, global_batch_size)
    m = predict_memory_bytes(model, cfg, cluster, global_batch_size)
    return t, m, m <= cluster.hbm_bytes * 0.92
