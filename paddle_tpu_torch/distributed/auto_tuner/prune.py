"""Prune rules (the counterpart of
``paddle_tpu/distributed/auto_tuner/prune.py``; the reference's
``auto_tuner/prune.py`` registry): each rule takes (tuner_cfg, cur_cfg,
history) and returns True to prune the candidate."""
from __future__ import annotations

__all__ = ["register_prune", "prune_by_rules", "PRUNE_RULES"]

PRUNE_RULES = []


def register_prune(fn):
    PRUNE_RULES.append(fn)
    return fn


def prune_by_rules(tuner_cfg, cur_cfg, history_cfgs=None):
    history_cfgs = history_cfgs or []
    return any(rule(tuner_cfg, cur_cfg, history_cfgs)
               for rule in PRUNE_RULES)


@register_prune
def prune_by_num_chips(tuner_cfg, cur_cfg, history):
    """dp * mp * pp * sharding must be the number of cards
    (``num_gpus`` or ``num_chips``)."""
    n = tuner_cfg.get("num_gpus") or tuner_cfg.get("num_chips")
    if n is None:
        return False
    degree = 1
    for k in ("dp_degree", "mp_degree", "pp_degree", "sharding_degree"):
        v = cur_cfg.get(k)
        if v:
            degree *= v
    return degree != n


@register_prune
def prune_by_mp_bound(tuner_cfg, cur_cfg, history):
    """mp above ``max_mp_degree`` (one host's cards: beyond it tensor
    parallelism crosses the slower network)."""
    mp = cur_cfg.get("mp_degree")
    bound = tuner_cfg.get("max_mp_degree")
    return bound is not None and mp is not None and mp > bound


@register_prune
def prune_by_micro_batch(tuner_cfg, cur_cfg, history):
    """The global batch must split into dp * sharding * micro_batch."""
    gbs = tuner_cfg.get("global_batch_size")
    mbs = cur_cfg.get("micro_batch_size")
    if gbs is None or mbs is None:
        return False
    dp = (cur_cfg.get("dp_degree") or 1) * (cur_cfg.get("sharding_degree")
                                            or 1)
    if gbs % dp != 0:
        return True
    per = gbs // dp
    return per % mbs != 0


@register_prune
def prune_by_sharding_stage(tuner_cfg, cur_cfg, history):
    """A sharding stage above 0 needs sharding_degree above 1."""
    stage = cur_cfg.get("sharding_stage")
    deg = cur_cfg.get("sharding_degree") or 1
    return bool(stage) and stage > 0 and deg <= 1


@register_prune
def prune_by_recompute(tuner_cfg, cur_cfg, history):
    """A recompute granularity means something only with recompute on."""
    use = cur_cfg.get("use_recompute")
    gran = cur_cfg.get("recompute_granularity")
    return use is False and gran not in (None, "none")


@register_prune
def prune_by_history_oom(tuner_cfg, cur_cfg, history):
    """A candidate that needs at least the memory a card of a trial that
    ran out of memory needed: no smaller micro-batch, no more splitting
    on any axis that saves memory (mp, pp, sharding) and no recompute
    the failed trial lacked."""
    for h in history:
        if h.get("status") != "oom":
            continue
        cur_r = bool(cur_cfg.get("use_recompute", False))
        h_r = bool(h.get("use_recompute", False))
        if (cur_cfg.get("micro_batch_size") or 0) >= \
                (h.get("micro_batch_size") or 0) and \
                (cur_cfg.get("mp_degree") or 1) <= (h.get("mp_degree") or 1) \
                and (cur_cfg.get("pp_degree") or 1) <= \
                (h.get("pp_degree") or 1) \
                and (cur_cfg.get("sharding_degree") or 1) <= \
                (h.get("sharding_degree") or 1) \
                and ((not cur_r) or h_r):
            return True
    return False
