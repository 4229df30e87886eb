"""The port's auto-tuner against the JAX package's, on the CPU: the same
search sequence without a model; with a model and the same explicit
cluster, the same pruned set and predicted memory bytes and the order of
the port's own step-time prediction; the prune rules case by case; the
recorder's CSV byte for byte (mirrors ``tests/test_elastic_autotuner.py``
``TestAutoTuner`` and ``tests/test_cost_model_tuner.py``)."""
import itertools

import pytest

from paddle_tpu.distributed import auto_tuner as jat
from paddle_tpu.distributed.auto_parallel import Cluster as JCluster
from paddle_tpu_torch.cost_model import parallel_cost as tcost
from paddle_tpu_torch.distributed import auto_tuner as tat
from paddle_tpu_torch.distributed.auto_parallel.cluster import \
    Cluster as TCluster

GRID = {
    "candidates": {
        "dp_degree": [1, 2, 4, 8],
        "mp_degree": [1, 2, 4],
        "pp_degree": [1, 2],
        "micro_batch_size": [1, 2, 4],
        "sharding_degree": [1],
        "sharding_stage": [None],
        "use_recompute": [False, True],
        "recompute_granularity": [None],
    },
    "num_chips": 8,
    "global_batch_size": 16,
}
MODEL = dict(n_params=1.3e9, num_layers=24, hidden_size=2048, seq_len=1024)
CLUSTER = dict(num_chips=8, device_kind="NVIDIA H100", peak_flops=989e12,
               hbm_bytes=16 << 30, ici_bandwidth=400e9)
COST_GRID = {
    "candidates": {"dp_degree": [1, 2, 4, 8], "mp_degree": [1, 2, 4],
                   "pp_degree": [1, 2], "sharding_degree": [1, 2],
                   "micro_batch_size": [2, 4, 8, 32],
                   "use_recompute": [False, True]},
    "num_chips": 8, "global_batch_size": 64,
}


def _drain(tuner, status=None):
    seen = []
    while (cfg := tuner.search_once()) is not None:
        seen.append(cfg)
        if status is not None:
            tuner.add_cfg(**cfg, **status(cfg))
    return seen


def test_search_sequence_matches_jax_without_a_model():
    seen = _drain(tat.AutoTuner(GRID))
    assert seen == _drain(jat.AutoTuner(GRID))
    assert seen and all(
        c["dp_degree"] * c["mp_degree"] * c["pp_degree"] == 8 and
        (16 // c["dp_degree"]) % c["micro_batch_size"] == 0 for c in seen)


def _oom_above_2(cfg):
    if cfg["micro_batch_size"] >= 4:
        return {"throughput": None, "status": "oom"}
    return {"throughput": 100 * cfg["micro_batch_size"], "status": "ok"}


def test_history_pruning_and_best_match_jax():
    t, j = tat.AutoTuner(GRID), jat.AutoTuner(GRID)
    assert _drain(t, _oom_above_2) == _drain(j, _oom_above_2)
    assert t.recorder.history == j.recorder.history
    assert t.get_best() == j.get_best()
    best, err = t.get_best()
    assert not err and best["status"] == "ok" and best["throughput"] == max(
        c["throughput"] or 0 for c in t.recorder.history)
    assert t.cur_task_id == j.cur_task_id
    assert t.search_space_size() == j.search_space_size()


def test_cost_model_prunes_the_jax_set_with_the_jax_bytes():
    tcfg = dict(COST_GRID, model=MODEL, cluster=TCluster(**CLUSTER))
    jcfg = dict(COST_GRID, model=MODEL, cluster=JCluster(**CLUSTER))
    t, j = tat.AutoTuner(tcfg), jat.AutoTuner(jcfg)
    assert t.pruned_by_cost == j.pruned_by_cost > 0
    key = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
           "micro_batch_size", "use_recompute")

    def kept(tuner):
        return {tuple(c[k] for k in key): c["predicted_memory_bytes"]
                for c in tuner.algo.all_cfgs}
    assert kept(t) == kept(j)
    # the port's order is its own prediction's, best first
    times = [c["predicted_step_time"] for c in t.algo.all_cfgs]
    assert times == sorted(times)
    for c in t.algo.all_cfgs:
        pt, pm, fits = tcost.predict(MODEL, c, t.cluster,
                                     global_batch_size=64)
        assert fits and c["predicted_step_time"] == round(pt, 6)
        assert c["predicted_memory_bytes"] == int(pm)
    # a dict cluster is the same cluster
    assert kept(tat.AutoTuner(dict(COST_GRID, model=MODEL,
                                   cluster=dict(CLUSTER)))) == kept(t)


def test_cost_model_refuses_an_empty_search():
    tiny = dict(CLUSTER, hbm_bytes=1 << 20)
    for mod, cls in ((tat, TCluster), (jat, JCluster)):
        with pytest.raises(ValueError, match="too big"):
            mod.AutoTuner(dict(COST_GRID, model=MODEL, cluster=cls(**tiny)))


def test_auto_detect_cluster_on_the_cpu():
    t = tat.AutoTuner({"candidates": {"micro_batch_size": [1]},
                       "model": dict(MODEL, n_params=1e6)})
    assert t.cluster.device_kind == "cpu"


def test_unknown_search_algo_raises():
    with pytest.raises(ValueError, match="unknown search_algo"):
        tat.AutoTuner({"search_algo": "random"})


_CASES = [
    ({"num_chips": 8}, {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}),
    ({"num_chips": 8}, {"dp_degree": 2, "mp_degree": 2}),
    ({"num_gpus": 4}, {"dp_degree": 2, "sharding_degree": 2}),
    ({"num_chips": None}, {"dp_degree": 3}),
    ({"max_mp_degree": 4}, {"mp_degree": 8}),
    ({"max_mp_degree": 4}, {"mp_degree": 4}),
    ({"global_batch_size": 16}, {"dp_degree": 3, "micro_batch_size": 1}),
    ({"global_batch_size": 16}, {"dp_degree": 2, "micro_batch_size": 3}),
    ({"global_batch_size": 16}, {"dp_degree": 2, "sharding_degree": 2,
                                 "micro_batch_size": 4}),
    ({}, {"sharding_stage": 2, "sharding_degree": 1}),
    ({}, {"sharding_stage": 2, "sharding_degree": 2}),
    ({}, {"use_recompute": False, "recompute_granularity": "full"}),
    ({}, {"use_recompute": False, "recompute_granularity": "none"}),
    ({}, {"use_recompute": True, "recompute_granularity": "full"}),
]


@pytest.mark.parametrize("i", range(len(_CASES)))
def test_each_prune_rule_matches_jax(i):
    tuner_cfg, cur = _CASES[i]
    for rule_t, rule_j in zip(tat.PRUNE_RULES, jat.PRUNE_RULES):
        assert rule_t.__name__ == rule_j.__name__
        assert rule_t(tuner_cfg, cur, []) == rule_j(tuner_cfg, cur, [])
    assert tat.prune_by_rules(tuner_cfg, cur) == jat.prune_by_rules(
        tuner_cfg, cur)


def test_history_oom_rule_case_by_case():
    oom = {"micro_batch_size": 2, "mp_degree": 2, "pp_degree": 1,
           "sharding_degree": 1, "use_recompute": False, "status": "oom"}
    grid = itertools.product([1, 2, 4], [1, 2, 4], [1, 2], [1, 2],
                             [False, True])
    pruned = 0
    for mbs, mp, pp, sh, rc in grid:
        cur = {"micro_batch_size": mbs, "mp_degree": mp, "pp_degree": pp,
               "sharding_degree": sh, "use_recompute": rc}
        for history in ([oom], [dict(oom, status="ok")],
                        [dict(oom, use_recompute=True)]):
            got = tat.prune_by_rules({}, cur, history)
            assert got == jat.prune_by_rules({}, cur, history)
            pruned += got
    assert pruned > 0
    assert tat.prune_by_rules({}, {"micro_batch_size": 4, "mp_degree": 1},
                              [oom])
    assert not tat.prune_by_rules({}, {"micro_batch_size": 1,
                                       "mp_degree": 1}, [oom])


def test_a_registered_rule_joins_the_search():
    n = len(tat.PRUNE_RULES)

    @tat.register_prune
    def no_pp(tuner_cfg, cur_cfg, history):
        return (cur_cfg.get("pp_degree") or 1) > 1
    try:
        seen = _drain(tat.AutoTuner(GRID))
        assert seen and all(c["pp_degree"] == 1 for c in seen)
    finally:
        tat.PRUNE_RULES.remove(no_pp)
    assert len(tat.PRUNE_RULES) == n


def test_recorder_csv_is_the_jax_bytes(tmp_path):
    rows = [dict(dp_degree=2, throughput=10.5, status="ok",
                 use_recompute=False),
            dict(dp_degree=4, throughput=None, status="oom",
                 recompute_granularity="full"),
            dict(dp_degree=8, throughput=20.0, status="ok",
                 predicted_step_time=0.123456, predicted_memory_bytes=7)]
    t, j = tat.HistoryRecorder(), jat.HistoryRecorder()
    for r in rows:
        t.add_cfg(**r)
        j.add_cfg(**r)
    tp, jp = tmp_path / "t" / "h.csv", tmp_path / "j" / "h.csv"
    t.store_history(str(tp))
    j.store_history(str(jp))
    assert tp.read_bytes() == jp.read_bytes()
    back_t, back_j = tat.HistoryRecorder(), jat.HistoryRecorder()
    assert back_t.load_history(str(tp)) == back_j.load_history(str(jp))
    assert back_t.get_best() == back_j.get_best()
    assert back_t.get_best()[0]["throughput"] == 20.0
    oom = [r for r in back_t.history if r["dp_degree"] == 4]
    assert oom[0]["throughput"] is None and oom[0]["use_recompute"] is None
    assert tat.HistoryRecorder().load_history(str(tmp_path / "no")) == (
        [], True)
    tat.HistoryRecorder().store_history(str(tmp_path / "none.csv"))
    assert not (tmp_path / "none.csv").exists()
    low = tat.HistoryRecorder(metric="step_time", maximize=False)
    low.add_cfg(step_time=2.0)
    low.add_cfg(step_time=1.0)
    assert low.get_best() == ({"step_time": 1.0}, False)
