"""The tuner (the counterpart of
``paddle_tpu/distributed/auto_tuner/tuner.py``; the reference's
``auto_tuner/tuner.py`` ``AutoTuner``)."""
from __future__ import annotations

from .recorder import HistoryRecorder
from .search import GridSearch

__all__ = ["AutoTuner"]


class AutoTuner:
    """The reference's loop::

        tuner = AutoTuner({"candidates": {...}, "num_chips": 8,
                           "global_batch_size": 64})
        while (cfg := tuner.search_once()) is not None:
            metric, status = run_trial(cfg)       # the caller's
            tuner.add_cfg(**cfg, throughput=metric, status=status)
        best, _ = tuner.get_best()

    With ``model`` ({n_params, num_layers, hidden_size, seq_len}) and
    optionally ``cluster`` (a :class:`...auto_parallel.cluster.Cluster` or
    its dict; ``Cluster.auto_detect()`` otherwise) in the config, the
    analytic cost model (:mod:`....cost_model.parallel_cost`) drops the
    candidates it predicts to overflow a card's memory before any trial,
    and the rest are visited best-predicted first.  Each candidate
    carries ``predicted_step_time`` and ``predicted_memory_bytes``, so
    the recorder's history shows prediction beside measurement.  The
    memory bytes are the JAX package's; the step times are the port's
    own (its ``_MFU_EFF`` is fitted to the card's step).
    """

    def __init__(self, tuner_cfg):
        self.tuner_cfg = dict(tuner_cfg)
        algo = self.tuner_cfg.get("search_algo", "grid")
        if algo == "grid":
            self.algo = GridSearch(self.tuner_cfg)
        else:
            raise ValueError(f"unknown search_algo '{algo}'")
        self.recorder = HistoryRecorder(
            metric=self.tuner_cfg.get("metric", "throughput"),
            maximize=self.tuner_cfg.get("maximize", True))
        self.cur_task_id = 0
        self.cluster = None
        self.pruned_by_cost = 0
        model = self.tuner_cfg.get("model")
        if model is not None:
            self._apply_cost_model(model)

    def _apply_cost_model(self, model):
        from ...cost_model.parallel_cost import predict
        from ..auto_parallel.cluster import Cluster
        cluster = self.tuner_cfg.get("cluster")
        if cluster is None:
            cluster = Cluster.auto_detect()
        if isinstance(cluster, dict):
            cluster = Cluster(**cluster)
        self.cluster = cluster
        gbs = self.tuner_cfg.get("global_batch_size")
        # the static rules first: a tiling that can never run is not
        # counted as pruned by the cost model
        viable = [c for c in self.algo.all_cfgs
                  if not self.algo.prune(c, [])]
        ranked = []
        for cfg in viable:
            t, m, fits = predict(model, cfg, cluster,
                                 global_batch_size=gbs)
            if not fits:
                continue
            cfg = dict(cfg)
            cfg["predicted_step_time"] = round(t, 6)
            cfg["predicted_memory_bytes"] = int(m)
            ranked.append(cfg)
        ranked.sort(key=lambda c: c["predicted_step_time"])
        self.pruned_by_cost = len(viable) - len(ranked)
        if viable and not ranked:
            raise ValueError(
                f"cost model predicts every one of the {len(viable)} "
                f"viable configs exceeds {cluster.hbm_bytes / 2**30:.1f} "
                f"GiB HBM on {cluster.device_kind!r}: the model is too "
                f"big for this cluster/candidate grid, the search would "
                f"be empty")
        self.algo.all_cfgs = ranked
        self.algo.idx = 0

    def search_once(self):
        cfg = self.algo.search_once(self.recorder.history)
        if cfg is not None:
            self.cur_task_id += 1
        return cfg

    def add_cfg(self, **cfg):
        self.recorder.add_cfg(**cfg)

    def get_best(self):
        return self.recorder.get_best()

    def search_space_size(self):
        return len(self.algo.all_cfgs)
