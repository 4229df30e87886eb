"""``DistributedStrategy``: fleet's tree of switches (the counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``).

The attribute names and defaults are the reference's.  A dict-valued
config merges into its defaults and rejects unknown keys.  What the port
reads: ``hybrid_configs`` (the degrees, :func:`..fleet.hybrid_degrees`),
``fuse_all_reduce_ops`` and ``fuse_grad_size_in_MB`` (the buckets of
:class:`...parallel.DataParallel`), ``amp`` with ``amp_configs``'
``use_bf16`` (O2 in bf16) and ``recompute`` (``fleet.distributed_model``),
``sharding`` with ``sharding_configs``' ``stage`` (1: ZeRO ``os``, 2:
``os_g``; ``fleet.distributed_optimizer``), ``pipeline_configs``'
``accumulate_steps`` (the micro-batches) and ``virtual_pp_degree``.
``sharding_configs``' ``offload`` and ``comm_overlap`` are accepted and
not read (the port keeps no state on the host, and its reduction runs
after the backward pass).  The rest are kept so that strategy code
carries over; the sequence-parallel degree waits for its slice
(``fleet.init`` refuses it above 1).
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]

_HYBRID_DEFAULTS = {
    "dp_degree": 1, "mp_degree": 1, "pp_degree": 1, "sharding_degree": 1,
    "sep_degree": 1, "order": ["dp", "pp", "sharding", "sep", "mp"],
}


class DistributedStrategy:
    def __init__(self):
        # collective / hybrid
        self.hybrid_configs = dict(_HYBRID_DEFAULTS)
        # AMP
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0, "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0,
            "decr_ratio": 0.5, "use_dynamic_loss_scaling": True,
            "custom_white_list": [], "custom_black_list": [],
            "use_pure_fp16": False, "use_fp16_guard": True,
            "use_bf16": True,
        }
        # recompute
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        # sharding (ZeRO)
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 8,
                                 "offload": False,
                                 "comm_overlap": True}
        # pipeline
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B",
                                 "virtual_pp_degree": 1,
                                 "overlap_p2p_comm": None}
        # gradient merge
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        # the buckets of the data-parallel reduction
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        # kept for parity
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = False
        self.find_unused_parameters = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.a_sync = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = True

    def __setattr__(self, key, value):
        cur = self.__dict__.get(key)
        if isinstance(cur, dict) and isinstance(value, dict):
            unknown = set(value) - set(cur)
            if unknown:
                raise ValueError(f"unknown {key} keys: {sorted(unknown)}")
            cur.update(value)
        else:
            object.__setattr__(self, key, value)

    def __repr__(self):
        rows = [f"  {k}={v!r}" for k, v in sorted(self.__dict__.items())]
        return "DistributedStrategy(\n" + "\n".join(rows) + "\n)"
