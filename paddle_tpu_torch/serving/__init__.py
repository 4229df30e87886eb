"""Serving engine of the port: bucketed steps over a paged KV cache,
continuous batching, stdlib HTTP front end; on a CUDA device the decode
attention and the int8 products run as hand-written kernels.

Quick start::

    from paddle_tpu_torch.serving import (ModelSpec, ServeConfig,
                                          ServingEngine, init_params)

    spec = ModelSpec(vocab_size=512, hidden=64, layers=2, heads=4)
    engine = ServingEngine(spec, init_params(spec), ServeConfig.from_env())
    tokens = engine.generate([[5, 9, 2]], max_new_tokens=8)[0]

Both run on ``cuda`` unless ``device="cpu"`` is passed.

Module map: :mod:`.model` (decoder step functions over paged KV),
:mod:`.kv_cache` (page allocator + admission reservations),
:mod:`.engine` (bucket ladder, warm-up, weight swap, served-model
directories, hot reload), :mod:`.scheduler` (continuous batching),
:mod:`.http` (front end), :mod:`.quant` (int8 weights, calibration,
quantized directories).
"""
from .model import (ModelSpec, init_params, params_from_numpy, prefill_step,
                    decode_step)
from .kv_cache import PagePool, KVPoolExhausted, NULL_PAGE
from .engine import (SERVE_CONFIG_NAME, ServeConfig, ServingEngine,
                     is_served_model_dir, load_engine, save_served_model)
from .scheduler import (ContinuousScheduler, GenerationStream,
                        EngineSaturated, RequestShed, RequestCancelled,
                        DeadlineExceeded, WATCHDOG_EXIT_CODE)

__all__ = [
    "ModelSpec", "init_params", "params_from_numpy", "prefill_step",
    "decode_step", "PagePool", "KVPoolExhausted", "NULL_PAGE",
    "ServeConfig", "ServingEngine", "save_served_model", "load_engine",
    "is_served_model_dir", "SERVE_CONFIG_NAME",
    "ContinuousScheduler", "GenerationStream", "EngineSaturated",
    "RequestShed", "RequestCancelled", "DeadlineExceeded",
    "WATCHDOG_EXIT_CODE",
]
