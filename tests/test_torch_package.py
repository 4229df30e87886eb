"""The PyTorch port as a package: import hygiene, device rules, the page
pool, the scheduler's admission control and the HTTP front end, on the
CPU at a small width."""
import importlib.util
import json
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from paddle_tpu.distributed import exit_codes as jax_exit_codes
from paddle_tpu.serving import kv_cache as jax_kv_cache
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.distributed import exit_codes
from paddle_tpu_torch.serving import (EngineSaturated, KVPoolExhausted,
                                      ModelSpec, NULL_PAGE, PagePool,
                                      ServeConfig, ServingEngine, init_params)
from paddle_tpu_torch.serving.http import DRAIN_EXIT_CODE, ServeHTTPServer
from paddle_tpu_torch.serving.kv_cache import kv_page_budget
from paddle_tpu_torch.serving.scheduler import WATCHDOG_EXIT_CODE

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"
SPEC = ModelSpec(vocab_size=64, hidden=32, layers=2, heads=2, max_seq_len=64)
CFG = ServeConfig(decode_buckets=(4,), prefill_buckets=(16,), kv_pages=32,
                  page_size=4, max_inflight=16, max_new_tokens=8)


@pytest.fixture(scope="module")
def params():
    return init_params(SPEC, seed=0, device="cpu")


# -- hygiene -------------------------------------------------------------------

def test_importing_every_module_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert 'paddle_tpu_torch.jit.capture' in names, names\n"
        "for m in ('optimizer.lr', 'optimizer.lbfgs', 'nn.clip',\n"
        "          'regularizer', 'distributed.checkpoint',\n"
        "          'distributed.checkpoint_manager', 'serving.quant',\n"
        "          'quantization.observers', 'utils.retry',\n"
        "          'io.dataloader', 'io.sampler', 'io.dataset',\n"
        "          'framework.io_state', 'metric', 'hapi.model',\n"
        "          'hapi.callbacks', 'hapi.summary', 'callbacks',\n"
        "          'batch', 'distributed.env', 'distributed.collective',\n"
        "          'distributed.communication.stream',\n"
        "          'distributed.parallel', 'distributed.launch_api',\n"
        "          'distributed.parallel_with_gloo', 'distributed.mesh',\n"
        "          'distributed.topology', 'distributed.grad_buckets',\n"
        "          'distributed.fleet.fleet',\n"
        "          'distributed.fleet.base.distributed_strategy',\n"
        "          'distributed.fleet.meta_parallel.mp_ops',\n"
        "          'distributed.fleet.meta_parallel.random',\n"
        "          'distributed.fleet.meta_parallel.tensor_parallel',\n"
        "          'distributed.fleet.meta_parallel.parallel_layers.mp_layers',\n"
        "          'distributed.fleet.meta_optimizers.hybrid_parallel_optimizer',\n"
        "          'distributed.collective_schedule',\n"
        "          'distributed.auto_parallel.spec_layout',\n"
        "          'distributed.sharding', 'distributed.sharding.group_sharded',\n"
        "          'distributed.fleet.meta_optimizers.dygraph_sharding_optimizer',\n"
        "          'distributed.fleet.meta_parallel.sharding_parallel',\n"
        "          'distributed.fleet.meta_parallel.parallel_layers.pp_layers',\n"
        "          'distributed.fleet.meta_parallel.pipeline_parallel',\n"
        "          'distributed.fleet.meta_parallel.pp_utils',\n"
        "          'distributed.fleet.meta_parallel.pp_utils.p2p_communication',\n"
        "          'distributed.checkpoint_layout',\n"
        "          'incubate.distributed', 'incubate.distributed.models',\n"
        "          'incubate.distributed.models.moe',\n"
        "          'incubate.distributed.models.moe.functional',\n"
        "          'incubate.distributed.models.moe.gate',\n"
        "          'incubate.distributed.models.moe.moe_layer',\n"
        "          'distributed.launch', 'distributed.launch.main',\n"
        "          'distributed.launch.__main__', 'distributed.rpc',\n"
        "          'distributed.ps', 'distributed.entry_attr',\n"
        "          'distributed.auto_parallel_api',\n"
        "          'distributed.auto_parallel.engine',\n"
        "          'distributed.auto_parallel.cluster',\n"
        "          'distributed.fleet.role_maker', 'distributed.fleet.util',\n"
        "          'cost_model', 'cost_model.parallel_cost',\n"
        "          'observability', 'observability.logs',\n"
        "          'observability.metrics', 'observability.events',\n"
        "          'observability.server', 'observability.telemetry',\n"
        "          'distributed.utils', 'distributed.fleet.utils',\n"
        "          'distributed.fleet.data_generator',\n"
        "          'distributed.fleet.dataset', 'distributed.auto_tuner',\n"
        "          'distributed.auto_tuner.prune',\n"
        "          'distributed.auto_tuner.recorder',\n"
        "          'distributed.auto_tuner.search',\n"
        "          'distributed.auto_tuner.tuner'):\n"
        "    assert 'paddle_tpu_torch.' + m in names, (m, names)\n"
        "    assert 'paddle_tpu_torch.' + m in sys.modules, m\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]"
    assert int(count) >= 12  # ops, serving and their submodules


def test_package_sources_name_no_jax_and_no_reference_module():
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) >= 12
    for m in ("distributed/checkpoint.py", "distributed/checkpoint_manager.py",
              "serving/quant.py", "quantization/observers.py",
              "utils/retry.py", "io/dataloader.py", "io/sampler.py",
              "io/dataset.py", "framework/io_state.py", "metric/__init__.py",
              "hapi/model.py", "hapi/callbacks.py", "hapi/summary.py",
              "distributed/env.py", "distributed/collective.py",
              "distributed/communication/stream.py",
              "distributed/parallel.py", "distributed/launch_api.py",
              "distributed/parallel_with_gloo.py", "distributed/mesh.py",
              "distributed/topology.py", "distributed/grad_buckets.py",
              "distributed/fleet/fleet.py",
              "distributed/fleet/base/distributed_strategy.py",
              "distributed/fleet/meta_parallel/mp_ops.py",
              "distributed/fleet/meta_parallel/random.py",
              "distributed/fleet/meta_parallel/tensor_parallel.py",
              "distributed/fleet/meta_parallel/parallel_layers/mp_layers.py",
              "distributed/fleet/meta_optimizers/"
              "hybrid_parallel_optimizer.py",
              "distributed/collective_schedule.py",
              "distributed/auto_parallel/spec_layout.py",
              "distributed/sharding/__init__.py",
              "distributed/sharding/group_sharded.py",
              "distributed/fleet/meta_optimizers/"
              "dygraph_sharding_optimizer.py",
              "distributed/fleet/meta_parallel/sharding_parallel.py",
              "distributed/fleet/meta_parallel/parallel_layers/pp_layers.py",
              "distributed/fleet/meta_parallel/pipeline_parallel.py",
              "distributed/fleet/meta_parallel/pp_utils/__init__.py",
              "distributed/fleet/meta_parallel/pp_utils/"
              "p2p_communication.py", "distributed/checkpoint_layout.py",
              "incubate/distributed/__init__.py",
              "incubate/distributed/models/__init__.py",
              "incubate/distributed/models/moe/__init__.py",
              "incubate/distributed/models/moe/functional.py",
              "incubate/distributed/models/moe/gate.py",
              "incubate/distributed/models/moe/moe_layer.py",
              "observability/__init__.py", "observability/logs.py",
              "observability/metrics.py", "observability/events.py",
              "observability/server.py", "observability/telemetry.py",
              "distributed/utils/__init__.py",
              "distributed/fleet/utils/__init__.py",
              "distributed/fleet/data_generator.py",
              "distributed/fleet/dataset.py",
              "distributed/auto_tuner/__init__.py",
              "distributed/auto_tuner/prune.py",
              "distributed/auto_tuner/recorder.py",
              "distributed/auto_tuner/search.py",
              "distributed/auto_tuner/tuner.py"):
        assert PKG / m in sources, m
    for path in sources:
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax", text, re.M), path
        assert not re.search(r"\bpaddle_tpu\.", text), path
        assert not re.search(r"^\s*(import|from)\s+paddle_tpu\b(?!_torch)",
                             text, re.M), path


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _code(path):
    """A CUDA source without its comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def _global_kernels():
    """The name of every ``__global__`` function in the port's sources."""
    names = []
    csrc = PKG / "csrc"
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = _code(path)
        for m in re.finditer(r"\b__global__\b", text):
            # the first call-like name after the attributes
            names += [i.group(1) for i in re.finditer(
                r"\b([A-Za-z_]\w*)\s*\(", text[m.end():])
                if not i.group(1).startswith("__")][:1]
    return names


def test_every_cuda_kernel_is_in_the_step_profiles_name_lists():
    # a profile sums a kernel's device time under the first list entry
    # found in its name: every kernel is listed, by its own name only
    kernels = _global_kernels()
    assert len(kernels) >= 24 and len(set(kernels)) == len(kernels)
    assert {"flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel"} <= set(
        kernels)
    listed = [n for names in _chip_smoke().PROFILE_KERNELS.values()
              for n in names]
    assert sorted(listed) == sorted(kernels)
    for kernel in kernels:
        assert [n for n in listed if n in kernel] == [kernel], kernel


def test_flash_kernels_sum_without_atomics():
    # dq, dk and dv the same bits on every run: no atomic adds, no
    # reductions to global memory, in the flash sources or their headers
    csrc = PKG / "csrc"
    code = {p.name: _code(p) for p in sorted(csrc.glob("flash_attention*")) +
            [csrc / "hopper.cuh"]}
    assert {"flash_attention.cu", "flash_attention_dq.cu",
            "flash_attention_dkv.cu", "flash_attention.cuh"} <= set(code)
    assert "flash_bwd_dkv_wg_kernel" in code["flash_attention.cuh"]
    for name, text in code.items():
        assert not re.search(r"\batomic\w*\s*\(", text), name
        assert not re.search(r"\b(red|atom)\.", text), name


def test_layer_norm_kernels_sum_without_atomics():
    # dw and db the same bits on every run: each block's partial row, then
    # the block-order reduce; no atomic adds in the LayerNorm source
    code = _code(PKG / "csrc" / "layer_norm.cu")
    assert "ln_bwd_one_pass_kernel" in code and "ln_bwd_reduce_kernel" in code
    assert not re.search(r"\batomic\w*\s*\(", code)
    assert not re.search(r"\b(red|atom)\.", code)


def test_exit_codes_and_page_budget_match_the_reference():
    assert exit_codes.EXIT_WATCHDOG == jax_exit_codes.EXIT_WATCHDOG == 70
    assert exit_codes.EXIT_DRAIN == jax_exit_codes.EXIT_DRAIN == 143
    assert WATCHDOG_EXIT_CODE == 70 and DRAIN_EXIT_CODE == 143
    for prec in ("fp32", "bf16", "int8"):
        for pages, hd in ((128, 16), (1024, 64), (7, 8)):
            assert (kv_page_budget(pages, prec, hd)
                    == jax_kv_cache.kv_page_budget(pages, prec, hd))


# -- device rules --------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch,
                                                                params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(SPEC, params, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagePool(layers=1, pages=4, page_size=4, heads=1, head_dim=4)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_distributed_entry_points_want_the_card_and_never_pick_gloo(
        monkeypatch):
    from paddle_tpu_torch.distributed import init_parallel_env, is_initialized
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.train import build_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_parallel_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_parallel_env(backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(gpt_tiny(), dp=2, mp=2)
    with pytest.raises(ValueError, match="nccl backend needs"):
        init_parallel_env(backend="nccl", device="cpu")
    assert not is_initialized()


def _capture_on_gloo():
    """One gloo rank: a hybrid step asked to be captured must refuse."""
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.jit import capture_step
    from paddle_tpu_torch.train import build_train_step
    with pytest.raises(ValueError, match="gloo") as err:
        build_train_step(gpt_tiny(), device="cpu", amp_o2=False, mp=1, dp=1,
                         strategy=_degree_one())
    step = build_train_step(gpt_tiny(), device="cpu", amp_o2=False,
                            strategy=_degree_one(), capture=False)
    assert step.captured is None
    with pytest.raises(ValueError, match="gloo"):
        capture_step(step.eager)
    with pytest.raises(NotImplementedError, match="fusion pass on tensor"):
        build_train_step(gpt_tiny(), device="cpu", amp_o2=False,
                         strategy=_degree_one(), capture=False, fusion=True)
    return str(err.value)


def _degree_one():
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1}
    return s


def test_capture_step_refuses_a_step_on_gloo(tmp_path):
    from paddle_tpu_torch.distributed import spawn
    [msg] = spawn(_capture_on_gloo, nprocs=1, store=str(tmp_path / "store"),
                  timeout=60)
    assert "capture=False" in msg


def test_fusion_pass_refuses_a_tensor_parallel_model():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ColumnParallelLinear
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.nn.initializer import Normal
    from paddle_tpu_torch.ops.fusion_pass import wrap
    model = torch.nn.Sequential(ColumnParallelLinear(
        8, 16, Normal(), generator=make_generator(0, "cpu")))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1: the fusion pass on mp models"):
        wrap(model)


# -- page pool -------------------------------------------------------------------

def _pool(pages=8, page_size=4, **kw):
    return PagePool(layers=1, pages=pages, page_size=page_size, heads=1,
                    head_dim=4, device="cpu", **kw)


def test_pool_alloc_free_reuse_and_double_free():
    pool = _pool(pages=8)
    a = pool.alloc(3)
    assert len(set(a)) == 3 and NULL_PAGE not in a
    pool.free(a)
    assert set(pool.alloc(3)) == set(a)  # LIFO reuse
    with pytest.raises(ValueError):
        pool.free([NULL_PAGE])
    small = _pool(pages=4)
    got = small.alloc(3)
    with pytest.raises(KVPoolExhausted):
        small.alloc(1)
    small.free(got)
    with pytest.raises(ValueError):
        small.free([got[0]])
    small.check_consistency(expect_all_free=True)


def test_pool_reservations_gate_admission():
    pool = _pool(pages=8)  # 7 usable
    assert pool.can_admit(7) and not pool.can_admit(8)
    pool.reserve(5)
    assert pool.headroom() == 2
    with pytest.raises(KVPoolExhausted):
        pool.reserve(3)
    got = pool.alloc(2, reserved=True)  # draws the promise down
    assert pool.headroom() == 2
    with pytest.raises(KVPoolExhausted):
        pool.alloc(3)                   # unreserved: promised pages are off
    pool.free(got)
    pool.release_reservation(3)
    assert pool.headroom() == 7
    pool.check_consistency(expect_all_free=True)
    assert pool.null_padded_table([3, 5], 4).tolist() == [3, 5, 0, 0]


def test_int8_pool_has_scale_pools_on_the_device():
    pool = _pool(dtype=torch.int8, scale_pages=True)
    assert pool.k_flat.dtype == torch.int8
    assert pool.k_scale.shape == (1, 8 * 4, 1)
    assert pool.snapshot()["dtype"] == "int8"


# -- scheduler admission ----------------------------------------------------------

def test_saturation_raises_engine_saturated(params):
    eng = ServingEngine(SPEC, params, CFG.replace(max_inflight=3),
                        device="cpu")
    streams = [eng.scheduler.submit([1, 2], max_new_tokens=2)
               for _ in range(3)]
    with pytest.raises(EngineSaturated):
        eng.scheduler.submit([1, 2], max_new_tokens=2)
    eng.scheduler.drain()
    assert all(len(st.result(timeout=30)) == 2 for st in streams)
    eng.pool.check_consistency(expect_all_free=True)


def test_kv_headroom_blocks_admission_until_pages_return(params):
    eng = ServingEngine(SPEC, params, CFG.replace(kv_pages=8), device="cpu")
    # worst case per request: ceil((6+8)/4) = 4 of 7 usable pages
    s1 = eng.scheduler.submit([1, 2, 3, 4, 5, 6], max_new_tokens=8)
    s2 = eng.scheduler.submit([1, 2, 3, 4, 5, 6], max_new_tokens=8)
    eng.scheduler.step()
    snap = eng.scheduler.snapshot()
    assert snap["active_sequences"] == 1 and snap["queue_depth"] == 1
    assert snap["refused_kv"] >= 1
    eng.scheduler.drain()
    assert s1.result(timeout=30) == s2.result(timeout=30)
    assert eng.pool.snapshot()["used_pages"] == 0


def test_out_of_ladder_requests_refused(params):
    eng = ServingEngine(SPEC, params, CFG, device="cpu")
    for bad in ([], [SPEC.vocab_size + 5], list(range(1, 40))):
        with pytest.raises(ValueError):
            eng.scheduler.submit(bad)


def test_serve_config_env_and_ladder_clamp(monkeypatch):
    monkeypatch.setenv("PT_SERVE_BUCKETS", "1,8")
    monkeypatch.setenv("PT_SERVE_PRECISION", "int8")
    cfg = ServeConfig.from_env()
    assert cfg.decode_buckets == (1, 8) and cfg.precision == "int8"
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    norm = cfg.replace(prefill_buckets=(16, 4096)).normalized(SPEC)
    assert norm.decode_buckets == (2, 8)
    assert norm.prefill_buckets == (16,)
    with pytest.raises(ValueError):
        cfg.replace(precision="fp8").normalized(SPEC)


# -- HTTP front end ----------------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_generate_healthz_and_cancel(params):
    eng = ServingEngine(SPEC, params, CFG, device="cpu")
    srv = ServeHTTPServer(eng, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ok"]
        status, out = _post(base + "/v1/generate",
                            {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 200 and len(out["tokens"]) == 4
        assert out["tokens"] == eng.generate([[1, 2, 3]],
                                             max_new_tokens=4)[0]
        status, out = _post(base + "/v1/cancel", {"request_id": 10 ** 9})
        assert status == 200 and out["cancelled"] is False
        for path in ("/v1/generate", "/v1/cancel"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + path, {"tokens": "nope"})
            assert ei.value.code == 400
        # /metrics answers with the registry's text (empty while
        # telemetry is off); an unknown route is still 404
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        srv.stop()


def test_http_saturation_returns_429(params):
    eng = ServingEngine(SPEC, params, CFG.replace(max_inflight=1),
                        device="cpu")
    srv = ServeHTTPServer(eng, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    hold = threading.Event()
    orig_step = eng.scheduler.step

    def slow_step():
        hold.wait(5.0)
        return orig_step()

    eng.scheduler.step = slow_step
    first = threading.Thread(target=lambda: _post(
        base + "/v1/generate", {"tokens": [1, 2], "max_new_tokens": 2}))
    try:
        first.start()
        for _ in range(100):
            if eng.scheduler.snapshot()["submitted"]:
                break
            threading.Event().wait(0.05)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/generate",
                  {"tokens": [3, 4], "max_new_tokens": 2})
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"] == "1"
    finally:
        hold.set()
        first.join(timeout=30)
        eng.scheduler.step = orig_step
        srv.stop()
    assert not first.is_alive()
