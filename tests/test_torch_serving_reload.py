"""Served-model directories, int8 calibration and hot reload in the port,
on the CPU, against the JAX package (``tests/test_serving_quant.py``'s
spec: vocabulary 64, hidden 32, 2 layers, 2 heads; decode bucket 4,
prefill bucket 16, page size 4).

 - a JAX ``save_served_model`` directory served by the port's
   ``load_engine(..., device="cpu")`` gives the JAX ``load_engine``'s
   tokens at fp32 and int8, and a JAX quantized directory too;
 - the port's ``save_quantized_model`` against the JAX one on the same
   weights and prompts: the ``::q`` / ``::scale`` leaves the same bits,
   the activation scales within ``ACT_RTOL`` relative (the same maxima
   of activations the two packages compute with products summed in
   another order), and each package serves the other's directory with
   the same tokens;
 - ``logit_divergence`` under the JAX test's bar, 0.05;
 - ``maybe_reload`` (in place, the served tensors keep their storage),
   ``POST /v1/reload`` and the ``reload_interval`` poll over the port's
   HTTP server, and ``python -m paddle_tpu_torch.serving --model DIR
   --device cpu`` starting, answering and draining on SIGTERM.
"""
import gc
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ModelSpec as JSpec, ServeConfig as JConfig
from paddle_tpu.serving import init_params as jax_init_params
from paddle_tpu.serving import quant as jquant
from paddle_tpu.serving.engine import (load_engine as jax_load_engine,
                                       save_served_model as
                                       jax_save_served_model)
from paddle_tpu_torch.distributed import CheckpointManager
from paddle_tpu_torch.serving import (ModelSpec, ServeConfig, ServingEngine,
                                      is_served_model_dir, load_engine,
                                      params_from_numpy, save_served_model)
from paddle_tpu_torch.serving import quant as tquant
from paddle_tpu_torch.serving.http import ServeHTTPServer
from paddle_tpu_torch.utils.retry import wait_until

REPO = Path(__file__).resolve().parents[1]
SPEC = ModelSpec(vocab_size=64, hidden=32, layers=2, heads=2, max_seq_len=64)
JSPEC = JSpec(**SPEC.to_dict())
CFG = dict(decode_buckets=(4,), prefill_buckets=(16,), kv_pages=32,
           page_size=4, max_inflight=16, max_new_tokens=8)
DIVERGENCE_TOL = 0.05
ACT_RTOL = 1e-5


def _prompts(n=6, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, SPEC.vocab_size, size=rng.randint(2, 12)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module", autouse=True)
def _collect_at_end():
    """Free the JAX arrays this module's fixtures held (their objects
    sit in reference cycles) before the next module in the process."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def np_params():
    return {k: np.asarray(v) for k, v in jax_init_params(JSPEC, 0).items()}


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory, np_params):
    """The JAX package's fp32 and quantized directories of one weight
    set, and its engines' tokens on them."""
    root = tmp_path_factory.mktemp("jax_dirs")
    import jax.numpy as jnp
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    fp32 = jax_save_served_model(str(root / "fp32"), JSPEC, jparams,
                                 JConfig(**CFG))
    int8 = jquant.save_quantized_model(str(root / "int8"), JSPEC, jparams,
                                       config=JConfig(**CFG))
    tokens = {}
    for name, path, kw in (("fp32", fp32, {}), ("fp32->int8", fp32,
                                                {"precision": "int8"}),
                           ("int8", int8, {})):
        eng = jax_load_engine(path, **kw)
        try:
            tokens[name] = eng.generate(_prompts(), max_new_tokens=8)
        finally:
            eng.close()
    return {"fp32": fp32, "int8": int8, "tokens": tokens}


@pytest.mark.parametrize("name", ["fp32", "fp32->int8", "int8"])
def test_jax_served_dir_serves_in_the_port(jax_dirs, name):
    path = jax_dirs["int8" if name == "int8" else "fp32"]
    kw = {"precision": "int8"} if name == "fp32->int8" else {}
    assert is_served_model_dir(path)
    eng = load_engine(path, device="cpu", **kw)
    try:
        assert eng.config.precision == ("fp32" if name == "fp32" else "int8")
        assert eng.weights_step == 0
        assert eng.generate(_prompts(), max_new_tokens=8) == \
            jax_dirs["tokens"][name]
    finally:
        eng.close()


def test_quantized_dirs_agree_across_packages(tmp_path, np_params,
                                              jax_dirs):
    path = tquant.save_quantized_model(
        str(tmp_path / "m"), SPEC, params_from_numpy(np_params, "cpu"),
        config=ServeConfig(**CFG))
    meta = json.load(open(os.path.join(path, "serve_config.json")))
    jmeta = json.load(open(os.path.join(jax_dirs["int8"],
                                        "serve_config.json")))
    assert meta["serve"] == jmeta["serve"]
    prec, jprec = meta["precision"], jmeta["precision"]
    assert {k: v for k, v in prec.items() if k != "act_scales"} == \
        {k: v for k, v in jprec.items() if k != "act_scales"}
    assert sorted(prec["act_scales"]) == sorted(jprec["act_scales"])
    assert len(prec["act_scales"]) == 6 * SPEC.layers + 1
    for site, v in prec["act_scales"].items():
        assert v == pytest.approx(jprec["act_scales"][site], rel=ACT_RTOL), \
            site
    ours, _ = CheckpointManager(os.path.join(path, "weights")
                                ).restore_latest()
    theirs, _ = CheckpointManager(os.path.join(jax_dirs["int8"], "weights")
                                  ).restore_latest()
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        if name.startswith("act::"):
            continue
        assert ours[name].dtype == theirs[name].dtype, name
        assert torch.equal(ours[name], theirs[name]), name
    tmpl = tquant.quantized_template(SPEC, sorted(prec["act_scales"]))
    assert {k: (tuple(t.shape), t.dtype) for k, t in tmpl.items()} == \
        {k: (tuple(t.shape), t.dtype) for k, t in ours.items()}
    # each package serves the other's directory
    eng = jax_load_engine(path)
    try:
        assert eng.config.precision == "int8"
        assert eng.generate(_prompts(), max_new_tokens=8) == \
            jax_dirs["tokens"]["int8"]
    finally:
        eng.close()
    eng = load_engine(path, device="cpu")
    try:
        assert eng.generate(_prompts(), max_new_tokens=8) == \
            jax_dirs["tokens"]["int8"]
    finally:
        eng.close()


def test_logit_divergence_within_the_bar(np_params):
    params = params_from_numpy(np_params, "cpu")
    div = tquant.logit_divergence(SPEC, params, page_size=CFG["page_size"])
    import jax.numpy as jnp
    jdiv = jquant.logit_divergence(
        JSPEC, {k: jnp.asarray(v) for k, v in np_params.items()},
        page_size=CFG["page_size"])
    assert 0.0 < div < DIVERGENCE_TOL
    assert div == pytest.approx(jdiv, rel=1e-2)
    cal = tquant.calibrate(SPEC, params,
                           tquant.default_calibration_prompts(SPEC),
                           page_size=CFG["page_size"])
    jcal = jquant.calibrate(JSPEC, {k: jnp.asarray(v)
                                    for k, v in np_params.items()},
                            jquant.default_calibration_prompts(JSPEC),
                            page_size=CFG["page_size"])
    assert cal["samples"] == jcal["samples"] and cal["prompts"] == 4
    for name, s in cal["weight_scales"].items():
        np.testing.assert_array_equal(s, jcal["weight_scales"][name])


def _perturbed(params, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.01 * torch.randn(v.shape, generator=g)
            for k, v in params.items()}


def _http(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_reload_in_place_over_http_and_by_poll(tmp_path, np_params):
    params = params_from_numpy(np_params, "cpu")
    path = save_served_model(str(tmp_path / "m"), SPEC, params,
                             ServeConfig(**CFG))
    eng = load_engine(path, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in eng._params.items()}
    assert eng.maybe_reload() is None            # nothing newer
    gen1, gen2 = _perturbed(params, 1), _perturbed(params, 2)
    prompts = _prompts()

    def fresh(p):
        e = ServingEngine(SPEC, p, ServeConfig(**CFG), device="cpu")
        try:
            return e.generate(prompts, max_new_tokens=8)
        finally:
            e.close()
    before = eng.generate(prompts, max_new_tokens=8)
    assert before == fresh(params)
    mgr = CheckpointManager(os.path.join(path, "weights"))
    mgr.save(1, gen1)
    assert eng.maybe_reload() == 1 and eng.weights_step == 1
    assert {k: t.data_ptr() for k, t in eng._params.items()} == ptrs
    after = eng.generate(prompts, max_new_tokens=8)
    assert after == fresh(gen1) and after != before
    # POST /v1/reload, then the poll
    mgr.save(2, gen2)
    srv = ServeHTTPServer(eng, port=0).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        assert _http(base, "/v1/reload", {}) == (
            200, {"reloaded": True, "weights_step": 2})
        assert _http(base, "/v1/reload", {}) == (
            200, {"reloaded": False, "weights_step": 2})
        status, health = _http(base, "/healthz")
        assert status == 200 and health["weights_step"] == 2
        status, out = _http(base, "/v1/generate",
                            {"tokens": prompts[0], "max_new_tokens": 8})
        assert status == 200 and out["weights_step"] == 2
        assert out["tokens"] == fresh(gen2)[0]
    finally:
        srv.stop()
    srv = ServeHTTPServer(eng, port=0, reload_interval=0.05).start()
    base = f"http://{srv.host}:{srv.port}"
    try:
        mgr.save(3, gen1)
        wait_until(lambda: _http(base, "/healthz")[1]["weights_step"] == 3,
                   30.0, desc="the reload poll")
        status, out = _http(base, "/v1/generate",
                            {"tokens": prompts[0], "max_new_tokens": 8})
        assert out["tokens"] == after[0]
    finally:
        srv.stop()
    # a generation of other names is refused, and the old one keeps serving
    mgr.save(4, tquant.quantize_params(gen2, SPEC))
    with pytest.raises(ValueError, match="parameter names"):
        eng.maybe_reload()
    assert eng.weights_step == 3
    eng.close()


def test_serving_cli_serves_a_model_dir(tmp_path, np_params):
    path = save_served_model(str(tmp_path / "m"), SPEC,
                             params_from_numpy(np_params, "cpu"),
                             ServeConfig(**CFG))
    port_file = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    bad = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.serving",
                          "--model", path, "--spec", "{}"], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 2 and "exactly one" in bad.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--model", path,
         "--device", "cpu", "--port-file", port_file,
         "--drain-budget", "5"], env=env, cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        wait_until(lambda: os.path.exists(port_file) or
                   proc.poll() is not None, 120.0, desc="the server's port")
        assert proc.poll() is None, proc.stderr.read()
        base = "http://" + open(port_file).read()
        status, out = _http(base, "/v1/generate",
                            {"tokens": _prompts()[0], "max_new_tokens": 8})
        assert status == 200 and len(out["tokens"]) == 8
        assert out["weights_step"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
