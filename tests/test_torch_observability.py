"""The port's observability core against the JAX package's, on the CPU.

The same seeded operations go to both registries (Prometheus text byte
for byte, snapshots, percentiles), both event sinks (records and
rotation), and both telemetry hubs (snapshot, healthz, the registry's
text, the sentinel's trip).  With telemetry off, a serve run and a train
run leave both registries empty.  The port's ``MetricsServer`` is held on
a real socket, its import in a subprocess, and its serving engine's
``pt_serve_*`` series to the JAX engine's for the same HTTP requests.
"""
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.observability as jobs
from paddle_tpu.serving import (ModelSpec as JSpec, ServeConfig as JConfig,
                                ServingEngine as JEngine,
                                init_params as jax_init_params)
from paddle_tpu.serving.http import ServeHTTPServer as JServer
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.serving import ModelSpec, ServeConfig, ServingEngine
from paddle_tpu_torch.serving.http import ServeHTTPServer as TServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ModelSpec(vocab_size=64, hidden=32, layers=2, heads=2, max_seq_len=64)
JSPEC = JSpec(**SPEC.to_dict())
SERVE = dict(decode_buckets=(4,), prefill_buckets=(16,), kv_pages=32,
             page_size=4, max_inflight=16, max_new_tokens=8)
# a gauge whose value is the wall clock
_CLOCK_SERIES = ("pt_last_step_timestamp_seconds",)
# the JAX hub's families of the elastic heartbeat and the resilient store,
# whose callers the port does not have yet (ROADMAP Queue 1 item 6)
_ITEM6_FAMILIES = ("pt_elastic_", "pt_store_")


@pytest.fixture(autouse=True)
def fresh_telemetry():
    jobs.reset()
    tobs.reset()
    yield
    jobs.reset()
    tobs.reset()


# -- the registry ------------------------------------------------------------------

_LABEL_VALUES = ["a", "b", 'q"x', "back\\slash", "new\nline", "7"]


def _registry_ops(seed):
    """A seeded list of (method, args) registry operations: counters,
    gauges and histograms with 0-2 labels, helps that need escaping."""
    rng = np.random.RandomState(seed)
    ops = [("set_const_labels",
            {"process_index": int(rng.randint(8)), "run_id": 'r"1'})]
    for _ in range(300):
        kind = ["counter", "gauge", "histogram"][rng.randint(3)]
        j = int(rng.randint(4))
        name = f"pt_{kind}_{j}"
        names = ("mode", "op")[:j % 3]
        labels = {n: _LABEL_VALUES[rng.randint(len(_LABEL_VALUES))]
                  for n in names}
        help_ = f"{kind} {j}: a\\b\nc"
        if kind == "counter":
            amount = float(rng.choice([1, 0.5, 2.25, 3e15, 1e-7]))
            ops.append(("counter", name, help_, names, "inc", amount, labels))
        elif kind == "gauge":
            v = float(rng.randn() * 10.0 ** rng.randint(-4, 5))
            how = ["set", "inc", "dec"][rng.randint(3)]
            ops.append(("gauge", name, help_, names, how, v, labels))
        else:
            v = float(10.0 ** rng.uniform(-5, 3))
            buckets = None if j % 2 else (0.001, 0.01, 0.1, 1.0, 10.0)
            ops.append(("histogram", name, help_, names, buckets, v, labels))
    return ops


def _apply(reg, ops):
    for op in ops:
        if op[0] == "set_const_labels":
            reg.set_const_labels(**op[1])
        elif op[0] == "counter":
            _, name, help_, names, how, v, labels = op
            reg.counter(name, help_, names).inc(v, **labels)
        elif op[0] == "gauge":
            _, name, help_, names, how, v, labels = op
            g = reg.gauge(name, help_, names)
            getattr(g, how)(v, **labels)
        else:
            _, name, help_, names, buckets, v, labels = op
            reg.histogram(name, help_, names, buckets=buckets).observe(
                v, **labels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_snapshot_and_percentiles_match_jax(seed):
    ops = _registry_ops(seed)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    _apply(jreg, ops)
    _apply(treg, ops)
    text = treg.prometheus_text()
    assert text.encode() == jreg.prometheus_text().encode()
    assert "# TYPE pt_histogram_0 histogram" in text and 'le="+Inf"' in text
    assert json.dumps(treg.snapshot(), sort_keys=True) == json.dumps(
        jreg.snapshot(), sort_keys=True)
    assert treg.const_labels == jreg.const_labels
    for m in treg.collect():
        if m.kind != "histogram":
            continue
        jm = jreg.histogram(m.name, m.help, m.labelnames,
                            buckets=m.buckets)
        for key, _ in m._items():
            labels = dict(zip(m.labelnames, key))
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert m.percentile(q, **labels) == jm.percentile(
                    q, **labels)


def test_registry_rules_and_buckets_match_jax():
    assert tobs.log_buckets(1e-4, 100.0) == jobs.log_buckets(1e-4, 100.0)
    assert tobs.log_buckets(1e2, 1e9, per_decade=1) == jobs.log_buckets(
        1e2, 1e9, per_decade=1)
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as tm
    assert tm.DEFAULT_TIME_BUCKETS == jm.DEFAULT_TIME_BUCKETS
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        c = reg.counter("x", "h", ("a",))
        assert reg.counter("x", "h", ("a",)) is c
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="counters only go up"):
            c.inc(-1, a="1")
        with pytest.raises(ValueError, match="declared"):
            c.inc(b="1")
        with pytest.raises(ValueError):
            mod.log_buckets(1.0, 1.0)
        assert reg.histogram("h").percentile(0.5) is None
        assert mod.MetricsRegistry().prometheus_text() == ""


# -- the event sink ------------------------------------------------------------------

def _records(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out[name] = [{k: v for k, v in json.loads(line).items()
                          if k != "ts"} for line in f]
    return out


@pytest.mark.parametrize("identity", [True, False])
def test_event_sink_records_and_rotation_match_jax(tmp_path, identity):
    kw = dict(run_id="run/7", process_index=3) if identity else {}
    sinks = [mod.EventSink(str(tmp_path / name), max_bytes=600, **kw)
             for mod, name in ((jobs, "jax"), (tobs, "port"))]
    assert not (tmp_path / "jax").exists()          # no I/O until emit
    for i in range(12):
        for s in sinks:
            assert s.emit("step", step=i, duration_sec=0.5 * i,
                          tag=("x" * (i % 5)), path=tmp_path)
    for s in sinks:
        s.close()
    jrec, trec = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert trec == jrec
    names = sorted(trec)
    assert len(names) == 2 and names[1].endswith(".jsonl.1")  # rotated once
    want = "telemetry-run_7-3.jsonl" if identity else \
        f"telemetry-{os.getpid()}.jsonl"
    assert names[0] == want
    assert sinks[1].path == os.path.join(str(tmp_path / "port"), want)
    assert sinks[1].dropped == sinks[0].dropped == 0


def test_event_sink_drops_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    for mod in (jobs, tobs):
        sink = mod.EventSink(str(blocker / "sub"))
        assert sink.emit("x") is False and sink.dropped == 1


# -- the telemetry hub ------------------------------------------------------------------

def _drive_hub(mod):
    """The same calls on ``mod``'s hub; returns (hub, the call index at
    which the sentinel tripped)."""
    tel = mod.get_telemetry().enable(compile_watch=False)
    for k in range(1, 41):
        tel.observe_step(0.001 * k, mode="train", batch_size=8)
        tel.data_wait(0.0005 * k)
    tel.observe_step(0.02, mode="eval")
    for op, n in (("all_reduce", 4096), ("all_gather", 512),
                  ("barrier", 0), ("all_reduce", 12)):
        tel.collective_op(op, n)
    tel.collective_time("all_reduce", 0.003)
    tel.grad_bucket(1 << 20, kind="reduce_scatter")
    tel.grad_bucket(2048)
    tel.record_checkpoint_save(0.5, step=3)
    tel.record_checkpoint_save(0.25, step=4, mode="sync", ok=False)
    tel.record_checkpoint_restore(0.125, step=3)
    tel.record_checkpoint_restore(0.1, step=2, ok=False)
    tel.record_checkpoint_gc(2)
    tel.record_barrier_wait(0.01)
    tel.record_barrier_wait(2.0, ok=False)
    tel.record_staging_sweep(1)
    tel.record_async_save_failure(5, OSError("disk"))
    for _ in range(3):
        tel.capture_cache_hit()
    tel.capture_cache_miss("first_trace")
    tel.capture_cache_miss("signature_change")
    tel.fusion_rewrite("ln_matmul")
    tel.fusion_rewrite("ln_matmul")
    tel.fusion_fallback("matmul_bias_gelu", "canary_failed")
    tripped = None
    for i in range(8):
        tel.record_compile("captured_step(f)", f"sig={i % 6}")
        if tripped is None and tel.sentinel.tripped():
            tripped = i
    tel.record_compile("serve_decode_b4", "aot-build")
    return tel, tripped


def _clockless(text):
    """``text`` with the clock gauge's value masked and without the item-6
    families."""
    return "\n".join(
        re.sub(r" \S+$", " <t>", line)
        if line.startswith(_CLOCK_SERIES) else line
        for line in text.splitlines()
        if not re.match(r"(# (HELP|TYPE) )?(" + "|".join(_ITEM6_FAMILIES)
                        + ")", line))


def test_hub_snapshot_healthz_and_registry_match_jax():
    jtel, jtrip = _drive_hub(jobs)
    ttel, ttrip = _drive_hub(tobs)
    assert ttrip == jtrip == 4            # the 5th distinct signature
    js, ts = jtel.snapshot(), ttel.snapshot()
    for k in ("numerics", "goodput", "memory"):
        js.pop(k)
        assert ts.pop(k) is None
    assert ts == js
    assert ts["capture"] == {"hits": 3, "misses": {"first_trace": 1,
                                                   "signature_change": 1}}
    assert ts["steps"] == 41 and ts["recompile_storms"] == [
        "captured_step(f)"]
    jh, th = jtel.healthz(), ttel.healthz()
    for h in (jh, th):
        for k in ("uptime_sec", "last_step_age_sec"):
            h.pop(k)
    assert th == jh and th["ok"] and th["elastic"] is th["store"] is None
    assert not any(m.startswith(_ITEM6_FAMILIES)
                   for m in tobs.get_registry().snapshot())
    assert _clockless(tobs.get_registry().prometheus_text()) == _clockless(
        jobs.get_registry().prometheus_text())
    assert ttel.device_memory() == {}      # the CPU has no allocator stats


def test_sentinel_trips_at_the_same_call_as_jax():
    for threshold in (2, 3, 5):
        trips = []
        for mod in (jobs, tobs):
            s = mod.RecompileSentinel(threshold=threshold)
            got = [s.observe("f", f"sig={i % 4}") is not None
                   for i in range(10)]
            trips.append((got, s.compile_counts(), sorted(s.tripped())))
        assert trips[0] == trips[1]


def test_off_means_no_metric_and_step_hooks_do_nothing():
    tel = tobs.get_telemetry()
    assert not tel.enabled
    assert tel.step_start() is None
    tel.step_end(None)
    tel.observe_step(0.1)
    tel.data_wait(0.1)
    tel.collective_op("all_reduce", 8)
    tel.grad_bucket(8)
    tel.record_checkpoint_save(0.1, step=1)
    assert tobs.get_registry().snapshot() == {}
    with tel.step(batch_size=4):
        pass
    assert tel.snapshot()["steps"] == 0


def test_env_turns_the_hub_on(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_TELEMETRY", "1")
    monkeypatch.setenv("PT_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("PT_METRICS_PORT", "0")
    monkeypatch.setenv("PT_PROCESS_INDEX", "2")
    monkeypatch.setenv("PT_RUN_ID", "abc")
    monkeypatch.setenv("PT_RECOMPILE_THRESHOLD", "3")
    tel = tobs.get_telemetry()
    assert tel.enabled and tel.server.port and tel.sentinel.threshold == 3
    assert (tel.process_index, tel.run_id) == (2, "abc")
    tel.observe_step(0.01)
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "telemetry-abc-2.jsonl"))
    with urllib.request.urlopen(
            f"http://127.0.0.1:{tel.server.port}/metrics", timeout=30) as r:
        assert 'process_index="2",run_id="abc"' in r.read().decode()
    tobs.configure(enabled=False)
    assert tel.server is None and tel.sink is None


def test_not_ported_names_raise_naming_the_roadmap_item():
    for name in ("Tracer", "get_tracer", "NumericsMonitor", "GoodputLedger",
                 "SdcMonitor", "MemoryMonitor", "ClusterAggregator"):
        with pytest.raises(AttributeError, match="ROADMAP Queue 1 item 5"):
            getattr(tobs, name)
    with pytest.raises(AttributeError, match="no attribute"):
        tobs.nothing_here
    assert set(tobs.__all__) <= set(jobs.__all__)
    assert set(tobs.__all__) == {
        n for n in jobs.__all__ if n not in tobs._NOT_PORTED}


# -- the server --------------------------------------------------------------------------

def test_metrics_server_on_a_real_socket():
    reg = tobs.MetricsRegistry()
    reg.counter("pt_x_total", "x", ("a",)).inc(2, a="1")
    health = {"ok": True, "n": 1}
    srv = tobs.MetricsServer(reg, health_cb=lambda: health).start()
    assert srv.start() is srv                       # idempotent
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == tobs.server.\
                CONTENT_TYPE_METRICS
            assert r.read().decode() == reg.prometheus_text()
        with urllib.request.urlopen(base + "/healthz?x=1", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == health
        health["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/other", timeout=30)
        assert ei.value.code == 404
    finally:
        srv.stop()
    assert srv.port is None
    one = tobs.start_http_server(registry=reg)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{one.port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
    finally:
        one.stop()


def test_importing_the_package_starts_nothing():
    code = (
        "import os, sys, threading\n"
        "fds = len(os.listdir('/proc/self/fd'))\n"
        "threads = threading.active_count()\n"
        "import torch\n"
        "fds = len(os.listdir('/proc/self/fd'))\n"
        "import paddle_tpu_torch.observability as o\n"
        "from paddle_tpu_torch.observability import telemetry, server\n"
        "assert threading.active_count() == threads\n"
        "assert len(os.listdir('/proc/self/fd')) == fds\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert telemetry._telemetry is None\n"
        "assert o.metrics._registry is None\n"
        "assert not any(m.split('.')[0] in ('jax', 'paddle_tpu')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- serving -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_params():
    return {k: np.asarray(v) for k, v in jax_init_params(JSPEC, 0).items()}


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, SPEC.vocab_size, size=rng.randint(2, 12)).tolist()
            for _ in range(n)]


def _http_run(server, prompts):
    """The prompts posted one after another; the tokens returned."""
    base = f"http://{server.host}:{server.port}"
    out = []
    for p in prompts:
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"tokens": p, "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out.append(json.loads(r.read())["tokens"])
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        text = r.read().decode()
        ctype = r.headers["Content-Type"]
    return out, text, ctype


def _serve_series(snapshot):
    """The pt_serve_* series: counters and gauges by value, histograms by
    count (their sums are times)."""
    out = {}
    for name, m in snapshot.items():
        if not name.startswith("pt_serve_"):
            continue
        for lbl, v in m["series"].items():
            out[(name, lbl)] = v["count"] if m["kind"] == "histogram" else v
    return out


def test_serving_metrics_match_the_jax_engine(np_params):
    prompts = _prompts(5, 4)
    jobs.get_telemetry().enable(compile_watch=False)
    tobs.configure(enabled=True)
    jeng = JEngine(JSPEC, np_params, JConfig(**SERVE))
    jsrv = JServer(jeng, port=0).start()
    try:
        jtok, jtext, _ = _http_run(jsrv, prompts)
    finally:
        jsrv.stop()
    teng = ServingEngine(SPEC, np_params, ServeConfig(**SERVE), device="cpu")
    tsrv = TServer(teng, port=0).start()
    try:
        ttok, ttext, ctype = _http_run(tsrv, prompts)
    finally:
        tsrv.stop()
    assert ttok == jtok
    assert ctype.startswith("text/plain; version=0.0.4")
    want = _serve_series(jobs.get_registry().snapshot())
    got = _serve_series(tobs.get_registry().snapshot())
    assert sorted(got) == sorted(want)
    for key in got:
        if key[0] == "pt_serve_batch_occupancy":
            continue                           # the last step's, timing-free
        assert got[key] == want[key], key
    assert got[("pt_serve_requests_total", "")] == 4
    assert got[("pt_serve_completed_total", "")] == 4
    assert got[("pt_serve_tokens_total", "")] == 24
    assert got[("pt_serve_http_request_seconds", "")] == 4
    assert got[("pt_serve_queue_depth", "")] == 0
    kv = teng.pool.snapshot()
    assert got[("pt_serve_kv_pages", "state=used")] == kv["used_pages"]
    assert got[("pt_serve_kv_pages", "state=free")] == kv["free_pages"]
    assert "pt_serve_requests_total{" in ttext
    # the buckets' builds are the port's compiles, and no request compiled
    assert tobs.get_telemetry().sentinel.compile_counts() == {
        "serve_prefill_s16": 1, "serve_decode_b4": 1}
    assert teng.healthz()["ok"] and teng.unexpected_compiles == 0
    teng.close()


def test_a_compile_after_warm_up_degrades_the_engine(np_params):
    tobs.configure(enabled=True)
    eng = ServingEngine(SPEC, np_params, ServeConfig(**SERVE), device="cpu")
    other = ServingEngine(SPEC, np_params, ServeConfig(**SERVE),
                          device="cpu")       # a build is not counted
    assert eng.unexpected_compiles == 0 and eng.healthz()["ok"]
    tobs.get_telemetry().record_compile("captured_step(f)", "sig=1")
    assert eng.unexpected_compiles == other.unexpected_compiles == 1
    assert not eng.healthz()["ok"]
    snap = tobs.get_registry().snapshot()
    assert snap["pt_serve_unexpected_compiles_total"]["series"] == {
        "fn=captured_step(f)": 2.0}
    eng.close()
    tobs.get_telemetry().record_compile("captured_step(g)", "sig=2")
    assert eng.unexpected_compiles == 1 and other.unexpected_compiles == 2
    other.close()


# -- with telemetry off, a serve run and a train run leave both registries empty --------

class _Shapes:
    def __init__(self):
        rng = np.random.RandomState(0)
        self.x = rng.randn(16, 3, 4, 4).astype(np.float32)
        self.y = (np.arange(16) % 4).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return 16


def test_telemetry_off_leaves_both_registries_empty(np_params, tmp_path):
    from paddle_tpu_torch import hapi, io as tio, nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import CheckpointManager
    from paddle_tpu_torch.framework.random import make_generator
    from paddle_tpu_torch.incubate.models import gpt_tiny
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.train import build_train_step, make_batch
    # serve
    jeng = JEngine(JSPEC, np_params, JConfig(**SERVE))
    jeng.generate(_prompts(1, 3), max_new_tokens=4)
    teng = ServingEngine(SPEC, np_params, ServeConfig(**SERVE), device="cpu")
    teng.generate(_prompts(1, 3), max_new_tokens=4)
    teng.close()
    # train: the hapi classifier from a loader, in both packages
    pt.seed(0)
    jnet = pt.nn.Sequential(pt.nn.Flatten(), pt.nn.Linear(48, 4))
    jm = pt.Model(jnet)
    jm.prepare(optimizer=pt.optimizer.Adam(learning_rate=0.01,
                                           parameters=jnet.parameters()),
               loss=pt.nn.CrossEntropyLoss())

    class JData(_Shapes, pt.io.Dataset):
        pass

    class TData(_Shapes, tio.Dataset):
        pass

    jm.fit(pt.io.DataLoader(JData(), batch_size=4), epochs=1, verbose=0)
    tnet = torch.nn.Sequential(torch.nn.Flatten(), tnn.Linear(
        48, 4, XavierNormal(), generator=make_generator(0, "cpu")))
    tm = hapi.Model(tnet)
    tm.prepare(optimizer=topt.Adam(learning_rate=0.01,
                                   parameters=tnet.parameters()),
               loss=tnn.CrossEntropyLoss())
    tm.fit(tio.DataLoader(TData(), batch_size=4), epochs=1, verbose=0)
    tm.evaluate(TData(), batch_size=4, verbose=0)
    # a fused GPT step and a checkpoint
    cfg = gpt_tiny()
    step = build_train_step(cfg, device="cpu", amp_o2=False, fusion=True)
    ids, labels = make_batch(cfg, 2, 32, device="cpu")
    step(ids, labels)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=1)
    mgr.save(1, {"w": torch.ones(3)})
    mgr.restore_latest()
    assert jobs.get_registry().snapshot() == {}
    assert tobs.get_registry().snapshot() == {}
    assert tobs.get_telemetry().snapshot()["steps"] == 0
