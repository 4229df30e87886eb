"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``),
its environment contract and fleet's readers of it, on the CPU:

 - two ranks under the launcher see the same ``MASTER_PORT`` and the
   same endpoint list (one port drawn a launch), each its own rank and
   endpoint, join one gloo group and ``all_reduce``; fleet's
   ``UtilBase`` reduces and gathers over them; ``PaddleCloudRoleMaker``
   in each rank agrees field by field with the JAX package's role maker
   on that rank's environment, and ``fleet.init`` takes it;
 - a failing rank's exit code is the launch's, the other rank is
   stopped, and the end of the failing rank's ``workerlog`` is printed;
 - ``--max_restart 1`` starts the node again after a failure;
 - ``--elastic``, ``--with_store`` and ``--min_world`` raise naming
   ROADMAP Queue 1 item 6; ``--nnodes 2`` without ``--master`` raises;
 - ``build_env``: the reference's variables for every rank, and
   ``--devices``' card ids (``CUDA_VISIBLE_DEVICES``,
   ``FLAGS_selected_gpus``);
 - ``python -m paddle_tpu_torch.train --dp 2`` under the launcher runs as
   the two launched ranks (``spawn`` never called: two processes, not
   four), and the role makers and ``get_file_shard`` agree with the JAX
   package's in-process.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu_torch.distributed.launch import main as launch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 240
ROLE_FIELDS = ("worker_index", "worker_num", "is_first_worker",
               "get_trainer_endpoints", "get_pserver_endpoints",
               "server_num", "server_index", "role_id", "is_worker",
               "is_server")

_WORKER = textwrap.dedent('''
    import json, os, sys
    import torch
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed import fleet

    out, mode = sys.argv[1], sys.argv[2]
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
            "PADDLE_LOCAL_SIZE", "PADDLE_NNODES", "PADDLE_JOB_ID",
            "MASTER_ADDR", "MASTER_PORT", "PADDLE_TRAINER_ENDPOINTS",
            "PADDLE_CURRENT_ENDPOINT")
    env = {k: os.environ[k] for k in keys}
    r = int(env["PADDLE_TRAINER_ID"])
    if mode == "restart":
        marker = os.path.join(out, f"run.{r}")
        runs = int(open(marker).read()) if os.path.exists(marker) else 0
        with open(marker, "w") as f:
            f.write(str(runs + 1))
        if r == 1 and runs == 0:
            sys.exit(3)
    tdist.init_parallel_env(device="cpu")
    t = torch.full((2,), float(r + 1))
    tdist.all_reduce(t)
    role = fleet.PaddleCloudRoleMaker(is_collective=True)
    fleet.init(role_maker=role, is_collective=True)
    util = fleet.UtilBase()
    res = {"env": env, "sum": t.tolist(), "rank": tdist.get_rank(),
           "world": tdist.get_world_size(),
           "util_sum": util.all_reduce(r + 1).tolist(),
           "util_max": util.all_reduce([r, 5 - r], mode="max").tolist(),
           "util_gather": util.all_gather({"r": r}),
           "shard": util.get_file_shard(["a", "b", "c", "d", "e"]),
           "role": {k: getattr(role, k)() for k in %r}}
    if mode == "fail" and r == 1:
        print("rank 1 fails on purpose", flush=True)
        sys.exit(7)
    if mode == "fail" and r == 0:
        import time
        time.sleep(60)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    print("done", r, flush=True)
''' % (ROLE_FIELDS,))


def _launch(tmp_path, mode, *opts):
    """Run the launcher over the worker script: (code, stderr, results
    by rank)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", str(tmp_path / "log"),
           *opts, str(script), str(out), mode]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    results = {}
    for r in range(2):
        p = out / f"rank{r}.json"
        if p.exists():
            results[r] = json.loads(p.read_text())
    return proc.returncode, proc.stderr, results


def _jax_role(env, monkeypatch):
    from paddle_tpu.distributed.fleet.role_maker import PaddleCloudRoleMaker
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    role = PaddleCloudRoleMaker(is_collective=True)
    return {k: getattr(role, k)() for k in ROLE_FIELDS}


def test_two_ranks_share_one_rendezvous(tmp_path, monkeypatch):
    code, err, res = _launch(tmp_path, "ok")
    assert code == 0, err
    assert sorted(res) == [0, 1]
    e0, e1 = res[0]["env"], res[1]["env"]
    assert e0["MASTER_PORT"] == e1["MASTER_PORT"]
    assert e0["PADDLE_TRAINER_ENDPOINTS"] == e1["PADDLE_TRAINER_ENDPOINTS"]
    eps = e0["PADDLE_TRAINER_ENDPOINTS"].split(",")
    port = int(e0["MASTER_PORT"])
    assert eps == [f"127.0.0.1:{port}", f"127.0.0.1:{port + 1}"]
    for r in (0, 1):
        e = res[r]["env"]
        assert (e["PADDLE_TRAINER_ID"], e["PADDLE_LOCAL_RANK"]) == (str(r),
                                                                    str(r))
        assert (e["PADDLE_TRAINERS_NUM"], e["PADDLE_LOCAL_SIZE"],
                e["PADDLE_NNODES"], e["PADDLE_JOB_ID"]) == ("2", "2", "1",
                                                             "default")
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert res[r]["rank"] == r and res[r]["world"] == 2
        assert res[r]["sum"] == [3.0, 3.0]
        assert res[r]["util_sum"] == 3 and res[r]["util_max"] == [1, 5]
        assert res[r]["util_gather"] == [{"r": 0}, {"r": 1}]
        assert res[r]["shard"] == [["a", "b", "c"], ["d", "e"]][r]
        assert res[r]["role"] == json.loads(json.dumps(
            _jax_role(e, monkeypatch)))
    for r in (0, 1):
        assert os.path.exists(tmp_path / "log" / f"workerlog.{r}")


def test_failing_rank_code_propagates_with_its_log(tmp_path):
    code, err, res = _launch(tmp_path, "fail")
    assert code == 7
    assert "rank 1 exited with code 7" in err
    assert "rank 1 fails on purpose" in err
    # rank 0 sleeps: it was stopped, not waited for
    assert 0 not in res


def test_max_restart_reruns_the_node(tmp_path):
    code, err, res = _launch(tmp_path, "restart", "--max_restart", "1")
    assert code == 0, err
    assert "restarting (1/1)" in err
    assert (tmp_path / "out" / "run.1").read_text() == "2"
    assert sorted(res) == [0, 1]


def test_without_restarts_the_first_failure_ends_the_launch(tmp_path):
    code, err, res = _launch(tmp_path, "restart")
    assert code == 3 and "restarting" not in err


@pytest.mark.parametrize("opts", [["--elastic"], ["--with_store"],
                                  ["--min_world", "2"]])
def test_elastic_options_raise_naming_item_6(opts):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        launch_main([*opts, "train.py"])


def test_several_nodes_need_a_master():
    with pytest.raises(ValueError, match="--master"):
        launch_main(["--nnodes", "2", "--rank", "0", "train.py"])


def test_build_env_contract_and_devices():
    from paddle_tpu_torch.distributed.launch.main import build_env, parse_args
    args = parse_args(["--nnodes", "2", "--rank", "1", "--master",
                       "10.0.0.1:6170", "--devices", "4,5", "--job_id", "j",
                       "train.py", "--lr", "1"])
    assert args.training_script_args == ["--lr", "1"]
    env = build_env(args, 1, 2, ("10.0.0.1", 6170))
    assert env["PADDLE_TRAINER_ID"] == "3"
    assert env["PADDLE_TRAINERS_NUM"] == "4"
    assert env["PADDLE_LOCAL_RANK"] == "1" and env["PADDLE_LOCAL_SIZE"] == "2"
    assert env["PADDLE_TRAINER_ENDPOINTS"] == ",".join(
        f"10.0.0.1:{6170 + i}" for i in range(4))
    assert env["PADDLE_CURRENT_ENDPOINT"] == "10.0.0.1:6173"
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
    assert env["FLAGS_selected_gpus"] == "5"
    assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1", "6170")


def test_role_makers_and_file_shards_match_jax(monkeypatch):
    from paddle_tpu.distributed.fleet.role_maker import \
        UserDefinedRoleMaker as JUser
    from paddle_tpu.distributed.fleet.util import UtilBase as JUtil
    from paddle_tpu_torch.distributed import fleet
    env = {"PADDLE_TRAINER_ID": "2", "PADDLE_TRAINERS_NUM": "3",
           "PADDLE_TRAINER_ENDPOINTS": "h:1,h:2,h:3",
           "TRAINING_ROLE": "PSERVER",
           "PADDLE_PSERVERS_IP_PORT_LIST": "s:1,s:2"}
    want = _jax_role(env, monkeypatch)
    got = fleet.PaddleCloudRoleMaker()
    assert {k: getattr(got, k)() for k in ROLE_FIELDS} == want
    kw = dict(current_id=1, role=fleet.Role.WORKER, worker_num=4,
              worker_endpoints=["a:1", "a:2"], server_endpoints=["b:1"])
    j, t = JUser(**kw), fleet.UserDefinedRoleMaker(**kw)
    assert {k: getattr(t, k)() for k in ROLE_FIELDS} == \
        {k: getattr(j, k)() for k in ROLE_FIELDS}
    files = [f"part-{i}" for i in range(7)]
    for idx in range(4):
        u = fleet.UserDefinedRoleMaker(current_id=idx, worker_num=4)
        ju = JUser(current_id=idx, worker_num=4)
        assert fleet.UtilBase(u).get_file_shard(files) == \
            JUtil(ju).get_file_shard(files)
    with pytest.raises(TypeError):
        fleet.UtilBase(u).get_file_shard("part-0")


def test_fleet_init_refuses_a_role_of_another_world():
    from paddle_tpu_torch.distributed import fleet
    role = fleet.UserDefinedRoleMaker(current_id=0, worker_num=2)
    with pytest.raises(ValueError, match="worker 0 of 2"):
        fleet.init(role_maker=role)
    server = fleet.UserDefinedRoleMaker(role=fleet.Role.SERVER)
    with pytest.raises(NotImplementedError, match="parameter-server"):
        fleet.init(role_maker=server)


_TRAIN = textwrap.dedent('''
    import sys
    import paddle_tpu_torch.distributed.launch_api as launch_api

    def refuse(*a, **k):
        raise AssertionError("spawn called under the launcher")

    launch_api.spawn = refuse
    import paddle_tpu_torch.distributed as tdist
    tdist.spawn = refuse
    from paddle_tpu_torch.train import main
    sys.exit(main(sys.argv[1:]))
''')


def test_train_cli_under_the_launcher_runs_as_the_launched_ranks(tmp_path):
    script = tmp_path / "train_main.py"
    script.write_text(_TRAIN)
    env = dict(os.environ, PYTHONPATH=REPO)
    log = tmp_path / "log"
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", str(log), str(script),
           "--model", "gpt_tiny", "--dp", "2", "--batch", "4", "--seq",
           "32", "--steps", "2", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                          capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stderr + (log / "workerlog.0"
                                                ).read_text()
    lines = (log / "workerlog.0").read_text().splitlines()
    summary = json.loads(next(ln for ln in lines if ln.startswith("{")))
    assert summary["dp"] == 2 and len(summary["losses"]) == 2
    assert (log / "workerlog.1").exists()
    assert sorted(os.listdir(log)) == ["workerlog.0", "workerlog.1"]


@pytest.mark.parametrize("name", [
    "ProcessMesh", "shard_tensor", "shard_layer", "dtensor_from_fn",
    "reshard", "Shard", "Replicate", "Partial", "Engine", "to_static",
    "launch", "rpc", "ps", "CountFilterEntry", "ProbabilityEntry",
    "ShowClickEntry"])
def test_distributed_exports_the_reference_names(name):
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist_
    assert hasattr(jdist, name)
    assert name in tdist_.__all__ and hasattr(tdist_, name)
