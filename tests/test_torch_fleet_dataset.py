"""The port's fleet datasets, data generators, ``fleet.utils`` and
``distributed.utils`` against the JAX package's, on the CPU (mirrors
``tests/test_ps_dataset_io.py``, without its ``static`` cases): the same
slot files through ``pipe_command`` give the same batches, and one
``random.seed`` the same shuffled order; the parse and static-size errors
raise; the generators write the same text; ``LocalFS`` and
``HDFSClient`` (over a stand-in ``hadoop`` script) behave alike; and
``global_scatter`` / ``global_gather`` in two gloo ranks are
``alltoall_single``."""
import io
import os
import random
import stat
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import dataset as jds
from paddle_tpu.distributed.fleet import utils as jutils
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet import dataset as tds
from paddle_tpu_torch.distributed.fleet import utils as tutils

SPAWN_TIMEOUT = 60


def _write_multislot(path, rows):
    with open(path, "w") as f:
        for dense, ids in rows:
            f.write(f"{len(dense)} " + " ".join(map(str, dense)) + " "
                    + f"{len(ids)} " + " ".join(map(str, ids)) + "\n")


class _Var:
    def __init__(self, name, dtype, shape=None):
        self.name, self.dtype, self.shape = name, dtype, shape


@pytest.fixture
def slot_files(tmp_path):
    rng = np.random.RandomState(0)
    files = []
    for k in range(3):
        rows = [(np.round(rng.rand(2), 3).tolist(),
                 rng.randint(0, 100, rng.randint(1, 5)).tolist())
                for _ in range(5 + k)]
        p = str(tmp_path / f"part-{k}.txt")
        _write_multislot(p, rows)
        files.append(p)
    return files


def _make(mod, cls, files, batch_size=4, pipe="cat"):
    ds = getattr(mod, cls)()
    ds.init(batch_size=batch_size, thread_num=1,
            use_var=[_Var("dense", "float32", [-1, 2]),
                     _Var("ids", "int64")],
            pipe_command=pipe)
    ds.set_filelist(files)
    return ds


def _same_batches(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        np.testing.assert_array_equal(x["dense"], y["dense"])
        assert x["dense"].dtype == y["dense"].dtype == np.float32
        assert isinstance(x["ids"], list) and isinstance(y["ids"], list)
        assert [i.tolist() for i in x["ids"]] == [i.tolist()
                                                  for i in y["ids"]]
        assert all(i.dtype == np.int64 for i in x["ids"])


@pytest.mark.parametrize("pipe", ["cat", "head -n 3", "tac"])
def test_queue_dataset_streams_the_jax_batches(slot_files, pipe):
    got = list(_make(tds, "QueueDataset", slot_files, pipe=pipe))
    _same_batches(got, list(_make(jds, "QueueDataset", slot_files,
                                  pipe=pipe)))
    n = sum(len(b["dense"]) for b in got)
    assert n == (9 if pipe.startswith("head") else 18)


def test_in_memory_dataset_shuffles_in_the_jax_order(slot_files):
    t = _make(tds, "InMemoryDataset", slot_files)
    j = _make(jds, "InMemoryDataset", slot_files)
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(t)
    for ds in (t, j):
        ds.load_into_memory()
    assert t.get_memory_data_size() == j.get_memory_data_size() == 18
    _same_batches(list(t), list(j))
    for how in ("local_shuffle", "global_shuffle"):
        random.seed(7)
        getattr(t, how)()
        random.seed(7)
        getattr(j, how)()
        _same_batches(list(t), list(j))
    random.seed(3)
    t.load_into_memory(is_shuffle=True)
    random.seed(3)
    j.load_into_memory(is_shuffle=True)
    _same_batches(list(t), list(j))
    assert t.get_shuffle_data_size() == 18
    t._init_distributed_settings(parse_ins_id=True)
    t.update_settings(batch_size=8, merge_size=2)
    assert t.batch_size == 8 and t._distributed_settings == {
        "parse_ins_id": True, "merge_size": 2}
    t.release_memory()
    assert t.get_memory_data_size() == 0
    assert t.get_filelist() == slot_files


@pytest.mark.parametrize("line,use_var", [
    ("2 1.0\n", [_Var("dense", "float32")]),                 # too few values
    ("2 1.0 2.0\n3 1.0 2.0 3.0\n", [_Var("dense", "float32", [-1, 2])]),
    ("1 1.0 5\n", [_Var("dense", "float32")]),               # trailing
    ("1 1.0\n", [_Var("dense", "float32"), _Var("ids", "int64")]),
])
def test_parse_errors_raise_like_jax(tmp_path, line, use_var):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write(line)
    for mod in (tds, jds):
        ds = _make(mod, "QueueDataset", [p])
        ds.use_var = use_var
        with pytest.raises(ValueError, match="MultiSlot parse error"):
            list(ds)


def test_a_failing_pipe_command_raises(slot_files):
    ds = _make(tds, "QueueDataset", slot_files, pipe="cat; exit 3")
    with pytest.raises(RuntimeError, match="exited with status 3"):
        list(ds)


# -- the data generators ----------------------------------------------------------

def _generators(mod):
    class Ints(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                a, b = line.split(",")
                yield [("dense", [float(a), int(b)]),
                       ("ids", [int(b), int(b) + 1, 7])]
                if int(b) % 2:
                    yield None
            return it

    class Strs(mod.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def it():
                yield (("words", line.strip().split(",")),)
            return it

    class Batched(Ints):
        def generate_batch(self, samples):
            def it():
                for s in reversed(samples):
                    yield s
            return it
    return Ints, Strs, Batched


@pytest.mark.parametrize("batch", [1, 2, 32])
def test_generators_write_the_jax_text(batch):
    lines = ["0.5,1", "2.25,2", "3,3", "4,44", "5.5,5"]
    outs = []
    for mod in (tfleet, jfleet):
        text = []
        for cls in _generators(mod):
            g = cls()
            g.set_batch(batch)
            buf = io.StringIO()
            g._run(lines, out=buf)
            text.append(buf.getvalue())
        outs.append(text)
    assert outs[0] == outs[1]
    assert outs[0][0].splitlines()[0] == "2 0.5 1 3 1 2 7"


def test_generator_errors_match_jax():
    for mod in (tfleet, jfleet):
        with pytest.raises(NotImplementedError):
            mod.DataGenerator().generate_sample("x")
        with pytest.raises(NotImplementedError):
            mod.DataGenerator()._gen_str([])
        with pytest.raises(ValueError, match="list or tuple"):
            mod.MultiSlotDataGenerator()._gen_str("nope")
        with pytest.raises(ValueError, match="are empty"):
            mod.MultiSlotDataGenerator()._gen_str([("s", [])])


def test_generator_feeds_a_queue_dataset_through_its_pipe(tmp_path):
    script = tmp_path / "gen.py"
    script.write_text(
        "import sys\n"
        "from paddle_tpu_torch.distributed.fleet import "
        "MultiSlotDataGenerator\n"
        "class G(MultiSlotDataGenerator):\n"
        "    def generate_sample(self, line):\n"
        "        def it():\n"
        "            a, b = line.split()\n"
        "            yield [('dense', [float(a), float(b)]),\n"
        "                   ('ids', [int(float(b))])]\n"
        "        return it\n"
        "G().run_from_stdin()\n")
    raw = tmp_path / "raw.txt"
    raw.write_text("1 2\n3 4\n5 6\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pipe = f"PYTHONPATH={repo} {sys.executable} {script}"
    [batch] = list(_make(tds, "QueueDataset", [str(raw)], pipe=pipe))
    np.testing.assert_array_equal(batch["dense"], [[1, 2], [3, 4], [5, 6]])
    assert [i.tolist() for i in batch["ids"]] == [[2], [4], [6]]


# -- fleet.utils ---------------------------------------------------------------------

def test_local_fs_matches_jax(tmp_path):
    for mod, root in ((tutils, tmp_path / "t"), (jutils, tmp_path / "j")):
        fs = mod.LocalFS()
        assert fs.ls_dir(str(root)) == ([], [])
        fs.mkdirs(str(root / "a" / "b"))
        (root / "f.txt").write_text("x")
        assert fs.is_exist(str(root / "a"))
        dirs, files = fs.ls_dir(str(root))
        assert (sorted(dirs), sorted(files)) == (["a"], ["f.txt"])
        fs.delete(str(root / "a"))
        fs.delete(str(root / "f.txt"))
        fs.delete(str(root / "missing"))
        assert fs.ls_dir(str(root)) == ([], [])


_FAKE_HADOOP = r'''#!/bin/sh
# a stand-in for `hadoop fs` over a local directory: logs each call
echo "$@" >> "$HADOOP_LOG"
shift  # fs
while [ "$1" = "-D" ]; do shift 2; done
cmd=$1; shift
case $cmd in
  -test) flag=$1; p=$2
         if [ "$flag" = "-e" ]; then [ -e "$p" ]; exit $?; fi
         if [ "$flag" = "-d" ]; then [ -d "$p" ]; exit $?; fi ;;
  -ls) [ -d "$1" ] || exit 1
       for f in "$1"/*; do
         if [ -d "$f" ]; then t=drwxr-xr-x; else t=-rw-r--r--; fi
         echo "$t 1 u g 0 2026-01-01 00:00 $f"; done ;;
  -mkdir) mkdir "$@" ;;
  -rm) shift 2; rm -rf "$1" ;;
  -put) cp "$1" "$2" ;;
  -get) cp "$1" "$2" ;;
  -touchz) [ -e "$1" ] && { echo "exists" >&2; exit 1; }; : > "$1" ;;
  -mv) mv "$1" "$2" ;;
  -cat) cat "$1" ;;
  *) exit 2 ;;
esac
'''


def _hdfs(mod, home, configs):
    return mod.HDFSClient(str(home), configs=configs, time_out=30000)


def test_hdfs_client_over_a_stand_in_hadoop(tmp_path, monkeypatch):
    home = tmp_path / "hadoop"
    (home / "bin").mkdir(parents=True)
    exe = home / "bin" / "hadoop"
    exe.write_text(_FAKE_HADOOP)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    for mod, name in ((tutils, "t"), (jutils, "j")):
        log = tmp_path / f"{name}.log"
        monkeypatch.setenv("HADOOP_LOG", str(log))
        fs = _hdfs(mod, home, {"fs.default.name": "hdfs://x:9000"})
        root = tmp_path / f"fs_{name}"
        fs.mkdirs(str(root / "d"))
        assert fs.is_exist(str(root)) and fs.is_dir(str(root / "d"))
        local = tmp_path / f"local_{name}.txt"
        local.write_text("hello")
        fs.upload(str(local), str(root / "f.txt"))
        assert fs.is_file(str(root / "f.txt"))
        assert fs.cat(str(root / "f.txt")) == "hello"
        assert fs.ls_dir(str(root)) == (["d"], ["f.txt"])
        fs.touch(str(root / "f.txt"))                       # exist_ok
        with pytest.raises(RuntimeError, match="touch"):
            fs.touch(str(root / "f.txt"), exist_ok=False)
        fs.mv(str(root / "f.txt"), str(root / "g.txt"), overwrite=True)
        fs.download(str(root / "g.txt"), str(tmp_path / f"back_{name}"))
        assert (tmp_path / f"back_{name}").read_text() == "hello"
        fs.delete(str(root))
        assert not fs.is_exist(str(root))
        assert fs.ls_dir(str(root)) == ([], [])
        assert fs.cat(str(root / "none")) == ""
        with pytest.raises(RuntimeError, match="upload"):
            fs.upload(str(tmp_path / "missing"), str(root / "x"))
    strip = [line.replace("fs_t", "fs_X").replace("local_t", "local_X")
             .replace("back_t", "back_X")
             for line in (tmp_path / "t.log").read_text().splitlines()]
    want = [line.replace("fs_j", "fs_X").replace("local_j", "local_X")
            .replace("back_j", "back_X")
            for line in (tmp_path / "j.log").read_text().splitlines()]
    assert strip == want and strip[0].startswith(
        "fs -D fs.default.name=hdfs://x:9000 -mkdir -p")
    for mod in (tutils, jutils):
        with pytest.raises(RuntimeError, match="hadoop"):
            mod.HDFSClient(str(tmp_path / "no_hadoop"))


def test_distributed_infer_waits_for_static():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        tutils.DistributedInfer()


def test_recompute_sequential_matches_the_plain_run():
    torch.manual_seed(0)
    seq = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(4)])
    x = torch.randn(3, 8, requires_grad=True)
    want = seq(x)
    want.sum().backward()
    g_want = [p.grad.clone() for p in seq.parameters()] + [x.grad.clone()]
    seq.zero_grad()
    x.grad = None
    got = tutils.recompute_sequential({"segments": 2}, seq, x)
    got.sum().backward()
    g_got = [p.grad for p in seq.parameters()] + [x.grad]
    torch.testing.assert_close(got, want)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b)
    assert tutils.recompute is tfleet.recompute
    assert tfleet.recompute_sequential is tutils.recompute_sequential


# -- distributed.utils -----------------------------------------------------------------

def _scatter_gather_rank():
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    tdist.init_parallel_env(device="cpu")
    me = tdist.get_rank()
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * me
    counts = torch.tensor([3, 1])             # not read, as in the JAX package
    s = global_scatter(x, counts, counts)
    back = global_gather(s, counts, counts)
    return x.numpy(), s.numpy(), tdist.alltoall_single(x).numpy(), \
        back.numpy()


def test_global_scatter_and_gather_are_alltoall_single(tmp_path):
    res = spawn(_scatter_gather_rank, nprocs=2,
                store=str(tmp_path / "store"), timeout=SPAWN_TIMEOUT)
    for r, (x, s, a2a, back) in enumerate(res):
        np.testing.assert_array_equal(s, a2a)
        np.testing.assert_array_equal(back, x)
        other = res[1 - r][0]
        np.testing.assert_array_equal(
            s, np.concatenate([res[0][0][2 * r:2 * r + 2],
                               res[1][0][2 * r:2 * r + 2]]))
        assert other.shape == x.shape
