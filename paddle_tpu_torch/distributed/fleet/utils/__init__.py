"""``fleet.utils`` (the counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``): the local and HDFS
file systems, and ``recompute`` / ``recompute_sequential`` where the
reference's public API has them.  ``DistributedInfer`` rewrites a static
``Program`` and waits for ``static`` (ROADMAP Queue 1 item 9)."""
from __future__ import annotations

import os
import shutil
import subprocess

from ..recompute import recompute, recompute_sequential

__all__ = ["LocalFS", "HDFSClient", "DistributedInfer", "recompute",
           "recompute_sequential"]


class LocalFS:
    """The local file system (the reference's ``fleet/utils/fs.py``
    ``LocalFS``)."""

    def ls_dir(self, path):
        """(directories, files) directly under ``path``; empty lists when
        it is not a directory."""
        if not os.path.isdir(path):
            return [], []
        entries = os.listdir(path)
        dirs = [e for e in entries
                if os.path.isdir(os.path.join(path, e))]
        files = [e for e in entries
                 if not os.path.isdir(os.path.join(path, e))]
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)


class HDFSClient:
    """HDFS through the ``hadoop fs`` command line, as the reference's
    ``fleet/utils/fs.py`` ``HDFSClient`` does: ``<hadoop_home>/bin/hadoop
    fs -D k=v ... <command>``, each call bounded by ``time_out``
    milliseconds.  Without a hadoop installation it raises at once."""

    def __init__(self, hadoop_home, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        self._base = os.path.join(hadoop_home, "bin", "hadoop")
        if not os.path.exists(self._base):
            raise RuntimeError(
                f"hadoop binary not found at {self._base}; HDFSClient "
                f"needs a hadoop installation (hadoop_home)")
        self._cfg = []
        for k, v in (configs or {}).items():
            self._cfg += ["-D", f"{k}={v}"]
        self._timeout = time_out / 1000.0

    def _run(self, *args):
        out = subprocess.run([self._base, "fs"] + self._cfg + list(args),
                             capture_output=True, text=True,
                             timeout=self._timeout)
        return out.returncode, out.stdout, out.stderr

    def is_exist(self, path):
        rc, _, _ = self._run("-test", "-e", path)
        return rc == 0

    def is_dir(self, path):
        rc, _, _ = self._run("-test", "-d", path)
        return rc == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def ls_dir(self, path):
        """(directories, files) from ``-ls``'s listing; empty lists when
        the listing fails."""
        rc, out, _ = self._run("-ls", path)
        if rc != 0:
            return [], []
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def mkdirs(self, path):
        rc, _, err = self._run("-mkdir", "-p", path)
        if rc != 0:
            raise RuntimeError(f"hdfs mkdirs failed: {err.strip()}")

    def delete(self, path):
        # -f: a missing path is a success; a real failure raises
        rc, _, err = self._run("-rm", "-r", "-f", path)
        if rc != 0:
            raise RuntimeError(f"hdfs delete failed: {err.strip()}")

    def upload(self, local_path, fs_path, multi_processes=1,
               overwrite=False):
        if overwrite:
            self.delete(fs_path)
        rc, _, err = self._run("-put", local_path, fs_path)
        if rc != 0:
            raise RuntimeError(f"hdfs upload failed: {err.strip()}")

    def download(self, fs_path, local_path, multi_processes=1,
                 overwrite=False):
        rc, _, err = self._run("-get", fs_path, local_path)
        if rc != 0:
            raise RuntimeError(f"hdfs download failed: {err.strip()}")

    def touch(self, fs_path, exist_ok=True):
        rc, _, err = self._run("-touchz", fs_path)
        if rc != 0 and not exist_ok:
            raise RuntimeError(f"hdfs touch failed: {err.strip()}")

    def mv(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        rc, _, err = self._run("-mv", src, dst)
        if rc != 0:
            raise RuntimeError(f"hdfs mv failed: {err.strip()}")

    def cat(self, fs_path):
        rc, out, _ = self._run("-cat", fs_path)
        return out if rc == 0 else ""


class DistributedInfer:
    """The parameter-server inference helper of the reference
    (``fleet/utils/ps_util.py``) rewrites a static ``Program``: it waits
    for ``static`` (ROADMAP Queue 1 item 9)."""

    def __init__(self, main_program=None, startup_program=None):
        raise NotImplementedError(
            "fleet.utils.DistributedInfer rewrites a static Program, which "
            "the port does not have yet (ROADMAP Queue 1 item 9: static)")
