"""Role makers (the counterpart of
``paddle_tpu/distributed/fleet/role_maker.py``): who this process is in
the job, read from the launcher's environment
(:mod:`..launch.main`): ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, and the parameter-server pair
``TRAINING_ROLE`` / ``PADDLE_PSERVERS_IP_PORT_LIST``.  ``fleet.init``
takes one (:class:`PaddleCloudRoleMaker` or
:class:`UserDefinedRoleMaker`): its worker count must be the world's."""
from __future__ import annotations

import os

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class PaddleCloudRoleMaker:
    """The role from the environment (module docstring)."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        self._kwargs = dict(kwargs)
        self._generate()

    def _generate(self):
        env = os.environ
        self._role = {"TRAINER": Role.WORKER, "PSERVER": Role.SERVER,
                      "HETER_TRAINER": Role.HETER_WORKER}.get(
            env.get("TRAINING_ROLE", "TRAINER"), Role.WORKER)
        self._current_id = int(env.get("PADDLE_TRAINER_ID", 0))
        self._worker_num = int(env.get("PADDLE_TRAINERS_NUM", 1))
        eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        seps = env.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in seps.split(",") if e]

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    is_worker = _is_worker
    is_server = _is_server

    def is_first_worker(self):
        return self._is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id if self._is_server() else -1

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def role_id(self):
        return self._current_id

    def to_string(self):
        return (f"role={self._role} id={self._current_id} "
                f"workers={self._worker_num} "
                f"worker_endpoints={self._worker_endpoints} "
                f"server_endpoints={self._server_endpoints}")


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """The role given directly: ``current_id``, ``role``, ``worker_num``,
    ``worker_endpoints``, ``server_endpoints``."""

    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        self._init_kwargs = dict(kwargs)
        super().__init__(is_collective=is_collective, **kwargs)

    def _generate(self):
        kw = self._init_kwargs
        self._role = kw.get("role", Role.WORKER)
        self._current_id = int(kw.get("current_id", 0))
        self._worker_num = int(kw.get("worker_num", 1))
        self._worker_endpoints = list(kw.get("worker_endpoints", []))
        self._server_endpoints = list(kw.get("server_endpoints", []))
