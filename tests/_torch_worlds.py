"""Gloo worlds of CPU ranks for the port's parallel-layer tests.

``run_world(case, n, tmp_path, **params)`` starts ``n`` processes of this
file; each joins a gloo world (rendezvous through a ``FileStore`` in
``tmp_path``, so parallel test workers never share a port; 60 s init
timeout), runs ``CASES[case](rank, world, params, out)`` and writes
``out`` to ``tmp_path/rank<r>.npz``. The parent kills the world when its
join timeout passes or a rank fails. The ranks import no JAX: this file
imports only torch, numpy and the port.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
INIT_TIMEOUT_S = 60


def run_world(case: str, n: int, tmp_path, timeout: float = 240.0,
              init: bool = True, **params) -> list:
    """Run ``case`` on ``n`` ranks; returns each rank's results (dicts of
    numpy arrays) in rank order. ``init=False`` leaves the process group
    to the case (a world of one that ``make_mesh`` starts)."""
    tmp = pathlib.Path(tmp_path)
    (tmp / "params.json").write_text(json.dumps(params))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    logs = [open(tmp / f"rank{r}.log", "wb") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(r), str(n), str(tmp),
         "1" if init else "0"],
        cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > deadline:
                failed = "timeout"
                break
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.returncode), None)
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        log = (tmp / f"rank{r}.log").read_bytes()
        raise AssertionError(
            f"world {case!r} failed ({failed}); rank {r} output:\n"
            + log.decode(errors="replace")[-6000:])
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False))
            for r in range(n)]


def _main(argv) -> None:
    case, rank, world, tmp, init = argv[1:6]
    rank, world, tmp = int(rank), int(world), pathlib.Path(tmp)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if init == "1":
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp / "store"), world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=INIT_TIMEOUT_S))
    import _torch_world_cases as cases

    params = json.loads((tmp / "params.json").read_text())
    out: dict = {}
    getattr(cases, case)(rank, world, params, out)
    np.savez(tmp / f"rank{rank}.npz",
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    _main(sys.argv)
