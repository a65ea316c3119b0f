"""Start a group of ranks on this machine: the helper that the tests,
``chip_smoke.py``, ``entry.dryrun_multichip`` and ``cli/stream_demo``
use.  The parallel layer itself owns no launcher policy: it reads an
initialised default process group (:mod:`.multihost` joins one from
torchrun's environment).

:func:`spawn` starts ``n`` fresh interpreters (``torch.multiprocessing``,
spawn method), joins them through a ``file://`` rendezvous in a temporary
directory, runs one module-level function on every rank and returns each
rank's result.  Every collective has the process group's timeout, the join
has a deadline, and a rank that fails or hangs brings the whole group down
(the survivors are killed) with its traceback in the error.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch

from .mesh import transport_for


def _rank_main(rank, n, init_file, backend, timeout, fn, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    # the ranks share the machine's cores
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, n_ranks: int, *args, device="cuda", timeout: float = 120.0) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined in one process
    group and return their results in rank order.

    ``fn`` must be importable (a module-level function) and its arguments
    and result picklable; a result holds host data (numbers, numpy), never
    a CUDA tensor.  The transport is :func:`.mesh.transport_for` ``device``.
    ``timeout`` bounds each collective and, from the start, the whole run:
    past it every rank still alive is killed and this raises.  Each rank
    runs torch on one thread."""
    ctx = torch.multiprocessing.get_context("spawn")
    backend = transport_for(device, n_ranks)
    tmp = tempfile.mkdtemp(prefix="auvtpu_rdv_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, os.path.join(tmp, "rendezvous"), backend, timeout,
                                                  fn, args, results))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    got, error = {}, None
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a child blocks on exit until its
        # result is read
        while len(got) < n_ranks and error is None:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue_mod.Empty:
                silent = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if silent:
                    error = f"rank {silent[0]} exited with code {procs[silent[0]].exitcode} and no result"
                elif time.monotonic() > deadline:
                    error = f"ranks {sorted(set(range(n_ranks)) - set(got))} still running after {timeout} s"
                continue
            if ok:
                got[rank] = out
            else:
                error = f"rank {rank} failed:\n{out}"
        # a failed rank's peers fail next, on its closed connections: their
        # reports follow the first one's
        end = time.monotonic() + 2.0
        while error is not None and time.monotonic() < end:
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            if not ok:
                error += f"\nrank {rank} failed:\n{out}"
        for p in procs:
            p.join(max(0.0, min(10.0, deadline - time.monotonic())) if error is None else 0.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"spawn of {n_ranks} ranks ({backend}): {error}")
    return [got[r] for r in range(n_ranks)]
