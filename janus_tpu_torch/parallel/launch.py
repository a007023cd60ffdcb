"""A group of ranks on one machine: the port's counterpart of the JAX
package's virtual CPU devices (``xla_force_host_platform_device_count``).

:func:`run_ranks` starts ``world_size`` processes, joins them in one
process group and calls the same function in each. The tests run their
multi-rank cases through it on the CPU (gloo), ``eval/scaling.py`` runs
each mesh size through it, and ``chip_smoke.py`` its one-card phases.

- Processes come from a ``forkserver`` context: the server is a fresh
  interpreter (with torch and this module preloaded), so no rank inherits
  a parent's threads, JAX's in a pytest worker among them.
- Ranks meet through a ``FileStore`` in a fresh temporary directory, so
  that concurrent groups (pytest-xdist workers) never share a port.
- Every wait has a deadline: when a rank raises, exits or outlives the
  timeout, every rank is killed and the call raises.
- A group whose ranks fail to join (``init_process_group`` raising, as
  gloo's full-mesh connect does now and then on a machine where other
  groups start at the same moment: "Connection closed by peer") is
  stopped and started again in a fresh store, up to
  :data:`JOIN_TRIES` times within the one deadline.
- The server and multiprocessing's resource tracker outlive a call, so
  that the next call starts its ranks at once. :func:`stop_rank_server`
  stops both and waits for them; it runs at the exit of any process that
  called :func:`run_ranks`, so that no process of the group outlives its
  caller.
"""

from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
from multiprocessing import connection, forkserver, resource_tracker, util
from typing import Any, Callable, List, Sequence

import torch

__all__ = ["run_ranks", "stop_rank_server"]

_PRELOAD = ["janus_tpu_torch.parallel.launch"]
JOIN_TRIES = 3   # starts of a group whose ranks failed to join


def _to_host(obj: Any) -> Any:
    """Tensors in a result moved to the CPU (a rank's card is gone when
    the parent reads it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn: Callable, args: Sequence, rank: int, world_size: int,
               store_path: str, backend: str, device_type: str,
               threads: int, timeout_s: float, conn) -> None:
    import torch.distributed as dist

    status, payload = "failed", b""
    try:
        torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        status = "join"
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        status = "failed"
        payload = pickle.dumps(_to_host(fn(*args)))
        status = "ok"
    except Exception:  # reported to the parent, which raises or retries
        payload = traceback.format_exc().encode()
    conn.send((status, payload))
    conn.close()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, device: str = "cuda",
              args: Sequence = (), timeout: float = 300.0) -> List[Any]:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    process in one group. ``fn`` is pickled by reference (a module-level
    function; each rank imports its module and the caller's main module,
    so a script guards its work with ``if __name__ == "__main__"``);
    tensors in its result come back on the CPU.

    ``device`` is ``"cuda"`` (rank r on card ``r % device_count``) or
    ``"cpu"``. The group runs on NCCL when every rank has a card of its
    own, on gloo otherwise (the CPU, or more ranks than cards). A group
    whose ranks fail to join is started again (at most
    :data:`JOIN_TRIES` times). Raises ``RuntimeError`` with the rank's
    traceback when a rank fails, and ``TimeoutError`` when the group has
    not finished within ``timeout`` seconds; every rank is stopped either
    way."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    backend = ("nccl" if device_type == "cuda"
               and world_size <= torch.cuda.device_count() else "gloo")
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    threads = max(1, min(4, (os.cpu_count() or 1) // world_size))
    deadline = time.monotonic() + timeout
    for tries in range(1, JOIN_TRIES + 1):
        try:
            return _run_group(ctx, fn, tuple(args), world_size, backend,
                              device_type, threads, timeout, deadline)
        except _JoinError as e:
            if tries == JOIN_TRIES:
                raise RuntimeError(f"{e} (the group was started "
                                   f"{JOIN_TRIES} times)") from None


class _JoinError(RuntimeError):
    """A rank of the group failed in ``init_process_group``."""


def _run_group(ctx, fn: Callable, args: tuple, world_size: int,
               backend: str, device_type: str, threads: int,
               timeout: float, deadline: float) -> List[Any]:
    """One start of the group in a fresh store: its results, or a raise
    (:class:`_JoinError` where a rank failed to join); every rank is
    stopped and reaped either way."""
    tmp = tempfile.mkdtemp(prefix="janus_ranks_")
    pipes = [ctx.Pipe(duplex=False) for _ in range(world_size)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world_size,
                               os.path.join(tmp, "store"), backend,
                               device_type, threads, timeout, pipes[r][1]))
             for r in range(world_size)]
    out: dict = {}
    try:
        for p, (_, send) in zip(procs, pipes):
            p.start()
            send.close()  # the rank holds the only write end
        waiting = {pipes[r][0]: r for r in range(world_size)}
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within "
                    f"{timeout} s (done: {sorted(out)})")
            for recv in connection.wait(list(waiting), timeout=left):
                rank = waiting.pop(recv)
                try:
                    status, payload = recv.recv()
                except EOFError:  # the rank exited before it sent
                    procs[rank].join(timeout=10)
                    raise RuntimeError(
                        f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} and no result")
                if status != "ok":
                    error = _JoinError if status == "join" else RuntimeError
                    raise error(f"rank {rank} of {world_size} failed:\n"
                                f"{payload.decode()}")
                out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        for recv, send in pipes:
            recv.close()
            send.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _stop_helper(owner, pid_attr: str, fd_attr: str, timeout: float) -> None:
    """Close the pipe whose end of file asks a multiprocessing helper
    process to exit, and reap it; kill it if it has not exited within
    ``timeout`` seconds (another process may still hold the pipe)."""
    with owner._lock:
        pid, fd = getattr(owner, pid_attr), getattr(owner, fd_attr)
        if pid is None or fd is None:
            return
        os.close(fd)
        setattr(owner, fd_attr, None)
        setattr(owner, pid_attr, None)
        deadline = time.monotonic() + timeout
        try:
            while os.waitpid(pid, os.WNOHANG)[0] == 0:
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    return
                time.sleep(0.01)
        except ChildProcessError:  # reaped already
            pass


def stop_rank_server(timeout: float = 10.0) -> None:
    """Stop the forkserver that :func:`run_ranks` starts, then the resource
    tracker it starts with it (the server holds the tracker's pipe), and
    wait for both to exit. A later :func:`run_ranks` starts them anew."""
    server = forkserver._forkserver
    address = server._forkserver_address
    _stop_helper(server, "_forkserver_pid", "_forkserver_alive_fd", timeout)
    if address is not None:
        server._forkserver_address = None
        if not util.is_abstract_socket_namespace(address):
            try:
                os.unlink(address)
            except OSError:
                pass
    _stop_helper(resource_tracker._resource_tracker, "_pid", "_fd", timeout)


atexit.register(stop_rank_server)
