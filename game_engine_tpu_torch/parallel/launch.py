"""Local ranks: n processes of one torch.distributed world on this host.

    results = run_ranks(fn, n, *args, backend=None, device="cuda")

runs fn(rank, *args) in n new processes that have joined one world (a
FileStore rendezvous in a new temporary directory, so concurrent worlds
never meet) and returns the results in rank order. Each rank:

  - is bound to its card on "cuda" (cuda:{rank % cards}, made current
    before it joins the world, and NCCL's device), and runs torch with one
    intra-op thread (the ranks share the host's cores);
  - talks to the others over the loopback interface;
  - sends its result back as numpy arrays (tensors are copied to the host;
    bfloat16 as float32);
  - destroys its process group before it exits.

The processes fork from a fork server that has imported torch and the
port's training modules once, so a world costs a fork a rank rather than
an interpreter start. A rank that raises fails the call with its
traceback and the others are stopped; so are all of them at `timeout`
seconds. Collectives time out after mesh.TIMEOUT_S, so a rank that waits
for a dead peer fails instead of hanging. The fork server is a new
interpreter started for the purpose, never a fork of the caller: a fork of
a process that runs threads (a test runner's, JAX's, CUDA's) can copy a
lock that one of them holds.

The backend defaults to NCCL on "cuda" (one card a rank: more ranks than
cards raise, naming backend="gloo") and gloo on the CPU.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

from game_engine_tpu_torch import device as D

PRELOAD = ["torch", "torch.distributed", "game_engine_tpu_torch.train.ppo",
           "game_engine_tpu_torch.parallel.mesh"]


def _to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank: int, n: int, backend: str, device, store: str, results, args,
               kwargs) -> None:
    import torch
    import torch.distributed as dist

    from game_engine_tpu_torch.parallel.mesh import init_world

    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        init_world(backend, rank, n, device, init_method=f"file://{store}")
        results.put((rank, "ok", _to_host(fn(rank, *args, **kwargs))))
    except Exception:  # noqa: BLE001 — every failure goes back to the caller
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def stop_fork_server() -> None:
    """Stop the fork server and the resource tracker, if they run, and wait
    for both to exit. The next run_ranks starts a new fork server."""
    # the standard library's stop methods: private, present in 3.12 and later
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()  # it holds the tracker's pipe: stop it first
    resource_tracker._resource_tracker._stop()


_STOP_AT_EXIT = []


def _context():
    if not _STOP_AT_EXIT:
        atexit.register(stop_fork_server)
        _STOP_AT_EXIT.append(True)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    return ctx


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(fn, n: int, *args, backend: str | None = None, device=D.DEFAULT,
              timeout: float = 600.0, **kwargs) -> list:
    """[fn(0, *args, **kwargs), ..., fn(n - 1, ...)], each in its own rank of
    a new world of n processes. `fn` is a module-level function; `args`
    are pickled to every rank (pass numpy arrays, not tensors)."""
    from game_engine_tpu_torch.parallel.mesh import check_ranks_per_card, default_backend

    device = D.resolve(device)
    backend = backend or default_backend(device)
    check_ranks_per_card(n, backend, device)
    ctx = _context()
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, backend, device, os.path.join(tmp, "store"),
                                   results, args, kwargs), daemon=True)
                 for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {sorted(set(range(n)) - set(got))} of "
                                       f"{n} ranks gave no result in {timeout} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    # a rank that exits 0 has put its result; one that died did not
                    gone = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if gone:
                        raise RuntimeError(f"run_ranks: rank(s) {gone} (rank, exit code) "
                                           "ended without a result") from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"run_ranks: rank {rank} of {n} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"run_ranks: a rank did not exit in {timeout} s")
        finally:
            _stop(procs)
    return [got[r] for r in range(n)]
