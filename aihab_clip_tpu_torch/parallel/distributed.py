"""Multi-process plumbing over ``torch.distributed`` (counterpart of
``aihab_clip_tpu/parallel/distributed.py``).

Every process runs the same program.  ``initialize_distributed`` wires
the process group from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``python -m torch.distributed.run`` sets them) or from explicit
arguments: NCCL for ranks on the card, gloo for ranks on the CPU (or for
ranks that share one card, which NCCL refuses).  A single process is a
no-op.  The data pipeline shards the sample index space per process
(``process_shard_indices``, the JAX package's seeded permutation bit for
bit), and ``make_global_batch`` assembles rank-local shards into the
global batch (their concatenation by rank).
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..backend import resolve_device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK}`` on the card (raises
    without one), the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: float = 600.0) -> None:
    """Initialize the process group (a no-op for one process).

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``backend`` defaults to NCCL on the card
    and gloo on the CPU; pass ``"gloo"`` for ranks that share one card.
    On the card each rank's current device becomes ``cuda:{LOCAL_RANK}``."""
    n = int(num_processes if num_processes is not None
            else os.environ.get("WORLD_SIZE", 1))
    if n <= 1 or is_initialized():
        return
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)


def shutdown_distributed() -> None:
    if is_initialized():
        dist.destroy_process_group()


def process_shard_indices(n: int, seed: int = 0,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          even: bool = False) -> np.ndarray:
    """Deterministic per-process shard of the sample index space (JAX's,
    bit for bit): every process draws the same seeded permutation and
    takes its contiguous slice, sorted.  Uneven by default (the last
    process takes the remainder); ``even=True`` gives every process
    ceil(n / count) samples, the short shards padded by wrapping into the
    front of the permutation (duplicates across processes, never within
    one), for lockstep consumers."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    order = np.random.RandomState(seed).permutation(n)
    if even:
        per = -(-n // pc)
        idx = np.arange(pi * per, (pi + 1) * per) % n
        return np.sort(order[idx])
    per = n // pc
    start = pi * per
    end = start + per if pi < pc - 1 else n
    return np.sort(order[start:end])


def make_global_batch(mesh, *local_arrays):
    """Rank-local batch shards -> the global batch on every rank: the
    shards of the mesh's data axis concatenated by rank (each rank's
    shard must have the same shape).  Returns tensors on the mesh's
    device."""
    from . import comm

    out = []
    for a in local_arrays:
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        out.append(comm.all_gather_cat(t.to(mesh.device), mesh, "data", 0))
    return tuple(out) if len(out) > 1 else out[0]


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: Sequence[str], nproc: int, timeout: float, *,
                env: Optional[dict] = None, cwd=None,
                one_device: bool = False) -> List[str]:
    """Run ``python <cmd>`` as ``nproc`` ranks on this host (the launcher's
    environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` on a free port); ``one_device`` gives every rank
    ``LOCAL_RANK=0`` (ranks that share one card).  Each rank runs in a
    process group of its own; when one fails or ``timeout`` seconds pass,
    every rank still running is killed and ``RuntimeError`` carries the
    ranks' output.  Returns each rank's output."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    procs = []
    for r in range(nproc):
        e = dict(base, RANK=str(r), WORLD_SIZE=str(nproc),
                 LOCAL_RANK="0" if one_device else str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, *cmd], env=e, cwd=cwd, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    outs: List[Optional[str]] = [None] * nproc
    failed = None
    while failed is None and any(o is None for o in outs):
        for r, p in enumerate(procs):
            if outs[r] is not None:
                continue
            try:
                outs[r], _ = p.communicate(timeout=0.5)
            except subprocess.TimeoutExpired:
                continue
            if p.returncode != 0:
                failed = f"rank {r} exited {p.returncode}"
        if failed is None and time.monotonic() > deadline:
            failed = f"timed out after {timeout:.0f}s"
    if failed is not None:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for r, p in enumerate(procs):
            if outs[r] is None:
                outs[r] = p.communicate()[0] or ""
        raise RuntimeError(f"{' '.join(cmd)} on {nproc} ranks: {failed}\n"
                           + "\n---\n".join(f"[rank {r}] {o[-2000:]}"
                                              for r, o in enumerate(outs)))
    return [o or "" for o in outs]
