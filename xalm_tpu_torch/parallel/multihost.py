"""Multi-process (multi-host) execution on ``torch.distributed``
(counterpart of ``xalm_tpu/parallel/multihost.py``).

Every rank is one process running the SAME program (SPMD).
``init_distributed`` joins this process to the world: NCCL for a rank on
the card, gloo for one on the CPU (or as asked), and picks the rank's
device. Host values then become shards with ``make_global`` (every process
passes the full value: tokens, positions) or ``host_local_to_global``
(each process passes its dp rows of the batch); ``all_hosts`` gathers a
sharded value back to every process.

``spawn_ranks`` starts the other ranks of a world on this host, as the
harness and the server do when started plainly with a parallel flag
above 1: this process is rank 0 and each child runs the same command with
``XALM_PROCESS_ID`` set.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "make_global",
    "host_local_to_global",
    "all_hosts",
    "GlobalArray",
    "local_device",
    "spawn_ranks",
    "wait_ranks",
    "distributed_requested",
]

_DEVICE: list[torch.device] = []  # this rank's device, once init_distributed chose it
_STORES: list[str] = []  # the temporary directories of spawn_ranks' file stores


def local_device() -> torch.device:
    """This rank's device: the one ``init_distributed`` chose, else the card."""
    return _DEVICE[0] if _DEVICE else torch.device("cuda")


def distributed_requested(coordinator=None) -> bool:
    """Whether this process was started as one rank of a world: a
    coordinator given, ``XALM_COORDINATOR`` set, or torchrun's variables."""
    return bool(coordinator or os.environ.get("XALM_COORDINATOR")
                or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
    timeout_s: float | None = None,
) -> torch.device:
    """Join this process to the world and return its device.

    The arguments default to ``XALM_COORDINATOR`` / ``XALM_NUM_PROCESSES`` /
    ``XALM_PROCESS_ID``, then to torchrun's ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A
    coordinator ``host:port`` is a TCP rendezvous; one with a scheme
    (``tcp://``, ``file://``) is used as it is. The device is
    ``cuda:(local_rank % device_count)`` (``LOCAL_RANK``, else the process
    id) unless ``device`` names one; the backend is NCCL for a CUDA device
    and gloo for the CPU unless ``backend`` is given. Nothing switches
    quietly: if NCCL refuses (two ranks on one card, say), the error
    propagates. ``timeout_s`` (default ``XALM_DIST_TIMEOUT``, else torch's)
    bounds a collective's wait."""
    coordinator_address = coordinator_address or os.environ.get("XALM_COORDINATOR")
    if num_processes is None and "XALM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["XALM_NUM_PROCESSES"])
    if process_id is None and "XALM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["XALM_PROCESS_ID"])
    if coordinator_address is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the number of processes and this process's id "
                         "(arguments, XALM_NUM_PROCESSES / XALM_PROCESS_ID, or torchrun's "
                         "WORLD_SIZE / RANK)")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if timeout_s is None and "XALM_DIST_TIMEOUT" in os.environ:
        timeout_s = float(os.environ["XALM_DIST_TIMEOUT"])
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    _DEVICE[:] = [device]
    return device


@dataclasses.dataclass
class GlobalArray:
    """A value sharded over a mesh: ``local`` is this rank's shard of the
    global ``shape``, ``spec`` names the mesh axis each dimension is split
    over (None: whole on every rank)."""

    local: torch.Tensor
    shape: tuple
    spec: tuple
    mesh: object


def _block(mesh, spec, dim_sizes):
    """This rank's slice of each dimension under ``spec``."""
    out = []
    for d, n in enumerate(dim_sizes):
        name = spec[d] if d < len(spec) else None
        if name is None:
            out.append(slice(0, n))
            continue
        ax = mesh.axis(name)
        if n % ax.size:
            raise ValueError(f"dimension {d} ({n}) is not divisible by {name}={ax.size}")
        w = n // ax.size
        out.append(slice(ax.index * w, (ax.index + 1) * w))
    return tuple(out)


def make_global(mesh, spec, arr) -> GlobalArray:
    """Full host value -> this rank's shard of it under ``spec`` (a tuple
    of axis names or None per dimension), on the mesh's device. Every
    process passes the SAME full array."""
    full = torch.as_tensor(np.asarray(arr))
    local = full[_block(mesh, spec, full.shape)].contiguous().to(mesh.device)
    return GlobalArray(local, tuple(full.shape), tuple(spec), mesh)


def host_local_to_global(mesh, spec, local_arr) -> GlobalArray:
    """Per-host batch shard -> a global array (dp data feeding): each
    process passes only ITS rows of the global batch, which become its
    shard; no process holds the whole batch. Every rank of one dp index
    passes the same rows."""
    local = torch.as_tensor(np.asarray(local_arr)).to(mesh.device)
    shape = tuple(n * (mesh.axis(spec[d]).size if d < len(spec) and spec[d] else 1)
                  for d, n in enumerate(local.shape))
    return GlobalArray(local, shape, tuple(spec), mesh)


def all_hosts(x) -> np.ndarray:
    """The full value of ``x`` on every process: a ``GlobalArray`` is
    assembled by one all-reduce over its mesh (each block written once, by
    the rank with index 0 on every axis the spec does not split); anything
    else is already whole."""
    if not isinstance(x, GlobalArray):
        if torch.is_tensor(x):
            x = x.detach().cpu()
        return np.asarray(x)
    mesh = x.mesh
    full = torch.zeros(x.shape, dtype=x.local.dtype, device=x.local.device)
    owner = all(mesh.axis(n).index == 0 for n in mesh.axis_names if n not in x.spec)
    if owner:
        full[_block(mesh, x.spec, x.shape)] = x.local
    mesh.axis("mesh").all_reduce(full)
    return full.cpu().numpy()


def spawn_ranks(argv: list[str], world: int, module: str) -> list[subprocess.Popen]:
    """Start ranks 1 .. world-1 of a world on this host, each running
    ``python -m module *argv`` with ``XALM_COORDINATOR`` (a file store in a
    new temporary directory), ``XALM_NUM_PROCESSES`` and ``XALM_PROCESS_ID``
    set, and set the same variables for this process, rank 0. Only rank 0
    writes to standard output; the children's errors go to this process's
    standard error. The caller waits for the children (``wait_ranks``)."""
    _STORES.append(tempfile.mkdtemp(prefix="xalm-world-"))
    store = os.path.join(_STORES[-1], "store")
    env = dict(os.environ, XALM_COORDINATOR=f"file://{store}", XALM_NUM_PROCESSES=str(world))
    os.environ.update(XALM_COORDINATOR=env["XALM_COORDINATOR"],
                      XALM_NUM_PROCESSES=str(world), XALM_PROCESS_ID="0")
    return [subprocess.Popen([sys.executable, "-m", module, *argv],
                             env=dict(env, XALM_PROCESS_ID=str(r)), stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def wait_ranks(children: list[subprocess.Popen], timeout_s: float | None = None) -> int:
    """Wait for the ranks ``spawn_ranks`` started; the first nonzero exit
    code, else 0. A child that outlives ``timeout_s`` is killed."""
    rc = 0
    for p in children:
        try:
            code = p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            code = p.wait()
        rc = rc or code
    for k in ("XALM_COORDINATOR", "XALM_NUM_PROCESSES", "XALM_PROCESS_ID"):
        os.environ.pop(k, None)
    while _STORES:
        shutil.rmtree(_STORES.pop(), ignore_errors=True)
    return rc
