"""The world the device meshes live in: one process per rank.

The JAX package is single-controller: a ``jax.sharding.Mesh`` is a list of
the devices of one process, and XLA inserts the collectives where a sharding
changes. The port is SPMD over ``torch.distributed``: every rank is a
process with one device, a mesh is a ``DeviceMesh`` over the initialized
world (``multistream.make_mesh``, ``make_stream_mesh``), and every
collective is an explicit call through :data:`COLLECTIVES`, which counts
them.

A world starts in one of two ways:

- :func:`spawn` runs a function on every rank of a new world, each rank a
  process started with the ``"spawn"`` method (CUDA is never forked), and
  returns what each rank returned;
- :func:`init_world` joins a world that ``torchrun`` (or any ``env://``
  launcher) started, from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``.

Either way the rank's device follows the port's device rule: the GPU unless
the caller asks for the CPU (``device="cpu"``, gloo), and no GPU raises.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

_RANK_DEVICE: torch.device | None = None  # this process's rank device
_START_S = 120.0  # seconds for a spawned world's ranks to enter their function


class CollectiveCounter:
    """Issues the package's collectives and counts them, per kind and in
    all (one count a call, whatever the group's size)."""

    def __init__(self):
        self.count = 0
        self.by_kind: dict[str, int] = {}

    def reset(self):
        self.count = 0
        self.by_kind = {}

    def _count(self, kind: str):
        self.count += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1

    def all_gather_into_tensor(self, out: torch.Tensor, inp: torch.Tensor,
                               group=None):
        """``out`` (n * d0, ...) holds every rank's ``inp`` (d0, ...), in
        the group's rank order."""
        self._count("all_gather")
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        gather(out, inp, group=group)
        return out

    def all_reduce(self, t: torch.Tensor, group=None):
        """In-place sum over the group."""
        self._count("all_reduce")
        dist.all_reduce(t, group=group)
        return t

    def broadcast(self, t: torch.Tensor, src: int, group=None):
        """In place, from global rank ``src``."""
        self._count("broadcast")
        dist.broadcast(t, src, group=group)
        return t

    def barrier(self, group=None):
        self._count("barrier")
        dist.barrier(group=group)

    def batch_isend_irecv(self, ops):
        """One batch of point-to-point sends and receives, waited for.
        gloo has no send or receive of CUDA tensors (its collectives stage
        them through host memory themselves; its point-to-point ops read
        the device pointer and fail), so over gloo CUDA tensors travel
        through host copies."""
        self._count("p2p")
        staged = []
        if ops[0].tensor.is_cuda and dist.get_backend(ops[0].group) == "gloo":
            host_ops = []
            for o in ops:
                h = o.tensor.cpu() if o.op is dist.isend \
                    else torch.empty(o.tensor.shape, dtype=o.tensor.dtype)
                if o.op is not dist.isend:
                    staged.append((o.tensor, h))
                host_ops.append(dist.P2POp(o.op, h, o.peer, o.group, o.tag))
            ops = host_ops
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for dev_t, host_t in staged:
            dev_t.copy_(host_t)


#: every collective of ``aicamera_tpu_torch.parallel`` and of
#: ``train.make_train_step_dp`` goes through this counter
COLLECTIVES = CollectiveCounter()


def rank_device() -> torch.device:
    """This rank's device, as :func:`spawn` or :func:`init_world` set it.
    Raises when no world was started through them (a world initialized
    elsewhere does not say which device its rank owns)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed world is initialized: start one with "
            "aicamera_tpu_torch.parallel.distributed.spawn(fn, world_size) "
            "or, under torchrun, init_world()")
    if _RANK_DEVICE is None:
        raise RuntimeError(
            "the torch.distributed world was not started by "
            "aicamera_tpu_torch.parallel.distributed.spawn or init_world, so "
            "the rank's device is unknown")
    return _RANK_DEVICE


def require_world(what: str) -> int:
    """The initialized world's size; raises, naming ``what`` and the
    launcher, when there is none (a world of 1 is never made silently)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed world: start one "
            f"with aicamera_tpu_torch.parallel.distributed.spawn(fn, "
            f"world_size) or, under torchrun, init_world()")
    return dist.get_world_size()


def _rank_setup(rank: int, n_ranks: int, device, backend):
    """(device, backend) of ``rank``: cuda:(rank % cards) unless the CPU
    was asked for; NCCL on the card, gloo on the CPU by default."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev, backend or ("nccl" if dev.type == "cuda" else "gloo")


def init_world(device=None, backend: str | None = None,
               timeout: float = 300.0) -> torch.device:
    """Join the world an ``env://`` launcher started (``torchrun
    --nproc-per-node N script.py``): rank and size from ``RANK`` and
    ``WORLD_SIZE``. Returns the rank's device (see :func:`spawn`)."""
    global _RANK_DEVICE
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("init_world() joins a world started by torchrun "
                           "(RANK and WORLD_SIZE are not set); use spawn() "
                           "to start one")
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev, backend = _rank_setup(int(os.environ.get("LOCAL_RANK", rank)), n,
                               device, backend)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    _RANK_DEVICE = dev
    return dev


def _rank_main(fn, rank, n_ranks, device, backend, init_method, args,
               out_dir, timeout):
    """A spawned rank: join the world, run ``fn``, leave its result (or its
    traceback) in ``out_dir``; ``rank{r}.began`` marks that it joined the
    world and entered ``fn``."""
    global _RANK_DEVICE
    try:
        dev, backend = _rank_setup(rank, n_ranks, device, backend)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=timeout))
        _RANK_DEVICE = dev
        open(os.path.join(out_dir, f"rank{rank}.began"), "w").close()
        try:
            result = fn(rank, dev, *args)
            # the result before leaving the group: a rank that has it is
            # done, however long the group takes to close
            tmp = os.path.join(out_dir, f"rank{rank}.tmp")
            torch.save(result, tmp)
            os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.flush()
        # no interpreter shutdown: a collective's threads may still wait
        # on the peers
        os._exit(1)


def spawn(fn, world_size: int, *, device=None, backend: str | None = None,
          args=(), timeout: float = 120.0):
    """Run ``fn(rank, device, *args)`` on every rank of a new world of
    ``world_size`` processes and return the ranks' results, in rank order.

    ``fn`` must be importable by name (a module-level function), and its
    arguments and result picklable; tensors come back on the CPU or on the
    card they were left on. ``device=None`` means the GPU: rank r gets
    ``cuda:(r % torch.cuda.device_count())``, and no GPU raises.
    ``device="cpu"`` runs every rank on the CPU over gloo. ``backend``
    defaults to NCCL on the card (one rank a card: NCCL refuses two ranks
    of one communicator on one GPU) and gloo on the CPU.

    The rendezvous is a file in a fresh temporary directory, so concurrent
    worlds never share a port. A rank that raises makes the launch raise
    (with its traceback) after the others are stopped. Two clocks bound a
    world, each raising ``TimeoutError`` naming the ranks it waits for:
    ``_START_S`` seconds for every rank to start its interpreter, join
    the world and enter ``fn``, then ``timeout`` seconds for every rank to
    return from ``fn`` (a rank that has returned is done, even while its
    process still closes the group). The startup of a process (importing
    torch and ``fn``'s module) thus never counts against ``fn``'s time; the
    rendezvous and every collective time out after both."""
    resolve_device(device)  # no GPU and no device="cpu": raise here
    start_s = _START_S
    n = int(world_size)
    if n < 1:
        raise ValueError(f"world_size must be >= 1 (got {world_size})")
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="aicam_world_")
    init_method = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, device, backend, init_method, args,
                               out_dir, start_s + timeout))
             for r in range(n)]

    def marked(r, what):
        return os.path.exists(os.path.join(out_dir, f"rank{r}.{what}"))

    def waiting():
        """Ranks neither returned from ``fn`` nor exited."""
        return [r for r, p in enumerate(procs)
                if p.exitcode is None and not marked(r, "pt")]

    try:
        for p in procs:
            p.start()
        start_deadline = time.monotonic() + start_s
        deadline = None   # set once every rank has entered fn
        while waiting():
            if any(p.exitcode not in (None, 0) for p in procs):
                # the others fail soon after (their peer is gone): give
                # them a moment, so that every traceback is reported
                grace = time.monotonic() + 2.0
                while time.monotonic() < grace and \
                        any(p.exitcode is None for p in procs):
                    time.sleep(0.05)
                break
            now = time.monotonic()
            if deadline is None:
                starting = [r for r in waiting() if not marked(r, "began")]
                if not starting:
                    deadline = now + timeout
                elif now > start_deadline:
                    raise TimeoutError(
                        f"ranks {starting} of {n} did not start within "
                        f"{start_s:g} s")
            elif now > deadline:
                raise TimeoutError(f"ranks {waiting()} of {n} did not "
                                   f"finish within {timeout:.0f} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode != 0 and not marked(r, "pt")]
        if failed:
            raise RuntimeError(
                f"ranks {failed} of {n} failed:\n" + "\n".join(
                    f"--- rank {r}:\n" + _rank_error(out_dir, r, procs[r])
                    for r in failed))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(out_dir, ignore_errors=True)


def _rank_error(out_dir: str, rank: int, proc) -> str:
    path = os.path.join(out_dir, f"rank{rank}.err")
    if proc.exitcode is None:
        return "still running; stopped"
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return f"exit code {proc.exitcode} (no traceback)"
