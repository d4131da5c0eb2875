"""Meshes of ranks for the port's SPMD serving (torch twin of
``repro/launch/mesh.py``).

The JAX package lays its arrays over a ``jax.sharding.Mesh`` of devices
and lets GSPMD partition the jitted programs. The port has no GSPMD: every
rank of a ``torch.distributed`` world runs the same program on its own
shards, and the model code places the collectives by hand. A :class:`Mesh`
is the named shape of that world (``("data", "model")`` or ``("pod",
"data", "model")``), this process's rank and coordinates, and the process
group.

Only two collectives are used, ``all_reduce`` (SUM, MAX) and
``broadcast``: gloo, which carries ranks that share one card and the CPU,
offers nothing else for CUDA tensors. :meth:`Mesh.all_gather` is an
``all_reduce`` SUM of a zero-filled buffer in which every position has
exactly one writer, summed as integers over its bytes, so it is exact
(``x + 0 = x``, bit for bit).

Every collective is preceded, by default, by a check that all ranks are
issuing the same one (``check=True``): a tiny MAX over each rank's
(operation, dtype, element count) fingerprint and its negation. Ranks
whose host decisions diverged then raise ``CollectiveMismatch`` together
instead of pairing mismatched payloads (which gloo answers by aborting
the process or by blocking until the timeout). A rank that issues no
collective at all is caught by the process group's timeout.

Builders are functions, as in the JAX package: importing this module
touches no process group.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "CollectiveMismatch", "make_production_mesh",
           "make_local_mesh", "make_sim_mesh", "spawn", "init_world",
           "DEFAULT_TIMEOUT_S"]

# the process-group timeout of the worlds :func:`spawn` starts: a rank
# left waiting on a collective that another rank never issues raises
# after this long
DEFAULT_TIMEOUT_S = 120.0

_OPS = {"sum": 1, "max": 2, "broadcast": 3}
_DTYPES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
           torch.float64: 4, torch.int32: 5, torch.int64: 6, torch.uint8: 7}


class CollectiveMismatch(RuntimeError):
    """The ranks of a mesh issued different collectives: their host
    decisions diverged."""


class Mesh:
    """A named grid of ``torch.distributed`` ranks.

    ``shape`` maps axis names to sizes in row-major order (the last axis
    varies fastest over the ranks, as ``jax.make_mesh`` lays devices);
    ``rank`` is this process's rank in ``group`` (None: the default
    world). A mesh of one rank needs no process group: its collectives
    are the identity. Without an initialized world a mesh is abstract —
    enough for the sharding rules, which read only ``shape``.

    Collectives act over the whole world, which is the "model" axis on the
    meshes this port serves on (every axis but "model" of size 1).
    ``collectives`` and ``collective_s`` count the payload collectives and
    their seconds (checks and object broadcasts included in the seconds).
    """

    def __init__(self, shape: Dict[str, int], rank: int = 0, group=None, *,
                 check: bool = True):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.group = group
        self.check = check
        self.coords: Dict[str, int] = {}
        rest = rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {a: self.coords[a] for a in self.axis_names}
        self.collectives = 0
        self.collective_s = 0.0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def distributed(self) -> bool:
        """Whether collectives leave this process (more than one rank)."""
        return self.size > 1

    def _model_only(self) -> None:
        if self.size != self.model_size:
            raise NotImplementedError(
                f"collectives over the model axis of a {self.shape} mesh: "
                "a data or pod axis above 1 is the next slice of the port "
                "(ROADMAP.md)")

    # ------------------------------------------------------- collectives
    def _host(self) -> str:
        """Where small control tensors live: NCCL carries only CUDA
        tensors, gloo takes host ones (no device sync)."""
        return "cuda" if dist.get_backend(self.group) == "nccl" else "cpu"

    def _fingerprint(self, op: str, t: torch.Tensor) -> None:
        if not self.check:
            return
        f = torch.tensor([_OPS[op], _DTYPES.get(t.dtype, 0), t.numel()],
                         dtype=torch.int64, device=self._host())
        both = torch.cat([f, -f])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        hi, lo = both[:3], -both[3:]
        if not torch.equal(hi, lo):
            raise CollectiveMismatch(
                f"rank {self.rank} issued {op}({t.dtype}, {t.numel()} "
                f"elements) while another rank issued a different "
                f"collective (max {hi.tolist()} vs min {lo.tolist()} over "
                f"(op, dtype, numel)): the ranks' host decisions diverged")

    def _run(self, op: str, t: torch.Tensor) -> torch.Tensor:
        if not self.distributed:
            return t
        self._model_only()
        t0 = time.perf_counter()
        self._fingerprint(op, t)
        if op == "broadcast":
            dist.broadcast(t, src=0, group=self.group)
        else:
            dist.all_reduce(t, op=(dist.ReduceOp.SUM if op == "sum"
                                   else dist.ReduceOp.MAX),
                            group=self.group)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place ``all_reduce`` of ``t`` (``op`` "sum" or "max") over
        the model axis; returns ``t``."""
        return self._run(op, t)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """In place: every rank gets rank 0's ``t``; returns ``t``."""
        return self._run("broadcast", t)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block ``t`` of a tensor split evenly along ``dim``
        over the model axis -> the whole tensor, exactly: a zero buffer
        with ``t`` at this rank's block, summed over the ranks."""
        return self.all_gather_many([t], dim)[0]

    def all_gather_many(self, ts: Sequence[torch.Tensor],
                        dim: int) -> List[torch.Tensor]:
        """:meth:`all_gather` of several blocks (one dtype, one shape but
        along ``dim``) through ONE collective."""
        if not self.distributed:
            return list(ts)
        n, r = self.model_size, self.model_rank
        dim = dim % ts[0].dim()
        widths = [t.shape[dim] for t in ts]
        shape = list(ts[0].shape)
        shape[dim] = n * sum(widths)
        buf = torch.zeros(shape, dtype=ts[0].dtype, device=ts[0].device)
        off = 0
        for t, w in zip(ts, widths):
            buf.narrow(dim, off + r * w, w).copy_(t)
            off += n * w
        # summed as integers over the buffer's bytes: with one writer a
        # position, bit-exact for any dtype (-0.0 and NaNs included), and
        # gloo adds bf16 far slower than int32
        flat = buf.view(-1)
        self._run("sum", flat.view(torch.int32 if flat.nbytes % 4 == 0
                                   else torch.uint8))
        out, off = [], 0
        for w in widths:
            out.append(buf.narrow(dim, off, n * w))
            off += n * w
        return out

    def agree_float(self, x: float) -> float:
        """Rank 0's ``x`` on every rank (one broadcast on the host)."""
        if not self.distributed:
            return x
        return float(self.broadcast(torch.tensor(
            [x], dtype=torch.float64, device=self._host()))[0])

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (picklable) on every rank: two broadcasts, of
        its pickled length and of its bytes, on the host."""
        if not self.distributed:
            return obj
        import pickle

        self._model_only()
        t0 = time.perf_counter()
        dev = self._host()
        data = pickle.dumps(obj) if self.rank == 0 else b""
        n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
        self._fingerprint("broadcast", n)
        dist.broadcast(n, src=0, group=self.group)
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
               if self.rank == 0 else
               torch.zeros(int(n[0]), dtype=torch.uint8, device=dev))
        self._fingerprint("broadcast", buf)
        dist.broadcast(buf, src=0, group=self.group)
        self.collective_s += time.perf_counter() - t0
        return pickle.loads(buf.cpu().numpy().tobytes()) if self.rank else obj


# ---------------------------------------------------------------- builders


def _world() -> Tuple[int, int]:
    """(world size, rank) of the initialized default group, (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single pod (256 ranks) or 2×16×16 two-pod (512 ranks), over a
    world of exactly that size; raises otherwise."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    want = 512 if multi_pod else 256
    size, rank = _world()
    if size != want:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{want} ranks; this one has {size}")
    return Mesh(shape, rank)


def make_local_mesh() -> Mesh:
    """(ranks, 1) ("data", "model") mesh over the initialized world (one
    rank without one) — for smoke tests."""
    size, rank = _world()
    return Mesh({"data": size, "model": 1}, rank)


def make_sim_mesh(n: int) -> Mesh:
    """(1, n) ("data", "model") mesh over the ``n`` ranks of the world —
    the stand-in for an n-card edge cluster, so the sharded serving paths
    (expert-parallel stores, KV slots over "model") run for real.

    Raises a clear ``RuntimeError`` when the world has fewer than ``n``
    ranks, instead of handing back a smaller mesh whose shards would all
    degrade to replication (which would green-light tests that never
    exercised the partitioning)."""
    size, rank = _world()
    if size < n:
        raise RuntimeError(
            f"make_sim_mesh({n}) needs {n} ranks but the world has {size}. "
            f"Start {n} ranks first: repro_torch.launch.mesh.spawn(fn, {n}) "
            f"(gloo on the CPU or on one shared card), or torchrun "
            f"--nproc-per-node {n}, and call make_sim_mesh({n}) in each. "
            f"Refusing to degrade to a {size}-rank mesh: its shards would "
            f"all guard down to replication and the sharded code paths "
            f"would silently not be exercised.")
    if size > n:
        raise RuntimeError(
            f"make_sim_mesh({n}) over a world of {size} ranks: a mesh over "
            f"a subset of the world is not supported")
    return Mesh({"data": 1, "model": n}, rank)


# ------------------------------------------------------------------ spawn


def _backend(device: str, n: int) -> str:
    """gloo on the CPU and for ranks that share one card; NCCL when every
    rank has a card of its own."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, init_method: str, device: str = "cpu",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` and return
    this rank's device (``cuda:rank`` under NCCL, else ``device``)."""
    backend = _backend(device, world)
    dev = torch.device(device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _entry(rank: int, fn: Callable, world: int, init_method: str,
           device: str, timeout_s: float, results, args) -> None:
    # one intra-op thread a rank: n ranks' default pools (a thread a core
    # each) would oversubscribe the host's cores n times over
    torch.set_num_threads(1)
    dev = init_world(rank, world, init_method, device, timeout_s)
    try:
        out = fn(rank, dev, *args)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device: str = "cpu",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on ``n`` new ranks (the port's heir
    of the JAX package's ``ensure_sim_devices``) and return their results
    in rank order. Each rank joins a world over a ``file://`` store in a
    fresh temporary directory with the process-group timeout
    ``timeout_s``; ``fn`` and ``args`` must be picklable (a module-level
    function) and its result picklable on the host. A rank that raises
    makes this raise (the others are terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        init = "file://" + os.path.join(d, "store")
        procs = mp.start_processes(
            _entry, args=(fn, n, init, device, timeout_s, results, args),
            nprocs=n, join=False, start_method="spawn")
        # read the results while the ranks run: a rank's put blocks until
        # its pipe is read (join raises if a rank failed)
        done = False
        while not done:
            done = procs.join(timeout=0.05)
            while not results.empty():
                rank, out = results.get()
                got[rank] = out
    return [got[r] for r in range(n)]
