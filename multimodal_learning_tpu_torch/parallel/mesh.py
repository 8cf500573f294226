"""Data parallel over ``torch.distributed`` ranks.

Port of ``multimodal_learning_tpu/parallel/mesh.py``.  The JAX package
shards each batch over a 1-D ``data`` mesh and replicates the state; XLA
inserts the gradient psums and the global BatchNorm reductions, so a
sharded step computes the single-device step on the global batch.  The
port keeps that property with one process per device:

- every rank holds the whole state and runs the same Loader with the same
  seed, and decodes only its own rows of each global batch
  (:func:`process_slice`);
- random draws from the replicated ``state.generator`` (flips, jitter, the
  Kronecker dropout mask) are taken at the global batch size and sliced to
  the rank's rows (:func:`draw_rows`);
- every train-mode BatchNorm normalises by the global batch
  (:class:`GlobalBatchNorm`: one all-gather of the ranks' per-channel
  means and variances in the forward, one all-reduce of the two gradient
  sums in the backward);
- after the forwards, the step gathers the rows its losses read
  (:func:`gather_rows`, differentiable) and computes every loss on the
  global batch, identically on every rank;
- :func:`average_grads` averages the parameter gradients over the ranks in
  one flat buffer before the optimizer's update.

Each rank's loss is the global loss, so its gradient with respect to its own
rows is ``world`` times their share, through the gather's backward and the
BatchNorm's; the average over the ranks is the single-device gradient.  No
model is wrapped in ``DistributedDataParallel`` and no BatchNorm is
``nn.SyncBatchNorm``: the first renames every ``state_dict`` key and expects
one forward per backward, the second runs on CUDA only, takes a shortcut at
world size 1 and folds the unbiased variance where the port follows flax.

The masks of ``nn.Dropout`` come from each rank's default generator, seeded
``seed + rank`` (:func:`setup_data_parallel`): with a rate above 0, N ranks
draw from the same law as one device, not the same masks.

Ranks come from :func:`launch` (spawned processes joined through a
``file://`` store in a fresh temporary directory) or from ``torchrun``
under ``MML_MULTIHOST=1`` (:func:`maybe_init_distributed`).  NCCL with one
CUDA device per rank; gloo only when the caller asked for the CPU.  World
size 1 takes the same path as N.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the collective timeout of every process group the port joins, and the
# seconds :func:`launch` waits for its ranks (None: no limit), unless the
# caller says otherwise
TIMEOUT = timedelta(minutes=10)
DEADLINE: Optional[float] = None
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The joined process group: this rank, the world size, this rank's
    device."""
    rank: int
    world: int
    device: torch.device

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * world``."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


_JOINED: Optional[DataGroup] = None    # the process group of this process
_ACTIVE: Optional[DataGroup] = None    # the group the steps shard over


def active() -> Optional[DataGroup]:
    """The data group the train steps shard over, or None."""
    return _ACTIVE


def is_writer() -> bool:
    """Whether this process writes checkpoints, metrics and logs: the
    only process, or rank 0 of a joined group."""
    return _JOINED is None or _JOINED.rank == 0


def print0(*args, **kwargs) -> None:
    """``print`` on the writer (:func:`is_writer`) only."""
    if is_writer():
        print(*args, **kwargs)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(rank: int, world: int, device, init_method: str,
                  timeout: timedelta = TIMEOUT) -> Iterator[DataGroup]:
    """Join a group of ``world`` ranks as ``rank`` on ``device`` (NCCL on
    CUDA, gloo on the CPU) through ``init_method``; the steps shard over it
    until the block ends, and the group is destroyed then."""
    global _JOINED, _ACTIVE
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index
                              if device.index is not None else rank)
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device), init_method=init_method,
                            rank=rank, world_size=world, timeout=timeout)
    _JOINED = _ACTIVE = DataGroup(rank, world, device)
    try:
        yield _JOINED
    finally:
        _JOINED = _ACTIVE = None
        dist.destroy_process_group()


@contextlib.contextmanager
def unsharded() -> Iterator[None]:
    """Run the block's steps alone, as without a data group, while this
    process stays in its group (to time a step with and without it in
    turns)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, None
    try:
        yield
    finally:
        _ACTIVE = saved


def maybe_init_distributed(device=None) -> bool:
    """Join the ``torchrun`` job when ``MML_MULTIHOST=1``, from its
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``); raises naming the variables that are
    missing.  Rank r takes CUDA device ``LOCAL_RANK``, or the CPU when
    ``device`` is the CPU.  Idempotent (the masking CLI wraps
    ``train_cv_MT.main``).  Returns whether a job was joined."""
    global _JOINED
    if os.environ.get("MML_MULTIHOST") != "1":
        return False
    if _JOINED is not None:
        return True
    missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            "MML_MULTIHOST=1 joins a torchrun job, but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} "
            "not set: launch with torchrun --nproc_per_node N -m "
            "multimodal_learning_tpu_torch.cli.<driver> ...")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device), init_method="env://",
                            timeout=TIMEOUT)
    _JOINED = DataGroup(dist.get_rank(), dist.get_world_size(), device)
    return True


def check_batch(batch_size: int, world: int) -> None:
    """The JAX package's refusal of a batch the ranks cannot split."""
    if batch_size % world:
        raise ValueError(
            f"--batch_size {batch_size} must be divisible by the "
            f"data-parallel mesh size {world}")


def world_size(opt, device) -> int:
    """The ranks ``--data_parallel`` asks for on ``device``: N, or for -1
    every visible CUDA device (the CPU counts as one device; the joined
    job under torchrun).  Raises as the JAX package does when more ranks
    are asked for than there are devices, or when ``--batch_size`` is not
    divisible by them."""
    device = torch.device(device)
    if _JOINED is not None:
        world = _JOINED.world
        if opt.data_parallel > 0 and opt.data_parallel != world:
            raise ValueError(
                f"--data_parallel {opt.data_parallel} in a job of {world} "
                "ranks: pass -1 or the job's size")
    elif device.type == "cuda":
        n = torch.cuda.device_count()
        world = n if opt.data_parallel < 0 else opt.data_parallel
        if world > n:
            raise ValueError(
                f"--data_parallel {world} requested but only {n} "
                "device(s) are visible")
    else:
        world = 1 if opt.data_parallel < 0 else opt.data_parallel
    check_batch(opt.batch_size, world)
    return world


def ranks_to_launch(opt, device) -> int:
    """How many ranks a driver must launch before it trains: 0 when data
    parallel is off or this process already is a rank, else
    :func:`world_size`."""
    if not opt.data_parallel:
        return 0
    world = world_size(opt, device)
    return 0 if _JOINED is not None else world


def setup_data_parallel(opt, seed: int) -> Optional[DataGroup]:
    """Driver-side wiring in a rank (replaces the reference's
    ``nn.DataParallel(model)``, ``train_test_MT.py:62-64``): with
    ``--data_parallel`` 0 the steps run alone, else they shard over the
    joined group, whose size must be what the flag asks for.  Seeds the
    default generators, which ``nn.Dropout`` draws from, with
    ``seed + rank``.  Returns the group, or None."""
    global _ACTIVE
    if not opt.data_parallel:
        _ACTIVE = None
        return None
    if _JOINED is None:
        raise RuntimeError(
            "--data_parallel runs in ranks: start them with "
            "parallel.launch, torchrun (MML_MULTIHOST=1), or the training "
            "drivers, which launch them")
    world_size(opt, _JOINED.device)
    _ACTIVE = _JOINED
    torch.manual_seed(seed + _ACTIVE.rank)
    return _ACTIVE


def process_slice(x: np.ndarray, n_processes: int, rank: int) -> np.ndarray:
    """This process's contiguous rows ``[rank*per, (rank+1)*per)`` of a
    global batch; the slices of ranks 0..n-1 concatenate to it."""
    lead = x.shape[0]
    if lead % n_processes:
        raise ValueError(
            f"global batch of {lead} not divisible by "
            f"{n_processes} processes")
    per = lead // n_processes
    return x[rank * per:(rank + 1) * per]


def draw_rows(draw: Callable[[int], Any], n_local: int) -> Any:
    """``draw(n)`` at the global batch size and this rank's rows of each
    tensor it returns (a tensor, or a tuple or NamedTuple of them), so that
    a replicated generator stays in step on every rank while each rank's
    rows get the draws of their own global rows.  Without a data group,
    ``draw(n_local)``."""
    dp = _ACTIVE
    if dp is None:
        return draw(n_local)
    full, rows = draw(n_local * dp.world), dp.rows(n_local)
    if isinstance(full, torch.Tensor):
        return full[rows]
    return type(full)(*(t[rows] for t in full))


# ------------------------------------------------------------ collectives

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
# the collectives this process has called, by kind (a measurement reads
# and resets them around a window of steps)
CALLS = {"all_reduce": 0, "all_gather": 0}


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    CALLS["all_reduce"] += 1
    dist.all_reduce(t)
    return t


def barrier() -> None:
    """Wait for every rank (one all-reduce on the group's device)."""
    all_reduce_(torch.zeros(1, device=_JOINED.device))


def _gather_flat(flat: torch.Tensor, world: int) -> torch.Tensor:
    out = flat.new_empty((world * flat.shape[0],) + flat.shape[1:])
    CALLS["all_gather"] += 1
    _all_gather(out, flat.contiguous())
    return out


def _split_rows(flat: torch.Tensor, shapes, widths) -> List[torch.Tensor]:
    n = flat.shape[0]
    return [part.reshape((n,) + tuple(shape[1:]))
            for part, shape in zip(flat.split(widths, dim=1), shapes)]


class _GatherRows(torch.autograd.Function):
    """All ranks' rows of same-dtype tensors [b, ...] -> [world * b, ...],
    in one collective.  Backward: the incoming gradients summed over the
    ranks (every rank's loss is the global loss), this rank's rows."""

    @staticmethod
    def forward(ctx, dp, *xs):
        ctx.dp = dp
        ctx.shapes = [x.shape for x in xs]
        ctx.widths = [math.prod(x.shape[1:]) for x in xs]
        flat = torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)
        return tuple(_split_rows(_gather_flat(flat, dp.world), ctx.shapes,
                                 ctx.widths))

    @staticmethod
    def backward(ctx, *grads):
        dp = ctx.dp
        flat = torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=1)
        flat = all_reduce_(flat.contiguous())
        mine = flat[dp.rows(ctx.shapes[0][0])]
        return (None, *_split_rows(mine, ctx.shapes, ctx.widths))


def gather_rows(tensors: Sequence[Optional[torch.Tensor]]
                ) -> List[Optional[torch.Tensor]]:
    """Every rank's rows of each tensor (None stays None; all with the same
    number of rows), concatenated in rank order: the global batch's rows.
    Tensors that take a gradient go through a differentiable gather, one
    collective per dtype; the others travel as bytes, in one collective.
    Without a data group, the tensors as they are."""
    dp = _ACTIVE
    out = list(tensors)
    if dp is None:
        return out
    grad_on = torch.is_grad_enabled()
    by_dtype, raw = {}, []
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if grad_on and t.requires_grad:
            by_dtype.setdefault(t.dtype, []).append(i)
        else:
            raw.append(i)
    for idx in by_dtype.values():
        for i, g in zip(idx, _GatherRows.apply(dp, *(tensors[i]
                                                     for i in idx))):
            out[i] = g
    if raw:
        parts = [tensors[i].detach().contiguous() for i in raw]
        as_bytes = [p.reshape(p.shape[0], -1).view(torch.uint8)
                    for p in parts]
        flat = _gather_flat(torch.cat(as_bytes, dim=1), dp.world)
        for i, p, b in zip(raw, parts,
                           flat.split([a.shape[1] for a in as_bytes], 1)):
            out[i] = b.contiguous().view(p.dtype).reshape(
                (flat.shape[0],) + p.shape[1:])
    return out


def average_grads(params: Sequence[torch.Tensor]) -> None:
    """Average the parameters' gradients over the ranks, one flat buffer
    per dtype and one collective each; a missing gradient counts as 0."""
    dp = _ACTIVE
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        flat /= dp.world
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch.  Each rank takes its
    rows' per-channel mean and biased variance (two passes, in float32);
    one all-gather brings every rank's, which combine exactly into the
    global ones (Chan et al.'s pairwise update), and the biased variance
    normalises.  The backward sums ``g`` and ``g * xhat`` over the ranks in
    one all-reduce and gives the rank's rows the gradient of the whole
    batch's normalisation.  Returns ``(y, mean, var)``, the last two for
    the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dp):
        c = x.shape[1]
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        xf = x.float()
        var_r, mean_r = torch.var_mean(xf, dims, correction=0)
        parts = _gather_flat(torch.stack([mean_r, var_r])[None],
                             dp.world)                    # [world, 2, C]
        mean = parts[:, 0].mean(0)
        var = (parts[:, 1] + (parts[:, 0] - mean).square()).mean(0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (rstd * weight).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.dp, ctx.n = dp, x.numel() // c * dp.world
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        c = x.shape[1]
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, c) + (1,) * (x.dim() - 2)
        g = gy.float()
        xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        grad_b, grad_w = local[:c].clone(), local[c:].clone()
        total = all_reduce_(local) / ctx.n
        gx = (g - total[:c].view(shape) - xhat * total[c:].view(shape)) \
            * (rstd * weight).view(shape)
        return (gx.to(x.dtype), grad_w if ctx.needs_input_grad[1] else None,
                grad_b if ctx.needs_input_grad[2] else None, None, None)


# ---------------------------------------------------------------- launcher

def _rank_main(fn, args, rank, world, init_method, device_type, timeout_s,
               threads, results) -> None:
    """A spawned rank: join the group, run ``fn(*args)``, post its value
    (or the error, and exit 1 without waiting on the group)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        device = (torch.device("cuda", rank) if device_type == "cuda"
                  else torch.device("cpu"))
        with process_group(rank, world, device, init_method,
                           timedelta(seconds=timeout_s)):
            results.put(("ok", rank, fn(*args)))
    except BaseException as exc:   # noqa: BLE001 - re-raised by launch
        tb = traceback.format_exc()
        try:
            pickle.dumps(exc)
        except Exception:
            exc = RuntimeError(tb)
        results.put(("error", rank, (exc, tb)))
        results.close()
        results.join_thread()
        os._exit(1)


def launch(fn: Callable, world: int, args: tuple = (), device="cuda",
           timeout: Optional[timedelta] = None,
           deadline: Optional[float] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` spawned ranks of one group (NCCL on
    CUDA devices 0..world-1, gloo on the CPU), rendezvous through a
    ``file://`` store in a fresh temporary directory; every collective
    times out after ``timeout`` (:data:`TIMEOUT` when None).  Returns each rank's value, rank 0 first.
    When a rank fails, every rank is killed and its error re-raised here
    (with the rank's traceback as a note); past ``deadline`` seconds
    (:data:`DEADLINE` when None), every rank is killed and
    ``TimeoutError`` raised.  ``fn`` and ``args`` must
    pickle.  ``threads`` sets each rank's torch threads (on the CPU by
    default this process's threads shared out)."""
    device = torch.device(device)
    timeout = TIMEOUT if timeout is None else timeout
    deadline = DEADLINE if deadline is None else deadline
    if threads is None and device.type == "cpu":
        threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mml_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, args, r, world, init_method, device.type,
              timeout.total_seconds(), threads, results))
        for r in range(world)]
    end = None if deadline is None else time.monotonic() + deadline
    values = {}
    try:
        for p in procs:
            p.start()
        while len(values) < world:
            try:
                kind, rank, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before it returned")
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {deadline} s")
                continue
            if kind == "error":
                exc, tb = payload
                exc.add_note(f"raised in rank {rank} of {world}:\n{tb}")
                raise exc
            values[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [values[r] for r in range(world)]


def launch_for(opt, device, fn: Callable, args: tuple) -> Optional[Any]:
    """When ``--data_parallel`` asks for ranks and this process is none,
    run ``fn(*args)`` in them and return rank 0's value; else None (the
    caller goes on in this process)."""
    world = ranks_to_launch(opt, device)
    if not world:
        return None
    return launch(fn, world, args, device=torch.device(device))[0]
