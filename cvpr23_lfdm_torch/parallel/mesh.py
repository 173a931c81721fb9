"""The `data` mesh over processes and its collectives (the `data`-axis part of
`cvpr23_lfdm_tpu/parallel/mesh.py`).

In the JAX package XLA's partitioner turns a batch sharded over the `data`
axis into collectives; here each rank is one process holding its
contiguous rows of every global batch, and the collectives are explicit:

* `mean_gradients` after `backward` (the trainers),
* `all_reduce_sum`, a sum that carries the gradient, for the synchronised
  BatchNorm statistics (`models/blocks.py::BatchNorm`),
* `all_gather_rows` for the sharded serving outputs,
* `replicate` to broadcast weights and optimizer state from rank 0.

`local_rows` is the one place that cuts a global tensor to this rank's
rows: every random draw of a dp run is made at the global shape from the
same generator on every rank, so an N-rank run draws what the one-process
run draws (threefry gives JAX this for free). The `model` and `space` axes
(`UNET_TP_RULES`, `tp_spec`, `shard_variables`) are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cvpr23_lfdm_torch.parallel.distributed import local_device, process_count, process_index
from cvpr23_lfdm_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D `data` mesh: `size` ranks in `group` (None for one rank), this
    rank at `rank`, its tensors on `device`."""

    size: int
    rank: int
    group: object
    device: torch.device
    axis_names: tuple = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": self.size}


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape: int | tuple | None = None, axis_names: tuple = ("data",), device=None) -> Mesh:
    """The `data` mesh: every rank of the process group (the default), or
    `shape` 1 for this rank alone. `device`: this rank's device (default the
    one `init_distributed` chose, else the CUDA card)."""
    if tuple(axis_names) != ("data",):
        raise NotImplementedError(f"mesh axes {axis_names}: only ('data',) is ported; the "
                                  "'model' and 'space' axes wait for the tp and sp slices")
    if isinstance(shape, (tuple, list)):
        (shape,) = shape
    world = process_count()
    n = world if shape is None else int(shape)
    if n not in (1, world):
        raise ValueError(f"a data mesh of {n} ranks needs {n} processes; this run has {world}")
    device = _canonical(resolve_device(device) if device is not None
                        else local_device() or resolve_device(None))
    if n == 1:
        return Mesh(1, 0, None, device)
    return Mesh(n, process_index(), dist.group.WORLD, device)


def check_device(mesh: Mesh, device) -> None:
    if _canonical(device) != mesh.device:
        raise ValueError(f"the mesh's device {mesh.device} is not {device}")


# ------------------------------------------------------------------ rows


def local_rows(x, mesh: Mesh, dim: int = 0):
    """This rank's contiguous rows of a global tensor (or array) along `dim`;
    the tensor itself on a one-rank mesh."""
    if mesh.size == 1:
        return x
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows along dim {dim} not divisible by {mesh.size} ranks")
    k = n // mesh.size
    index = (slice(None),) * dim + (slice(mesh.rank * k, (mesh.rank + 1) * k),)
    return x[index]


def shard_batch(tree, mesh: Mesh, batch_size: int):
    """This rank's rows of a global batch of `batch_size` rows (a dict, list
    or tuple of arrays or tensors, nested); a leaf that already holds the
    local `batch_size / size` rows passes through, as does a leaf that is
    no array (names, ids)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, batch_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, batch_size) for v in tree)
    if not isinstance(tree, (np.ndarray, torch.Tensor)):
        return tree
    if batch_size % mesh.size:
        raise ValueError(f"global batch {batch_size} not divisible by {mesh.size} ranks")
    rows = tree.shape[0]
    if rows == batch_size:
        return local_rows(tree, mesh)
    if rows == batch_size // mesh.size:
        return tree
    raise ValueError(f"a leaf of {rows} rows is neither the global batch {batch_size} "
                     f"nor this rank's {batch_size // mesh.size}")


# ------------------------------------------------------------------ collectives


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, forward and backward: the gradient of a sum that
    every rank uses is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the ranks of `group`, differentiably."""
    return _AllReduceSum.apply(x, group)


def _flat_buckets(tensors) -> list:
    """The tensors grouped by (device, dtype), in order."""
    buckets = collections.OrderedDict()
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    return list(buckets.values())


def _flat_collective(tensors, op, device) -> None:
    """Run `op(flat)` on one flat copy of each (device, dtype) bucket, on
    `device` (a backend such as NCCL reaches no CPU tensor), and write the
    result back into the tensors."""
    for bucket in _flat_buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket]).to(device)
        op(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.data.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def mean_gradients(params, mesh: Mesh) -> None:
    """Replace every existing gradient by its mean over the mesh: one flat
    `all_reduce` per dtype, divided by the number of ranks. Each rank's
    loss is the mean over its equal slice, so this is the gradient of the
    global mean."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]

    def op(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)

    _flat_collective(grads, op, mesh.device)


def mean_metrics(metrics: dict, mesh: Mesh, keys) -> dict:
    """`metrics` with the 0-d tensors under `keys` averaged over the mesh
    (per-rank means of equal slices: the global mean)."""
    if mesh.size == 1:
        return metrics
    keys = [k for k in keys if k in metrics]
    flat = torch.stack([metrics[k].detach().float() for k in keys]).to(mesh.device)
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / mesh.size
    return {**metrics, **{k: flat[i] for i, k in enumerate(keys)}}


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal row blocks of `x`, concatenated in rank order."""
    if mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _state_tensors(obj) -> list:
    """The tensors of a module (parameters, buffers) or of an optimizer's
    per-parameter state (`MultistepAdam`'s Adam too)."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    optimizer = getattr(obj, "adam", obj)
    return [v for s in optimizer.state.values() for v in s.values() if torch.is_tensor(v)]


def replicate(obj, mesh: Mesh):
    """Broadcast the tensors of a module (parameters, buffers) or an
    optimizer (its moments and step counts) from rank 0, in place, so that
    every rank holds rank 0's values; returns `obj`."""
    if mesh.size > 1:
        src = dist.get_global_rank(mesh.group, 0)
        _flat_collective(_state_tensors(obj), lambda flat: dist.broadcast(flat, src, group=mesh.group),
                         mesh.device)
    return obj


def states_agree(obj, mesh: Mesh) -> bool:
    """True when every rank holds the same tensors in `obj` (see
    `replicate`): per tensor the float64 sum and sum of squares, their
    largest and smallest values over the ranks compared."""
    if mesh.size == 1:
        return True
    sums = [s.to(mesh.device) for t in _state_tensors(obj)
            for s in (t.detach().double().sum(), t.detach().double().square().sum())]
    hi = torch.stack(sums)
    lo = -hi
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(torch.equal(hi, -lo))


# ------------------------------------------------------------------ prefetch


def device_prefetch(batches, mesh: Mesh, depth: int = 1, keys=None):
    """Iterate host batches (dicts) with the host-to-device copy of each
    issued `depth` batches ahead: from pinned memory, `non_blocking`, on a
    side stream; the consumer's stream waits on that copy's event before it
    gets the batch, and each tensor is recorded on the consumer's stream, so
    the allocator keeps it until the consumer is done with it. Values are
    unchanged: the copies are only made early. `keys`: the entries to copy
    (default: every array or tensor); the rest pass through. On the CPU
    the batches pass through as they are."""
    if mesh.device.type != "cuda":
        yield from batches
        return
    device = mesh.device
    side = torch.cuda.Stream(device)

    def place(batch):
        out = dict(batch)
        moved = []
        with torch.cuda.stream(side):
            for k, v in batch.items():
                if (keys is None or k in keys) and isinstance(v, (np.ndarray, torch.Tensor)):
                    t = torch.as_tensor(v)
                    if t.device.type == "cpu":
                        t = t.pin_memory()
                    out[k] = t.to(device, non_blocking=True)
                    moved.append(k)
            done = torch.cuda.Event()
            done.record(side)
        return out, moved, done

    queue = collections.deque()
    it = iter(batches)
    while True:
        try:
            while len(queue) <= depth:
                queue.append(place(next(it)))
        except StopIteration:
            pass
        if not queue:
            return
        batch, moved, done = queue.popleft()
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for k in moved:
            batch[k].record_stream(stream)
        yield batch
