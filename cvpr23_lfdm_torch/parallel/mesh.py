"""The `data`, `model` and `space` axes of a mesh over processes and their
collectives (counterpart of `cvpr23_lfdm_tpu/parallel/mesh.py`).

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
run draws (threefry gives JAX this for free).

The `model` axis (tensor parallelism of the UNet, the second section):
`UNET_TP_RULES` and `tp_spec` as in the JAX package, `shard_variables` /
`gather_variables` between the one-process state and a rank's shard, and
the explicit collectives of the tensor-parallel form
(`models/unet3d.py::shard_unet`).

The `space` axis (spatial partitioning of the LFAE's encoder and decoder,
the third section): the image height cut into one contiguous band per
rank (`local_band`), the neighbours' rows a convolution needs
(`halo_rows`, zeros past the image's edges), the bands put back together
(`gather_band`) and one rank's tensor sent to the others
(`broadcast_space`); `models/generator.py::shard_generator` runs the
generator on them. GSPMD places these halo exchanges itself in the JAX
package.
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
    """A mesh of `data`, `model` and `space` axes. `size` ranks in `group`
    (None for one rank) share this rank's model and space indices and
    split the batch, this rank at `rank` of them; `model_size` ranks in
    `model_group` (None for one) share its data and space indices and
    split the UNet's heads and channels, this rank at `model_rank`;
    `space_size` ranks in `space_group` (None for one) share its data and
    model indices and split the image height, this rank at `space_rank`.
    Its tensors are on `device`."""

    size: int
    rank: int
    group: object
    device: torch.device
    axis_names: tuple = ("data",)
    model_size: int = 1
    model_rank: int = 0
    model_group: object = None
    space_size: int = 1
    space_rank: int = 0
    space_group: object = None

    @property
    def shape(self) -> dict:
        sizes = {"data": self.size, "model": self.model_size, "space": self.space_size}
        return {a: sizes[a] for a in self.axis_names}


AXES = ("data", "model", "space")


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape: int | tuple | None = None, axis_names: tuple = ("data",), device=None) -> Mesh:
    """The mesh over every rank of the process group (the default: one
    `data` axis), or `shape` 1 for this rank alone. `axis_names` may name
    `data`, `model` and `space`, each at most once and in any order, as the
    JAX `make_mesh((dp, tp), ("data", "model"))`: the ranks fill the mesh
    row-major, the last axis fastest, and every rank creates every data
    group, then every model group, then every space group, in the same
    order. `device`: this rank's device (default the one
    `init_distributed` chose, else the CUDA card)."""
    axis_names = tuple(axis_names)
    if not axis_names or any(a not in AXES for a in axis_names) \
            or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names}: name 'data', 'model' and 'space', each at most once")
    shape = (shape,) if shape is None or isinstance(shape, int) else tuple(shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    world = process_count()
    if shape == (None,):
        shape = (world,)
    sizes = dict(zip(axis_names, (int(n) for n in shape)))
    dp, tp, sp = (sizes.get(a, 1) for a in AXES)
    device = _canonical(resolve_device(device) if device is not None
                        else local_device() or resolve_device(None))
    n = dp * tp * sp
    if n == 1:
        return Mesh(1, 0, None, device, axis_names)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks ({sizes}) needs {n} processes; this run has {world}")
    if tp == sp == 1:
        return Mesh(dp, process_index(), dist.group.WORLD, device, axis_names)
    # grid[d, m, s]: the rank at data index d, model index m, space index s
    # (row-major over `axis_names`; an axis the mesh does not name has size 1)
    grid = np.arange(world).reshape(shape)
    names = list(axis_names)
    for a in AXES:
        if a not in names:
            grid, names = grid[..., None], names + [a]
    grid = grid.transpose([names.index(a) for a in AXES])
    me = process_index()
    index = tuple(int(i[0]) for i in np.nonzero(grid == me))
    groups = {}
    for k, axis in enumerate(AXES):
        for line in np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k]):
            if len(line) > 1:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    # a line runs up the axis in rank order: the group's
                    # ranks are in axis order (`gather_band`, `_all_gather`)
                    assert dist.get_group_rank(g, me) == index[k], (axis, line, me)
                    groups[axis] = g
    d, m, s = index
    return Mesh(dp, d, groups.get("data"), device, axis_names, tp, m, groups.get("model"),
                sp, s, groups.get("space"))


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
    """The tensors of a module (parameters, buffers), of an optimizer's
    per-parameter state (`MultistepAdam`'s Adam too), or of a list."""
    if isinstance(obj, (list, tuple)):
        return list(obj)
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    optimizer = getattr(obj, "adam", obj)
    return [v for s in optimizer.state.values() for v in s.values() if torch.is_tensor(v)]


def _axis(mesh: Mesh, axis: str) -> tuple:
    """(size, group) of the mesh's `data`, `model` or `space` axis."""
    if axis == "data":
        return mesh.size, mesh.group
    if axis == "model":
        return mesh.model_size, mesh.model_group
    if axis == "space":
        return mesh.space_size, mesh.space_group
    raise ValueError(f"mesh axis {axis!r}")


def replicate(obj, mesh: Mesh, axis: str = "data"):
    """Broadcast the tensors of a module (parameters, buffers), an optimizer
    (its moments and step counts) or a list from the first rank of this
    rank's `axis` group, in place, so that every rank of the group holds
    its values; returns `obj`."""
    size, group = _axis(mesh, axis)
    if size > 1:
        src = dist.get_global_rank(group, 0)
        _flat_collective(_state_tensors(obj), lambda flat: dist.broadcast(flat, src, group=group),
                         mesh.device)
    return obj


def states_agree(obj, mesh: Mesh, axis: str = "data") -> bool:
    """True when every rank of this rank's `axis` group holds the same
    tensors in `obj` (see `replicate`): per tensor the float64 sum and sum
    of squares, their largest and smallest values over the ranks compared."""
    size, group = _axis(mesh, axis)
    if size == 1:
        return True
    sums = [s.to(mesh.device) for t in _state_tensors(obj)
            for s in (t.detach().double().sum(), t.detach().double().square().sum())]
    hi = torch.stack(sums)
    lo = -hi
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
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


# ------------------------------------------------------------------ tensor parallelism
#
# The `model` axis (`cvpr23_lfdm_tpu/parallel/mesh.py`'s tensor-parallel
# rules): Megatron-style partitioning of the UNet. The JAX package lets
# GSPMD place the collectives; here each rank is a process that holds its
# shard of every partitioned leaf and runs the collectives below itself
# (`models/unet3d.py::shard_unet`).

UNET_TP_RULES: tuple[tuple[str, tuple], ...] = (
    # 3-channel output heads + norms + embeddings: replicate
    ("*final_conv/*", ()),
    ("*occlusion_conv/*", ()),
    ("*norm/*", ()),
    ("*relative_attention_bias*", ()),
    ("*null_cond_emb", ()),
    # attention: column-parallel QKV, row-parallel output projection
    ("*to_qkv/kernel", (None, "model")),
    ("*to_out/kernel", ("model", None)),
    ("*to_out/bias", ()),  # row-parallel output is full-size after the sum
    # FiLM conditioning MLPs: column-parallel into the sharded channels
    ("*mlp/kernel", (None, "model")),
    ("*mlp/bias", ("model",)),
    # (1,k,k) convs (proj/res_conv/up/down): output-channel sharding
    ("*conv/kernel", (None, None, None, "model")),
    ("*conv/bias", ("model",)),
    ("*res_conv/kernel", (None, None, None, None, "model")),
    ("*res_conv/bias", ("model",)),
    ("*upsample/kernel", (None, None, None, "model")),
    ("*upsample/bias", ("model",)),
)


def tp_spec(path: str, shape: tuple, axis_size: int, rules=UNET_TP_RULES, axis: str = "model") -> tuple:
    """The JAX `PartitionSpec` of one UNet leaf as a tuple (`()`:
    replicated). `path` is the '/'-joined JAX variable path, `shape` the
    JAX shape. First matching rule wins; unmatched leaves shard their last
    axis where divisible; an indivisible sharded axis replicates."""
    import fnmatch

    def resolve(entries):
        spec = tuple(axis if e == "model" else e for e in entries)
        for dim, name in enumerate(spec):
            if name is not None and shape[dim] % axis_size != 0:
                return ()
        return spec

    for pat, entries in rules:
        if fnmatch.fnmatch(path, pat):
            if len(entries) == 0:
                return ()
            if len(entries) != len(shape):
                continue  # rule written for a different rank
            return resolve(entries)
    if len(shape) >= 2 and shape[-1] % axis_size == 0:
        return resolve([None] * (len(shape) - 1) + [axis])
    return ()


def shard_plan(key: str, shape: tuple, size: int) -> tuple[int, int] | None:
    """`(port axis, parts)` of a UNet entry sharded over a `model` axis of
    `size` ranks, None where `tp_spec` replicates it. A rank holds the
    same slice of each of the `parts` equal blocks of that axis: q, k and v
    of its heads for `to_qkv` (3), scale and shift of its channels for a
    FiLM `mlp` (2), else one contiguous slice (1)."""
    import fnmatch

    from cvpr23_lfdm_torch.utils.bench_ckpt import jax_layout

    _, path, jshape, axes = jax_layout(key, shape)
    spec = tp_spec(path, jshape, size)
    if "model" not in spec:
        return None
    axis = axes[spec.index("model")]
    parts = 3 if fnmatch.fnmatch(path, "*to_qkv/kernel") else (
        2 if fnmatch.fnmatch(path, "*mlp/kernel") or fnmatch.fnmatch(path, "*mlp/bias") else 1)
    if shape[axis] % (parts * size):
        raise ValueError(f"{key}: {shape[axis]} entries along axis {axis} do not split into "
                         f"{parts} blocks over {size} model ranks")
    return axis, parts


def shard_index(n: int, parts: int, size: int, rank: int) -> torch.Tensor:
    """The entries of an axis of `n` that model rank `rank` of `size`
    holds: its `1 / size` of each of the `parts` blocks, in order."""
    k = n // parts
    w = k // size
    return torch.cat([torch.arange(t * k + rank * w, t * k + (rank + 1) * w) for t in range(parts)])


def shard_variables(state: dict, mesh: Mesh) -> dict:
    """This rank's shard of a one-process UNet state dict (or of any dict
    keyed as one, such as Adam's moments) under `UNET_TP_RULES`: each
    sharded entry cut to this model rank's slice (`shard_plan`), the rest
    as they are."""
    if mesh.model_size == 1:
        return dict(state)
    out = {}
    for key, value in state.items():
        plan = shard_plan(key, tuple(value.shape), mesh.model_size)
        if plan is None:
            out[key] = value
        else:
            axis, parts = plan
            idx = shard_index(value.shape[axis], parts, mesh.model_size, mesh.model_rank)
            out[key] = value.index_select(axis, idx.to(value.device)).contiguous()
    return out


def gather_variables(state: dict, mesh: Mesh, shapes: dict) -> dict:
    """The one-process state dict of a sharded one (`shard_variables`'s
    inverse, bit for bit): every entry that `shard_plan` shards at its
    one-process shape in `shapes` (by key; `Unet3D.tp_shapes`) gathered
    over the model group and put back in place. Every rank of the group
    calls it."""
    if mesh.model_size == 1:
        return dict(state)
    size, out = mesh.model_size, {}
    for key, value in state.items():
        plan = shard_plan(key, shapes[key], size)
        if plan is None:
            out[key] = value
            continue
        axis, parts = plan
        pieces = _all_gather(value.contiguous(), mesh.model_group, size)
        full = value.new_empty(shapes[key])
        for r, piece in enumerate(pieces):
            full.index_copy_(axis, shard_index(shapes[key][axis], parts, size, r).to(value.device), piece)
        out[key] = full
    return out


def _all_gather(x: torch.Tensor, group, size: int) -> list:
    """The group's tensors of `x`'s shape, in group-rank order. A bf16
    tensor travels as fp32 through gloo (exact both ways)."""
    wire = x.float() if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo" else x
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire.contiguous(), group=group)
    return [p.to(x.dtype) for p in parts]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `x`, a new tensor of `x`'s dtype. A bf16 or fp16
    `x` is summed in fp32 and rounded once, as one process rounds the
    product that the ranks' partials split."""
    out = (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()).contiguous()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Into a column-parallel layer: identity forward; backward, the sum
    over the model group of the ranks' partial input gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    """Out of a row-parallel layer: the sum of the ranks' partials forward;
    identity backward (every rank uses the sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """The ranks' channel shards concatenated along the last axis; backward,
    this rank's slice of the gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return torch.cat(_all_gather(x, mesh.model_group, mesh.model_size), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.mesh.model_rank * ctx.width, ctx.width).contiguous(), None


# The tp collectives below return their input as it is for no mesh (`mesh`
# None, a module's one-process form) or a model axis of one rank, so that
# one forward body serves both forms.


def _one_rank(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.model_size == 1


def copy_to_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if _one_rank(mesh) else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if _one_rank(mesh) else _ReduceFromModel.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if _one_rank(mesh) else _GatherChannels.apply(x, mesh)


def model_slice(t: torch.Tensor, mesh: Mesh | None, dim: int = 0) -> torch.Tensor:
    """This model rank's contiguous `1 / model_size` of `t` along `dim` (a
    view: the gradient reaches only that slice)."""
    if _one_rank(mesh):
        return t
    n = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_rank * n, n)


def sum_model_gradients(params, mesh: Mesh) -> None:
    """Replace each existing gradient by its sum over the model group: the
    replicated leaves that a rank uses only on its shard (a GroupNorm's
    channels, its heads' position bias) each hold the part of the
    gradient that their rank's slice made."""
    if mesh.model_size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_collective(grads, lambda flat: dist.all_reduce(flat, group=mesh.model_group), mesh.device)


def sharded_square_sum(tensors, mesh: Mesh) -> torch.Tensor:
    """The fp32 sum of squares of the whole tensors of which this rank holds
    the shards `tensors` (summed over the model group)."""
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for t in tensors:
        sq = sq + torch.linalg.vector_norm(t.float()).square().to(mesh.device)
    if mesh.model_size > 1:
        dist.all_reduce(sq, group=mesh.model_group)
    return sq


# ------------------------------------------------------------------ spatial partitioning
#
# The `space` axis: the image height of the LFAE's encoder and decoder cut
# into one contiguous band per rank (`models/generator.py::shard_generator`).
# Each helper returns its input as it is (a one-rank `halo_rows` pads with
# zeros) for no mesh or a space axis of one rank, so that one forward body
# serves both forms.


def _one_space_rank(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.space_size == 1


def local_band(x, mesh: Mesh | None, dim: int = 1):
    """This space rank's contiguous `1 / space_size` of the rows of `x`
    along `dim` (the height of `[B, H, W, C]`), a view."""
    if _one_space_rank(mesh):
        return x
    n = x.shape[dim]
    if n % mesh.space_size:
        raise ValueError(f"{n} rows along dim {dim} do not split into {mesh.space_size} bands")
    k = n // mesh.space_size
    return x.narrow(dim, mesh.space_rank * k, k)


def gather_band(x: torch.Tensor, mesh: Mesh | None, dim: int = 1) -> torch.Tensor:
    """The space group's bands of `x` concatenated along `dim` in space-rank
    order (the whole height), on every rank of the group."""
    if _one_space_rank(mesh):
        return x
    return torch.cat(_all_gather(x, mesh.space_group, mesh.space_size), dim=dim)


def _p2p_wire(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as point-to-point messages of `group`'s backend carry it: gloo's
    `send` and `recv` read and write host memory only, so under gloo a
    device tensor travels through a host copy, and bf16 as fp32 (exact
    both ways); NCCL takes the tensor on its device."""
    if dist.get_backend(group) == "gloo":
        x = x.to("cpu", torch.float32 if x.dtype == torch.bfloat16 else x.dtype)
    return x.contiguous()


def halo_rows(x: torch.Tensor, rows: int, mesh: Mesh | None, dim: int = 1) -> torch.Tensor:
    """`x` (this rank's band) with `rows` rows of each neighbouring band
    above and below along `dim`, and zeros past the image's top and bottom
    edges, as a convolution's zero padding puts there: `[.., n + 2 rows, ..]`.
    The rows travel by paired `isend` / `irecv` with the two neighbours
    (`batch_isend_irecv`); a band thinner than `rows` raises."""
    if rows == 0:
        return x
    n = x.shape[dim]
    zeros = lambda: x.new_zeros(x.shape[:dim] + (rows,) + x.shape[dim + 1:])  # noqa: E731
    if _one_space_rank(mesh):
        return torch.cat([zeros(), x, zeros()], dim)
    if rows > n:
        raise ValueError(f"a halo of {rows} rows from a band of {n}: the bands are too thin")
    group, r, size = mesh.space_group, mesh.space_rank, mesh.space_size
    ops, recvs = [], {}
    for peer, send in ((r - 1, x.narrow(dim, 0, rows)), (r + 1, x.narrow(dim, n - rows, rows))):
        if 0 <= peer < size:
            src = dist.get_global_rank(group, peer)
            wire = _p2p_wire(send, group)
            recvs[peer] = torch.empty_like(wire)
            ops += [dist.P2POp(dist.isend, wire, src, group), dist.P2POp(dist.irecv, recvs[peer], src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    got = lambda peer: recvs[peer].to(x.device, x.dtype) if peer in recvs else zeros()  # noqa: E731
    return torch.cat([got(r - 1), x, got(r + 1)], dim)


def broadcast_space(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The first space rank's `x` on every rank of the space group (a new
    tensor there; `x` itself on the first rank and for one rank)."""
    if _one_space_rank(mesh):
        return x
    group = mesh.space_group
    wire = (x.float() if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo"
            else x.clone()).contiguous()
    dist.broadcast(wire, dist.get_global_rank(group, 0), group=group)
    return x if mesh.space_rank == 0 else wire.to(x.dtype)
