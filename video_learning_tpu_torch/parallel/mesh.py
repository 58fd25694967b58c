"""The (data x model) mesh as ranks of ``torch.distributed``.

Counterpart of ``video_learning_tpu/parallel/mesh.py``.  The JAX package
runs one SPMD program over ``Mesh(devices.reshape(data, model), ("data",
"model"))`` and lets XLA insert the collectives.  The port runs one
process per rank and issues the collectives itself: rank r sits at data
coordinate r // model and model coordinate r % model, the row-major
layout of the JAX ``reshape``.  The ranks of one data coordinate form a
model group (they hold the same rows and split the wide kernels between
them); the ranks of one model coordinate form a data group (they hold
the same parameter slices and different rows).

* ``init_distributed`` joins the group a launcher describes
  (``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``): NCCL on CUDA,
  gloo on the CPU, gloo on CUDA only when asked for (ranks that share a
  card: NCCL refuses two ranks on one device).  A world of one rank
  joins nothing.
* ``make_mesh`` builds (once per shape) the ``Mesh`` of the run config's
  ``mesh_shape``, with the JAX defaults (``model`` 1, ``data`` the rest);
  a shape that does not fill the world raises.
* ``shard_feed`` takes this rank's rows of a global feed.
* ``CopyToModel`` and ``GatherFromModel`` are the two autograd Functions
  of a column-parallel layer: identity forward with the input gradient
  summed over the model group, and an all-gather of the output features
  whose backward is the rank's own slice.
* ``use(mesh)`` makes a mesh current for ``Model.apply``; the int8 layers
  take the MAX of their activation amax over the data group from it, so
  that every rank quantizes with the amax of the global batch.
* ``broadcast_ints`` and ``broadcast_array`` send rank 0's host values to
  every rank (``tools/serve`` hands each request batch to the ranks so).

Only ``all_reduce``, the list form of ``all_gather``, ``broadcast`` and
``barrier`` are used: gloo offers them on CUDA tensors too.
"""

import contextlib
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from video_learning_tpu_torch.utils import error, info, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_axes(mesh_shape, world_size):
    """(data, model) of ``mesh_shape`` in a world of ``world_size`` ranks,
    with the JAX defaults: model 1, data the rest."""
    shape = dict(mesh_shape or {})
    model = int(shape.get(MODEL_AXIS, 1))
    data = int(shape.get(DATA_AXIS, world_size // model if model > 0 else 0))
    return data, model


def world():
    """(world size, rank) of an initialised process group, else
    (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_primary():
    """Whether this process is global rank 0, the one writer of a shared
    run folder."""
    return world()[1] == 0


def init_distributed(device="cuda", backend=None):
    """Join the process group of the launcher's environment and return
    this rank's device.  ``device`` "cuda" means ``cuda:LOCAL_RANK``; an
    explicit index (``cuda:0``) puts every rank on that card, which only
    gloo allows.  ``backend`` defaults to NCCL on CUDA and gloo on the
    CPU.  There is no fallback: too few cards, or NCCL on shared cards,
    raises.  Without ``WORLD_SIZE`` above 1 nothing is joined."""
    size = int(os.environ.get("WORLD_SIZE", "1") or 1)
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and size > 1:
        dev = torch.device("cuda", local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        error("backend must be nccl or gloo, got %r" % (backend,))
    if backend == "nccl" and dev.type != "cuda":
        error("The NCCL backend needs CUDA devices; the CPU takes gloo")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index is not None and dev.index >= count:
            error("Rank with LOCAL_RANK %d wants %s but %d card(s) are "
                  "visible: NCCL takes one card per rank; ranks that "
                  "share a card need backend='gloo' and an explicit "
                  "device such as 'cuda:0'" % (local, dev, count))
        if size > 1 and backend == "nccl":
            torch.cuda.set_device(dev)
    if size <= 1 or dist.is_initialized():
        return dev
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        error("WORLD_SIZE=%d but %s unset: start the ranks with python "
              "-m torch.distributed.run" % (size, missing))
    dist.init_process_group(backend, init_method="env://", world_size=size,
                            rank=int(os.environ["RANK"]))
    info("Joined a %s group of %d ranks as rank %d on %s"
         % (backend, size, dist.get_rank(), dev))
    return dev


class Mesh:
    """The (data, model) grid of the world's ranks, its sub-groups and
    this rank's coordinates.  Building one is collective: every rank
    builds the same meshes in the same order (``make_mesh`` caches
    them)."""

    def __init__(self, mesh_shape=None):
        size, rank = world()
        shape = dict(mesh_shape or {})
        unknown = sorted(set(shape) - {DATA_AXIS, MODEL_AXIS})
        if unknown:
            error("mesh_shape axes are data and model; got %s" % unknown)
        data, model = mesh_axes(shape, size)
        if data < 1 or model < 1 or data * model != size:
            error("Mesh shape data=%d x model=%d does not fill the world "
                  "of %d rank(s): every rank needs a place, and a rank "
                  "without one would hang its peers at their first "
                  "collective" % (data, model, size))
        self.data, self.model = data, model
        self.size, self.rank = size, rank
        self.data_index, self.model_index = rank // model, rank % model
        self.data_group = self.model_group = None
        if size > 1:
            for m in range(model):
                group = dist.new_group([d * model + m for d in range(data)])
                if m == self.model_index:
                    self.data_group = group
            for d in range(data):
                group = dist.new_group([d * model + m for m in range(model)])
                if d == self.data_index:
                    self.model_group = group
            info("Mesh: %d ranks as (%s=%d, %s=%d); rank %d at (%d, %d)"
                 % (size, DATA_AXIS, data, MODEL_AXIS, model, rank,
                    self.data_index, self.model_index))

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    # ------------------------------------------------------ collectives
    def data_sum(self, t):
        """``t`` summed over the data group, in place."""
        if self.data > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)
        return t

    def data_max(self, t):
        """``t``'s elementwise MAX over the data group, in place."""
        if self.data > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.data_group)
        return t

    def model_sum(self, t):
        """``t`` summed over the model group, in place."""
        if self.model > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        return t

    def world_max(self, t):
        """``t``'s elementwise MAX over every rank, in place."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    @staticmethod
    def _gather(t, dim, group, n):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    def model_gather(self, t, dim=-1):
        """The model group's slices of ``t`` joined along ``dim``, in
        model-coordinate order."""
        if self.model == 1:
            return t
        return self._gather(t, dim, self.model_group, self.model)

    def data_gather(self, t, dim=0):
        """The data group's ``t`` joined along ``dim`` (rows, by default),
        in data-coordinate order."""
        if self.data == 1:
            return t
        return self._gather(t, dim, self.data_group, self.data)

    def model_slice(self, t, dim=-1):
        """This rank's slice of a whole ``t`` along ``dim``."""
        if self.model == 1:
            return t
        if t.shape[dim] % self.model:
            error("Dimension %d of size %d does not split over the model "
                  "axis (%d)" % (dim, t.shape[dim], self.model))
        return t.chunk(self.model, dim)[self.model_index]

    def data_rows(self, t):
        """This rank's rows of a global batch-leading ``t``."""
        if self.data == 1:
            return t
        if t.shape[0] % self.data:
            error("Global batch of %d rows does not split over the data "
                  "axis (%d); pad the batch or resize the mesh"
                  % (t.shape[0], self.data))
        return t.chunk(self.data, 0)[self.data_index]

    def barrier(self):
        if self.size > 1:
            dist.barrier()


_MESHES = {}


def make_mesh(mesh_shape=None):
    """The ``Mesh`` of ``mesh_shape`` in the current world, built once
    per shape (``dist.new_group`` is collective, so every rank asks for
    the same shapes in the same order and gets the cached groups)."""
    size, rank = world()
    shape = dict(mesh_shape or {})
    key = (size, rank, id(dist.group.WORLD) if size > 1 else None,
           tuple(sorted(shape.items())))
    if key not in _MESHES:
        _MESHES[key] = Mesh(shape)
    return _MESHES[key]


def shard_feed(feed, mesh):
    """This rank's rows of a global feed: every batch-leading array (or
    tensor) split over the data axis; 0-d values are kept.  The run
    driver's feeds are already local (each data rank reads its own host
    shard)."""
    out = {}
    for k, v in feed.items():
        if getattr(v, "ndim", 0) >= 1:
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            rows = mesh.data_rows(t)
            out[k] = rows if isinstance(v, torch.Tensor) else \
                rows.numpy()
        else:
            out[k] = v
    return out


# ------------------------------------------------- host values to every rank
def _wire_device():
    """Where a broadcast's tensor lives: the rank's card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_ints(values, length, src=0):
    """Rank ``src``'s list of at most ``length`` ints (``values``; the
    other ranks pass None) on every rank, zero-padded to ``length``: one
    broadcast over the world group."""
    t = torch.zeros(length, dtype=torch.int64, device=_wire_device())
    if dist.get_rank() == src:
        if len(values) > length:
            error("%d ints do not fit a broadcast of %d"
                  % (len(values), length))
        t[:len(values)] = torch.tensor(values, dtype=torch.int64)
    dist.broadcast(t, src)
    return t.tolist()


def broadcast_array(array, shape, dtype, src=0):
    """Rank ``src``'s numpy ``array`` (the other ranks pass None) as a
    numpy array on every rank; every rank knows its ``shape`` and
    ``dtype``."""
    if dist.get_rank() == src:
        t = torch.from_numpy(np.ascontiguousarray(array)).to(_wire_device())
    else:
        t = torch.empty(tuple(shape), dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype, device=_wire_device())
    dist.broadcast(t, src)
    return t.cpu().numpy()


# ------------------------------------------------------ the current mesh
_CURRENT = threading.local()


@contextlib.contextmanager
def use(mesh):
    """Make ``mesh`` current for the calls inside (``Model.apply`` on a
    mesh); None, or a world of one, leaves nothing current."""
    prev = getattr(_CURRENT, "mesh", None)
    _CURRENT.mesh = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _CURRENT.mesh = prev


def current():
    """The mesh ``use`` made current, or None."""
    return getattr(_CURRENT, "mesh", None)


def data_max(t):
    """``t``'s MAX over the current mesh's data group (in place); ``t``
    itself without one.  The int8 layers reduce their activation amax
    with it, the amax of the global batch."""
    mesh = current()
    return t if mesh is None else mesh.data_max(t)


# ------------------------------------------- column-parallel autograd ops
class CopyToModel(torch.autograd.Function):
    """Identity forward of an input every rank of the model group holds;
    its gradient, a partial sum on each rank, is summed over the group
    (Megatron's f operator)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g.contiguous().clone()), None


class GatherFromModel(torch.autograd.Function):
    """All-gather of the model group's slices along ``dim``; the
    gradient of the whole is the same on every rank of the group (they
    compute one loss), so each keeps its own slice of it."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_slice(g, ctx.dim).contiguous(), None, None
