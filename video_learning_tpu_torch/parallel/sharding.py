"""Parameter sharding over the model axis: tensor parallelism.

Counterpart of ``video_learning_tpu/parallel/sharding.py``.  The rule is
the JAX ``_spec_for_leaf``: a 2-D kernel is split column-wise when its
column count divides the model axis and it has at least 2^16 elements, a
1-D bias when it has at least 4,096 elements and divides the axis, and
everything else is replicated.  It is applied to the whole shapes of the
flat parameter names (conv kernels are 4-D and never split, so their
OIHW layout in the port does not matter).  Rank m of a model group holds
slice m of each split leaf, as JAX device m holds it.

Where JAX leaves the collectives to XLA, the port's layers read the
split from the parameter tree: ``Model.apply`` on a mesh marks every
entry holding a split kernel with a ``TensorParallel`` under the key
``"tp"``.  An FC so marked computes on its column slice and gathers the
output features (``layers.fc_apply``); the LSTM's fused kernels cannot
(a column slice holds other gates of other units), so ``whole`` gathers
them once per forward and the kernel runs whole on every rank.

At ``model=2`` the rule splits these leaves of the two models the port
runs at full width (``SHARDED_AT_MODEL_2``).
"""

from video_learning_tpu_torch.parallel.mesh import CopyToModel, GatherFromModel

# flagship(num_classes=101, fpc=16, image=227) and caption_flagship()
SHARDED_AT_MODEL_2 = {
    "flagship": ["clf/lstm/cells/0/w", "clf/lstm/cells/1/w",
                 "frames/dcnn/fc6/b", "frames/dcnn/fc6/w",
                 "frames/dcnn/fc7/b", "frames/dcnn/fc7/w"],
    "captioner": ["clf/lstm/cells/0/w", "clf/output_fc/b",
                  "clf/output_fc/w", "clf/state_fc/w",
                  "frames/dcnn/fc6/b", "frames/dcnn/fc6/w",
                  "frames/dcnn/fc7/b", "frames/dcnn/fc7/w"],
}


def spec_for_leaf(shape, model_size):
    """The dimension along which a leaf of whole ``shape`` is split over
    a model axis of ``model_size``, or None (replicated)."""
    if model_size <= 1:
        return None
    shape = tuple(shape)
    if len(shape) == 2 and shape[1] % model_size == 0 and \
            shape[0] * shape[1] >= 1 << 16:
        return 1                    # column-parallel kernel
    if len(shape) == 1 and shape[0] % model_size == 0 and \
            shape[0] >= 4096:
        return 0                    # matching wide bias
    return None


def sharded_leaves(shapes, model_size):
    """{flat name: split dimension} of the leaves the rule splits, from
    {flat name: whole shape}."""
    out = {}
    for name, shape in shapes.items():
        dim = spec_for_leaf(shape, model_size)
        if dim is not None:
            out[name] = dim
    return out


def shard_params(flat, mesh, leaves):
    """This rank's slices of a whole flat tree ({name: tensor}): the
    leaves in ``leaves`` ({name: dim}) sliced (contiguous copies), the
    others kept."""
    return {n: (mesh.model_slice(t, leaves[n]).contiguous()
                if n in leaves else t) for n, t in flat.items()}


def shard_tree(tree, mesh, leaves):
    """``shard_params`` of a nested parameter tree."""
    from video_learning_tpu_torch.checkpoint import (flatten_tree,
                                                     unflatten_tree)
    return unflatten_tree(shard_params(flatten_tree(tree), mesh, leaves))


def gather_params(flat, mesh, leaves):
    """The whole flat tree of this rank's slices (collective over the
    model group)."""
    return {n: (mesh.model_gather(t, leaves[n]) if n in leaves else t)
            for n, t in flat.items()}


class TensorParallel:
    """The mark of a parameter entry ({"w", "b"} or the int8 {"wq",
    "ws", "b", "xs"}) whose kernel is split by columns over ``mesh``'s
    model group; ``bias_split`` says whether its bias is split too."""

    def __init__(self, mesh, bias_split):
        self.mesh = mesh
        self.bias_split = bias_split

    def enter(self, x):
        """The layer input: identity forward, gradient summed over the
        model group."""
        return CopyToModel.apply(x, self.mesh)

    def gather(self, y, dim=-1):
        """The whole of a column-split ``y`` on every rank."""
        return GatherFromModel.apply(y, self.mesh, dim)

    def local_bias(self, b):
        """This rank's slice of the entry's bias."""
        return b if self.bias_split else self.mesh.model_slice(b, 0)

    def whole_entry(self, entry):
        """The entry with its split leaves gathered (gradient: each
        rank's own slice)."""
        out = {k: v for k, v in entry.items() if k != "tp"}
        out["w"] = self.gather(entry["w"], 1)
        if self.bias_split:
            out["b"] = self.gather(entry["b"], 0)
        return out


def whole(entry):
    """An entry as the single-process code reads it: a marked one with
    its kernel (and bias) gathered, any other as it is."""
    tp = entry.get("tp") if isinstance(entry, dict) else None
    return entry if tp is None else tp.whole_entry(entry)


def mark(tree, leaves, mesh):
    """A copy of the nested parameter ``tree`` (dicts, and lists for the
    LSTM cells; leaves shared) in which every entry whose ``w`` or
    ``wq`` leaf is in ``leaves`` carries a ``TensorParallel`` under
    "tp"."""
    entries = {}
    for name in leaves:
        parent, _, leaf = name.rpartition("/")
        if leaf in ("w", "wq"):
            entries[parent] = parent + "/b" in leaves

    def walk(node, path):
        if isinstance(node, dict):
            out = {k: walk(v, path + (str(k),)) for k, v in node.items()}
            here = "/".join(path)
            if here in entries and ("w" in node or "wq" in node):
                out["tp"] = TensorParallel(mesh, entries[here])
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node

    return walk(tree, ())
