"""Checkpoints and the weight carrier between the JAX package and the port.

Counterpart of the npz path of ``video_learning_tpu/checkpoint.py``: a
checkpoint is a data-only ``.npz`` of a flat {slash/joined/name: array}
dict (never pickle).  The names are the JAX ``flatten_tree`` names
(``frames/dcnn/conv1/w``, ``clf/lstm/cells/0/w``, ``clf/output_fc/b``;
under ``params/`` and ``ema_params/`` in a training checkpoint) and the
arrays are in the JAX layouts, so one file loads into either package.

Layouts differ in one place only: conv weights are HWIO in checkpoints
and OIHW (channels_last) inside the port.  Every 4-D leaf is a conv
weight (or an optimizer slot of one); FC weights stay (in, out) and LSTM
kernels stay fused.

``restore_checkpoint`` loads a file into a state tree by name, as the
JAX function does: names on one side only are reported (an error with
``strict``), names containing an ignorable substring are skipped, and a
leaf whose shape differs is reported and left as it is.
``prepare_eval_state`` / ``select_eval_params`` choose between the EMA
and the live weights for an evaluation, ``AsyncSaver`` writes on a
thread, and ``delete_checkpoint`` removes a checkpoint and its ``.snap``.
The optimizer state of ``Train.state_dict`` is JAX's: the leaves of
the optax state in optax's order (``train.opt_state_leaf_list``) under
``opt_state_leaves/<i>``, the step counts int32 and the slots float32
in the JAX layouts, so a training checkpoint has exactly the JAX
package's names and resumes in either package.  A checkpoint written
under the port's older names (``opt_state/<tier>/count``,
``opt_state/<tier>/{mu,nu}/<param>``) is read with those leaves renamed
into that order.
"""

import os

import numpy as np
import torch

from video_learning_tpu_torch.models.layers import hwio_to_oihw, oihw_to_hwio
from video_learning_tpu_torch.utils import (error, info, resolve_device,
                                            warning)

_SEP = "/"


def flatten_tree(tree, prefix=""):
    """Flatten a nested dict/list tree into {path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip(_SEP): tree}
    for k, v in items:
        path = prefix + str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_tree(v, path + _SEP))
        else:
            out[path] = v
    return out


def unflatten_tree(flat):
    """Inverse of flatten_tree: nested dicts, with a dict whose keys are
    exactly 0..n-1 turned back into a list (the LSTM ``cells``)."""
    root = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) and \
                sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def tree_order(names):
    """``names`` (flat slash-joined paths) in the order
    ``jax.tree_util.tree_flatten`` visits the tree they make: dict keys
    sorted at every level, and a list (a level keyed exactly 0..n-1,
    as ``unflatten_tree`` builds it) by index, so ``cells/10`` comes
    after ``cells/9``."""
    def walk(node):
        if isinstance(node, list):
            for v in node:
                yield from walk(v)
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k])
        else:
            yield node

    return list(walk(unflatten_tree({n: n for n in names})))


def from_jax_flat(flat, device="cuda"):
    """{JAX flat name: numpy array} -> {same name: float tensor on
    ``device``}, with 4-D HWIO conv weights moved to OIHW."""
    device = resolve_device(device)
    out = {}
    for name, value in flat.items():
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind not in "fiub":
            error("Checkpoint leaf [%s] is not a numeric array (%s)"
                  % (name, arr.dtype))
        t = torch.from_numpy(np.array(arr, order="C")).to(device)
        out[name] = hwio_to_oihw(t) if t.dim() == 4 else t
    return out


def to_jax_flat(params):
    """Port parameters (a nested tree or a flat dict of tensors) ->
    {JAX flat name: numpy array} in the JAX layouts."""
    out = {}
    for name, t in flatten_tree(params).items():
        if t is None:
            continue
        if isinstance(t, torch.Tensor):
            t = t.detach()
            t = oihw_to_hwio(t) if t.dim() == 4 else t
            t = t.to("cpu").numpy()
        out[name] = np.asarray(t)
    return out


def save_checkpoint(path, state):
    """Write a state tree (parameters, or ``Train.state_dict()``) as a
    JAX-compatible npz checkpoint, atomically (a ``.tmp`` file renamed
    into place)."""
    flat = to_jax_flat(state)
    for k, v in flat.items():
        if v.dtype == object:
            error("Checkpoint leaf [%s] is not a plain numeric array "
                  "(dtype=object); cannot save without pickle" % k)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_flat(path):
    """{name: numpy array} of an npz checkpoint (no pickle)."""
    if os.path.isdir(path):
        error("Checkpoint %s is a directory (an orbax checkpoint of the "
              "JAX package); the port reads npz checkpoints only" % path)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def get_checkpoint_tensor_names(path):
    """Names of all array leaves in a checkpoint."""
    return sorted(load_flat(path))


def _slots(tree, prefix=""):
    """{flat name: (container, key)} of every leaf of a dict/list tree
    (a dict key may itself hold slashes, as ``Train.state_dict``'s flat
    parameter dicts do)."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        path = prefix + str(k)
        if isinstance(v, (dict, list)):
            out.update(_slots(v, path + _SEP))
        else:
            out[path] = (tree, k)
    return out


def _copy_tree(tree):
    """Structural copy of a dict/list tree, leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return tree


def _into_port_layout(value, current):
    """A checkpoint array as the leaf it replaces holds it: a tensor on
    that leaf's device (4-D arrays HWIO -> OIHW), else the array."""
    if not isinstance(current, torch.Tensor):
        return value
    t = torch.from_numpy(np.array(value, order="C"))
    if t.dim() == 4:
        t = hwio_to_oihw(t)
    return t.to(current.device)


_OLD_OPT = "opt_state" + _SEP
_OPT_LEAVES = "opt_state_leaves"


def _renamed_old_opt_state(saved):
    """``saved`` with the port's older optimizer names
    (``opt_state/<tier>/count``, ``opt_state/<tier>/{mu,nu}/<param>``)
    renamed ``opt_state_leaves/<i>`` in optax's order, the counts int32.
    The optimizer of each tier follows from its slots: mu (Adam and
    AdamW, whose leaves are alike), nu alone (RMSProp) or none (SGD)."""
    old = {k[len(_OLD_OPT):]: v for k, v in saved.items()
           if k.startswith(_OLD_OPT)}
    if not old:
        return saved
    # train imports this module
    from video_learning_tpu_torch.train import opt_state_leaf_list
    slots, labels = {}, {}
    for key in old:
        tier, slot, *name = key.split(_SEP, 2)
        slots.setdefault(tier, set()).add(slot)
        if name:
            labels[name[0]] = tier
    kinds = {tier: "adam" if "mu" in s else "rmsprop" if "nu" in s
             else "sgd" for tier, s in slots.items()}
    out = {k: v for k, v in saved.items() if not k.startswith(_OLD_OPT)}
    entries = opt_state_leaf_list(kinds, labels)
    for i, (tier, slot, name) in enumerate(entries):
        if slot == "count":
            out["%s/%d" % (_OPT_LEAVES, i)] = np.asarray(
                old[tier + _SEP + slot], np.int32)
        else:
            out["%s/%d" % (_OPT_LEAVES, i)] = old[_SEP.join((tier, slot,
                                                             name))]
    info("Checkpoint holds the port's older optimizer names; read as "
         "%d optax leaves" % len(entries))
    return out


def restore_checkpoint(path, state, ignorable_names=None, strict=False,
                       loaded_out=None):
    """Load ``path`` into ``state`` (a mutable dict/list tree) by name:
    names missing on either side are reported (raised with ``strict``),
    names containing one of ``ignorable_names`` are skipped, and a leaf
    whose shape differs after the layout change is reported (raised with
    ``strict``) and kept.  ``loaded_out`` (a list) receives the names
    actually loaded.  A file under the port's older optimizer names is
    read as ``opt_state_leaves`` (module docstring).  Returns
    ``state``."""
    ignorable_names = ignorable_names or []
    saved = _renamed_old_opt_state(load_flat(path))
    slots = _slots(state)

    def ignorable(name):
        return any(ig in name for ig in ignorable_names)

    missing_from_ckpt = [n for n in slots
                         if n not in saved and not ignorable(n)]
    missing_from_curr = [n for n in saved
                         if n not in slots and not ignorable(n)]
    if missing_from_ckpt:
        msg = ("%d variables missing from checkpoint: %s"
               % (len(missing_from_ckpt), missing_from_ckpt[:16]))
        error(msg) if strict else warning(msg)
    if missing_from_curr:
        msg = ("%d checkpoint variables missing in the model: %s"
               % (len(missing_from_curr), missing_from_curr[:16]))
        error(msg) if strict else warning(msg)

    loaded_names = []
    for name, value in saved.items():
        if name not in slots or ignorable(name):
            continue
        container, key = slots[name]
        cur = container[key]
        value = _into_port_layout(value, cur)
        if hasattr(cur, "shape") and \
                tuple(cur.shape) != tuple(value.shape):
            msg = ("Shape mismatch for %s: checkpoint %s vs model %s"
                   % (name, tuple(value.shape), tuple(cur.shape)))
            error(msg) if strict else warning(msg)
            continue
        container[key] = value
        loaded_names.append(name)
    info("Restored %d/%d variables from %s"
         % (len(loaded_names), len(slots), path))
    if loaded_out is not None:
        loaded_out.extend(loaded_names)
    return state


# --------------------------------------------- EMA eval-weight selection
def prepare_eval_state(params, ignorables, use_ema):
    """The restore target of an evaluation: {"params"} and, with
    ``use_ema``, "ema_params" slots shaped like ``params`` for the EMA
    weights to be restored into; without it the EMA tree of a checkpoint
    is skipped by an ignorable.  Returns ``(state, ignorables)``."""
    state = {"params": params}
    if use_ema:
        state["ema_params"] = _copy_tree(params)
    else:
        ignorables = list(ignorables) + ["ema_params"]
    return state, ignorables


def select_eval_params(state, loaded_names, use_ema, resumed, origin):
    """The weights an evaluation runs: the restored EMA tree when
    ``use_ema`` and the checkpoint has one, else the live params.  EMA
    leaves the checkpoint lacked (shape drift) are taken from the
    restored live params, never left at their fresh values.
    ``loaded_names``: the restore's ``loaded_out``; ``origin`` labels
    the request in log lines.  Returns ``(params, ema_used)``."""
    if not use_ema:
        return state["params"], False
    if not resumed:
        warning("%s requested but no checkpoint is being restored; "
                "using the (fresh) live params" % origin)
        return state["params"], False
    got = set(n for n in (loaded_names or [])
              if n.startswith("ema_params" + _SEP))
    if not got:
        warning("%s requested but the checkpoint has no ema_params; "
                "using the live params" % origin)
        return state["params"], False
    slots = _slots({"ema_params": state["ema_params"]})
    missing = [n for n in slots if n not in got]
    if missing:
        warning("%s: %d EMA leaves missing from the checkpoint (shape "
                "drift?); seeding them from the restored live params"
                % (origin, len(missing)))
        live = flatten_tree({"params": state["params"]})
        for name in missing:
            container, key = slots[name]
            container[key] = live["params" + _SEP + name.split(_SEP, 1)[1]]
    info("Evaluating the EMA weights (%s)" % origin)
    return state["ema_params"], True


class AsyncSaver:
    """Writes one checkpoint at a time on a thread: ``submit`` first
    joins the previous write and re-raises its error, and ``wait`` joins
    the last one and re-raises its error, so no failed save passes
    unseen.  The state handed to it must be a snapshot
    (``Train.state_dict`` copies every tensor)."""

    def __init__(self):
        self._thread = None
        self._failure = None

    def submit(self, fn):
        import threading
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:     # re-raised on the main thread
                self._failure = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="vlt-ckpt-writer")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._failure is not None:
            failure, self._failure = self._failure, None
            raise failure


def delete_checkpoint(path):
    """Remove a checkpoint (a file, or a JAX orbax directory) and its
    ``.snap``."""
    for suffix in ("", ".snap"):
        target = path + suffix
        if os.path.isdir(target):
            import shutil
            shutil.rmtree(target)
        elif os.path.exists(target):
            os.remove(target)


def load_params(path, device="cuda"):
    """The parameter tree of an npz checkpoint written by either package.
    A JAX training checkpoint's ``params/`` subtree is taken; its
    optimizer state and step counter are not parameters."""
    flat = load_flat(path)
    prefix = "params" + _SEP
    if any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    return unflatten_tree(from_jax_flat(flat, device))
