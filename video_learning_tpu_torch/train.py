"""Training engine: loss, lr schedule, optimizers and the train step.

Counterpart of ``video_learning_tpu/train.py``:

* the lr schedule precomputed on the host for every batch of every epoch
  (``precompute_learning_rates``, the JAX function line for line, its
  exp == staircase quirk, cosine, warmup, drop offset and schedule file
  included),
* the optimizers as plain tensor updates with optax's semantics, not
  ``torch.optim``'s: SGD, Adam, RMSProp (eps inside the square root, the
  second moment starting at 0) and AdamW (decoupled decay on tensors of
  more than one dimension), after a global-norm clip and then the
  per-tensor ``clip_grads`` cap; with ``lr_mult`` set, the parameters
  under the model's 'modified' prefixes train at lr x lr_mult in a tier
  with its own step count, as under ``optax.multi_transform``,
* softmax cross-entropy with a row mask, the masked-mean step
  (``accum_steps`` 1) and the micro-batch-sum step (``accum_steps`` > 1,
  a Python loop over equal micro-batches),
* the weight EMA and the metrics loss, lr, grad_norm and accuracy.

The parameters are float32 leaf tensors that require gradients; the step
differentiates with ``torch.autograd.grad`` and then updates them in
place (JAX builds new arrays; in place saves a copy of every parameter).
The optimizer state lives on the device and is written in place too: a
step count per tier indexing an lr table there, Adam's bias corrections
computed from it in float32, the global-norm clip as optax's select, and
a device step counter for the metrics' lr.  Nothing in the step reads a
value back to the host, so on the card the step (and
``compile_scan_steps``, N steps as one program) is captured as a CUDA
graph and replayed (``graphs.py``), as the JAX package compiles its step
once with ``jax.jit``; ``run_step`` copies a feed into the captured
buffers, replays, and reads the metrics back in one copy.
As in JAX, every feed is padded to the run's ``BatchGeometry`` (the epoch
tail gets ``label_mask`` zeros) and moved to the device by
``prepare_device_feed``, which a ``FeedPrefetcher`` runs in its thread;
``run_step`` skips that work for a feed so prepared.  The run config's
``watch_tensors`` add the mean, std (over N), min and max of each
watched parameter and its gradient to the metrics, computed in float32
on the device.
On a mesh (``mesh``, or the run config's ``mesh_shape`` in a group of
more than one rank; ``parallel/mesh.py``) each rank keeps its slices of
the leaves the JAX rule splits over the model axis, and their moments
and EMA alike, and feeds its own rows (``batch_size`` is per data rank,
as each JAX process feeds its local rows).  The step computes the
gradient of the rank's masked loss sum, adds the gradients, the loss
sums, the mask counts and the correct counts over the data group in one
all-reduce, and divides by the global count: a step on an (N, M) mesh
is the single-device step on the global batch up to float
reassociation.  The global-norm clip counts a split gradient once (its
squares summed over the model group).  ``state_dict`` gathers whole
tensors and ``load_state_dict`` slices them, so checkpoints are those of
one process.  An NCCL mesh runs the step as a graph replay, collectives
included; a gloo mesh runs it eagerly (see ``Train``).
Dropout draws on the parameters' device from one persistent generator
per micro-batch and pipeline, re-seeded before every step from
``fold_in(seed + 1, global_step)`` (then ``fold_in`` of the micro-batch
and of the pipeline): the same structure of streams as the JAX
``fold_in``, not the same bits.  A graph registers these generators and
reads their seeds at each replay, so a replayed step draws the masks of
the eager step at the same seed.
"""

import math
import os
import re

import numpy as np
import torch

from video_learning_tpu_torch import graphs as graphs_mod
from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.checkpoint import (flatten_tree, tree_order,
                                               unflatten_tree)
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.ops.preprocess import (make_preprocessor,
                                                     supports_device_path)
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.parallel import sharding
from video_learning_tpu_torch.utils import (error, fold_in, info,
                                            resolve_device, warning)

# the key prepare_device_feed adds to a feed it has padded and moved
ON_DEVICE = "__on_device__"

# eager steps at a feed geometry, the last of them followed by the
# capture of the step: the first call of every library and kernel (cuBLAS
# handles and workspaces on the capture stream, a kernel's shared-memory
# opt-in) happens outside the capture
WARMUP_STEPS = 2

# optax.adam / optax.adamw and optax.rmsprop defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8


# ----------------------------------------------------------- lr schedule
def precompute_learning_rates(settings, num_batches):
    """The lr of every batch of the run, as ``train.py:52-143`` of the JAX
    package computes it.  ``exp`` gives the same schedule as
    ``staircase`` on purpose: the reference only ever divides multiples
    of decay_freq, so its smooth fraction is always an integer.  Writes
    ``<run_id>_lr_decay_schedule.txt`` when the settings name a run
    folder."""
    base_lr = settings.train.base_lr
    decay_params = settings.train.lr_decay
    total = num_batches * settings.train.epochs
    warmup = int(getattr(settings.train, "lr_warmup", 0) or 0)
    if decay_params is None:
        lr_per_batch = [base_lr] * total
        for i in range(min(warmup, total)):
            lr_per_batch[i] = base_lr * (i + 1) / warmup
        return lr_per_batch
    lr_drop_offset = 0 if len(tuple(decay_params)) == 4 else decay_params[-1]
    decay_strategy, decay_scheme, decay_freq, decay_factor = \
        tuple(decay_params[:4])

    cosine = False
    if decay_strategy == defs.decay.exp:
        staircase = False
    elif decay_strategy == defs.decay.staircase:
        staircase = True
    elif decay_strategy == defs.decay.cosine:
        # half-cosine from base_lr to base_lr * decay_factor over the run,
        # piecewise constant like the other strategies
        cosine, staircase = True, False
    else:
        error("Undefined decay strategy %s" % decay_strategy)

    if decay_scheme == defs.periodicity.interval:
        decay_period = decay_freq
    elif decay_scheme == defs.periodicity.drops:
        decay_period = math.ceil(total / decay_freq)
    else:
        error("Undefined decay scheme %s" % decay_scheme)

    lr_per_batch = []
    idx = 0
    while len(lr_per_batch) < total:
        if cosine:
            floor = decay_factor
            progress = min(idx / max(total - decay_period, 1), 1.0)
            current = base_lr * (
                floor + (1.0 - floor) * 0.5 *
                (1.0 + math.cos(math.pi * progress)))
            idx += decay_period
        else:
            fraction = idx // decay_freq if staircase else idx / decay_freq
            current = base_lr * pow(decay_factor, fraction)
            idx += decay_freq
        lr_per_batch.extend(current for _ in range(decay_period))
    lr_per_batch = lr_per_batch[:total]
    if lr_drop_offset:
        lr_per_batch = [base_lr] * lr_drop_offset + \
            lr_per_batch[:-lr_drop_offset]

    for i in range(min(warmup, total)):
        lr_per_batch[i] = lr_per_batch[i] * (i + 1) / warmup

    if settings.run_folder and mesh_mod.is_primary():
        sched_file = os.path.join(
            settings.run_folder, settings.run_id + "_lr_decay_schedule.txt")
        with open(sched_file, "w") as f:
            k = 0
            for ep in range(settings.train.epochs):
                for b in range(num_batches):
                    f.write("Epoch %d/%d, batch %d/%d, lr %2.8f\n"
                            % (ep + 1, settings.train.epochs, b + 1,
                               num_batches, lr_per_batch[k]))
                    k += 1
    info("LR schedule: base %2.5f, %d steps, %d distinct values"
         % (base_lr, total, len(set(lr_per_batch))))
    return lr_per_batch


# ------------------------------------------------------------- optimizer
def _sum_squares(tensors):
    total = 0.0
    for t in tensors:
        total = total + t.to(torch.float32).square().sum()
    return torch.as_tensor(total, dtype=torch.float32)


def global_norm(tensors):
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    summed tensor by tensor in order."""
    return torch.sqrt(_sum_squares(tensors))


class _Tier:
    """One base optimizer (``optax.sgd`` / ``adam`` / ``rmsprop`` /
    ``adamw``) over a subset of the parameters, with its own step count.
    The state lives on the parameters' device: the count is a 0-d int64
    tensor, the lr comes from a table there indexed by it, and ``update``
    returns the additive updates and advances the moments and the count
    in place (so a captured step keeps reading and writing the same
    tensors)."""

    def __init__(self, kind, lr_array, mult, weight_decay):
        if kind not in (defs.optim.sgd, defs.optim.adam, defs.optim.rmsprop,
                        defs.optim.adamw):
            error("Undefined optimizer %s" % kind)
        self.kind = kind
        table = np.asarray(lr_array, np.float32)
        if mult is not None:
            table = table * np.float32(mult)
        self.lr_array = table.astype(np.float32)
        self.weight_decay = float(weight_decay)
        self._table = None

    def lr(self, count):
        """The lr at the device step count ``count`` (the schedule's last
        entry beyond its end), a 0-d float32 tensor on the state's
        device."""
        i = count.clamp(0, len(self.lr_array) - 1).reshape(1)
        return self._table.index_select(0, i).reshape(())

    def init(self, params, device):
        self._table = torch.as_tensor(self.lr_array, device=device)
        state = {"count": torch.zeros((), dtype=torch.int64, device=device)}
        if self.kind in (defs.optim.adam, defs.optim.adamw):
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind != defs.optim.sgd:
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def update(self, grads, state, params):
        count = state["count"]
        step_size = -self.lr(count)
        if self.kind in (defs.optim.adam, defs.optim.adamw):
            # optax's bias corrections, in float32 from the count
            c = (count + 1).to(torch.float32)
            bc1 = 1 - torch.pow(torch.full((), ADAM_B1, device=c.device), c)
            bc2 = 1 - torch.pow(torch.full((), ADAM_B2, device=c.device), c)
        out = {}
        for n, g in grads.items():
            if self.kind == defs.optim.sgd:
                u = g
            elif self.kind == defs.optim.rmsprop:
                nu = state["nu"][n]
                nu.copy_((1 - RMS_DECAY) * g.square() + RMS_DECAY * nu)
                u = torch.rsqrt(nu + RMS_EPS) * g
            else:
                mu, nu = state["mu"][n], state["nu"][n]
                mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
                nu.copy_((1 - ADAM_B2) * g.square() + ADAM_B2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                if self.kind == defs.optim.adamw and params[n].dim() > 1:
                    u = u + self.weight_decay * params[n]
            out[n] = step_size * u
        count.add_(1)
        return out


class Optimizer:
    """The JAX ``make_optimizer`` chain: an optional global-norm clip,
    then the optional per-tensor norm cap of ``clip_grads``, then one
    base optimizer, or two tiers by parameter label ('regular' at the
    scheduled lr, 'modified' at lr x lr_mult)."""

    def __init__(self, train, lr_array, labels=None):
        self.clip_norm = float(train.clip_norm) if train.clip_norm else None
        clip_grads = getattr(train, "clip_grads", None)
        self.clip_per_tensor = (max(abs(clip_grads[0]), abs(clip_grads[1]))
                                if clip_grads else None)
        wd = float(getattr(train, "weight_decay", 0.0) or 0.0)
        self.labels = labels
        # on a mesh: {name: split dim} of the gradients held in slices
        self.mesh, self.split = None, {}
        if labels is None:
            self.tiers = {"regular": _Tier(train.optimizer, lr_array, None,
                                           wd)}
        else:
            self.tiers = {"regular": _Tier(train.optimizer, lr_array, None,
                                           wd),
                          "modified": _Tier(train.optimizer, lr_array,
                                            train.lr_mult, wd)}

    def leaf_list(self, names):
        """``opt_state_leaf_list`` of this optimizer over the parameter
        ``names``."""
        labels = self.labels or dict.fromkeys(names, "regular")
        return opt_state_leaf_list(
            {tier: t.kind for tier, t in self.tiers.items()},
            {n: labels[n] for n in names})

    def _split(self, tree):
        if self.labels is None:
            return {"regular": tree}
        out = {tier: {} for tier in self.tiers}
        for n, v in tree.items():
            out[self.labels[n]][n] = v
        return out

    def norm(self, grads):
        """The global norm of ``grads`` ({name: tensor}); on a mesh a
        split gradient's squares are summed over the model group, so
        that each element counts once, and a replicated one counts once
        too."""
        if not self.split:
            return global_norm(grads.values())
        ss = self.mesh.model_sum(_sum_squares(
            g for n, g in grads.items() if n in self.split))
        return torch.sqrt(ss + _sum_squares(
            g for n, g in grads.items() if n not in self.split))

    def init(self, params):
        """The state of every tier, on the parameters' device."""
        device = next(iter(params.values())).device
        parts = self._split(params)
        return {tier: t.init(parts[tier], device)
                for tier, t in self.tiers.items()}

    def update(self, grads, state, params):
        """Updates to add to the parameters; ``state`` advances in
        place.  Nothing here reads a value back to the host: the clip is
        optax's select (``torch.where``), not a branch."""
        if self.clip_norm is not None:
            g_norm = self.norm(grads)
            keep = g_norm < self.clip_norm
            grads = {n: torch.where(keep, g, (g / g_norm) * self.clip_norm)
                     for n, g in grads.items()}
        if self.clip_per_tensor is not None:
            clipped = {}
            for n, g in grads.items():
                ss = g.square().sum()
                if n in self.split:
                    ss = self.mesh.model_sum(ss)
                norm = torch.sqrt(ss)
                scale = torch.clamp(self.clip_per_tensor /
                                    torch.clamp(norm, min=1e-12), max=1.0)
                clipped[n] = g * scale
            grads = clipped
        g_parts, p_parts = self._split(grads), self._split(params)
        updates = {}
        for tier, t in self.tiers.items():
            updates.update(t.update(g_parts[tier], state[tier],
                                    p_parts[tier]))
        return updates


def opt_state_leaf_list(kinds, labels):
    """The leaves of the JAX optimizer state
    (``jax.tree_util.tree_flatten`` of ``make_optimizer(...).init``) in
    optax's order, as (tier, slot, parameter name or None) entries.
    ``kinds``: {tier: optimizer}; ``labels``: {parameter name: tier}.
    The clips hold no leaves; the tiers come in sorted order (the dict
    of ``optax.multi_transform``; one tier is the base optimizer alone);
    a tier's slots cover its own parameters in JAX's tree order
    (``checkpoint.tree_order``), the others being masked out.  Per tier:
    SGD the schedule's count; RMSProp nu, then the count; Adam and AdamW
    the count of ``scale_by_adam``, mu, nu, then the schedule's count
    (AdamW's masked decay holds none).  The port keeps one count per
    tier, which stands for both."""
    entries = []
    for tier in sorted(kinds):
        kind = kinds[tier]
        names = tree_order(n for n, t in labels.items() if t == tier)
        if kind in (defs.optim.adam, defs.optim.adamw):
            entries.append((tier, "count", None))
            entries += [(tier, slot, n) for slot in ("mu", "nu")
                        for n in names]
        elif kind == defs.optim.rmsprop:
            entries += [(tier, "nu", n) for n in names]
        entries.append((tier, "count", None))
    return entries


def make_label_tree(names, modified_prefixes):
    """{name: 'regular' | 'modified'} by path prefix (the two-tier groups
    of ``Model.param_groups``)."""
    return {n: ("modified" if any(n.startswith(p) for p in modified_prefixes)
                else "regular") for n in names}


def make_optimizer(settings, lr_array, labels=None):
    """The optimizer of the settings over the precomputed lr schedule;
    two tiers when ``lr_mult`` is set and labels are given."""
    if settings.train.lr_mult is None:
        labels = None
    return Optimizer(settings.train, lr_array, labels)


# ------------------------------------------------------------------ loss
def softmax_cross_entropy(logits, onehot_labels, mask=None):
    """Softmax cross-entropy against (multi-)hot labels, mean-reduced over
    the rows, or over the rows the 0/1 ``mask`` keeps."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    per_row = -(onehot_labels.to(torch.float32) * logp).sum(-1)
    if mask is None:
        return per_row.mean()
    mask = mask.to(torch.float32)
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)


def _correct(logits, labels):
    return (logits.argmax(1) == labels.argmax(1)).to(torch.float32)


# ----------------------------------------------------------------- engine
class Train:
    """Owns the parameters, the optimizer state and the train step.

    ``params``: a parameter tree to start from (e.g. carried from the JAX
    package with ``checkpoint.from_jax_flat``) instead of fresh ones from
    ``seed``; its names must be the model's.  ``device`` defaults to the
    GPU; pass ``device="cpu"`` to train on the CPU.  ``conv1_fwd``,
    ``conv1_dw`` and ``freeze_conv1`` pick the stem conv's forward
    ("direct" or "s2d") and weight gradient ("shifted", "blocked" or
    "im2col") and freeze its parameters (``alexnet.apply``; None reads
    the JAX package's environment variables at each eager step, and a
    captured step keeps what its capture read).  A frozen conv1 gets
    zero gradients, which the optimizer chain still runs on, as optax
    does on ``jax.grad`` of a ``stop_gradient``.
    ``graphs`` (default: on for a CUDA device) runs the step and
    ``compile_scan_steps`` as CUDA graph replays after ``WARMUP_STEPS``
    eager steps at each feed geometry; ``graphs=False`` keeps the eager
    step.  The CPU has no graphs.  ``mesh`` (default: ``make_mesh`` of
    ``settings.mesh_shape``, a world of one outside a process group)
    trains on a (data x model) mesh (module docstring).  On an NCCL
    mesh ``graphs`` defaults as on one card: the captured step holds its
    collectives (the data group's sums, the model group's clip-norm sums
    and gathers), which NCCL runs on the card's streams.  On a gloo mesh
    graphs default to off and ``graphs=True`` raises: gloo's collectives
    run on the host, which a CUDA graph cannot capture
    (``parallel.mesh.graphs_on_mesh``).

    Every tensor of the state (parameters, moments, step counts, EMA,
    the device step counter) is created once and then only written in
    place, so a captured step keeps reading and writing the right memory:
    ``load_state_dict`` copies into them, and nothing may rebind them."""

    def __init__(self, settings, feeder, model, seed=0, params=None,
                 device="cuda", conv1_dw=None, graphs=None,
                 mesh=None, conv1_fwd=None, freeze_conv1=None):
        if not settings.train:
            error("Train needs settings.train")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh(
            getattr(settings, "mesh_shape", None))
        graphs = mesh_mod.graphs_on_mesh(self.mesh, graphs, "Train")
        self.graphs = (self.device.type == "cuda" if graphs is None
                       else bool(graphs))
        if self.graphs and self.device.type != "cuda":
            error("Train: graphs=True needs a CUDA device; the CPU runs "
                  "the eager step (graphs=False)")
        self.settings = settings
        self.model = model
        self.feeder = feeder
        self.conv1 = {"conv1_fwd": conv1_fwd, "conv1_dw": conv1_dw,
                      "freeze_conv1": freeze_conv1}
        info("Creating training: optimizer %s, base lr %s, %d classes"
             % (settings.train.optimizer, settings.train.base_lr,
                settings.num_classes))
        self.lr_array = np.asarray(
            precompute_learning_rates(settings, feeder.get_num_batches()),
            np.float32)
        self._accum = int(getattr(settings.train, "accum_steps", 1) or 1)
        if self._accum > 1:
            self._check_accum_geometry()
        set_feed_device = getattr(feeder, "set_feed_device", None)
        if set_feed_device is not None:
            set_feed_device(self.device)
        self._geometry = BatchGeometry()
        self._copy_stream = None

        fresh = model.init_params(seed, device="cpu" if params is not None
                                  else self.device)
        if params is None:
            params = fresh
        flat = flatten_tree(params)
        if sorted(flat) != sorted(flatten_tree(fresh)):
            error("Train: the parameter names differ from the model's: %s"
                  % sorted(set(flat) ^ set(flatten_tree(fresh))))
        # {name: split dim} of the leaves this rank holds in slices
        self._split = (model.sharded_leaves(self.mesh.model)
                       if self.mesh.size > 1 else {})
        # float32 leaves that require gradients, in name order; the nested
        # tree the model reads holds the same tensors
        self._flat = {n: self._local(n, flat[n].detach().to(
            self.device, torch.float32)).clone().requires_grad_(True)
            for n in sorted(flat)}
        self.params = unflatten_tree(self._flat)
        _, modified = model.param_groups()
        self.tx = make_optimizer(settings, self.lr_array,
                                 make_label_tree(self._flat, modified))
        self.tx.mesh, self.tx.split = self.mesh, self._split
        self.opt_state = self.tx.init(self._flat)
        # the optax leaves of the state, as checkpoints hold them
        self._opt_leaves = self.tx.leaf_list(self._flat)
        self._ema_decay = float(getattr(settings.train, "ema_decay", 0.0)
                                or 0.0)
        self.ema = ({n: p.detach().clone() for n, p in self._flat.items()}
                    if self._ema_decay else None)
        self.seed = int(seed)
        # the step counter on the device (the metrics' lr index), mirrored
        # on the host
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._lr_t = torch.as_tensor(self.lr_array, device=self.device)
        self.global_step = int(settings.global_step)
        # one dropout generator per micro-batch and pipeline, on the
        # device, re-seeded before every step
        self._dropout_gens = [[torch.Generator(self.device)
                               for _ in model.specs]
                              for _ in range(self._accum)]
        self._preprocessors = self._build_preprocessors()
        self._watched = self._watch_list(
            getattr(settings, "watch_tensors", None) or [])
        self.metric_names = ["loss", "lr", "grad_norm", "accuracy"] + [
            "%s/%s/%s" % (kind, name, stat) for kind in ("param", "grad")
            for name in self._watched
            for stat in ("mean", "std", "min", "max")]
        # the captured step and scan programs, by kind and feed signature;
        # a replay's metrics vector is read at once, so it is not copied
        self.graph_cache = graphs_mod.ProgramCache(
            "Train", generators=[g for gens in self._dropout_gens
                                 for g in gens], clone=False)

    @property
    def global_step(self):
        return self._global_step

    @global_step.setter
    def global_step(self, value):
        self._global_step = int(value)
        self._step_t.fill_(self._global_step)

    def _local(self, name, t):
        """This rank's slice of the whole tensor ``t`` of leaf ``name``."""
        if name not in self._split:
            return t
        return self.mesh.model_slice(t, self._split[name])

    def _whole(self, name, t):
        """The whole tensor of leaf ``name`` from this rank's slice
        ``t`` (collective over the model group)."""
        if name not in self._split:
            return t
        return self.mesh.model_gather(t, self._split[name])

    def _watch_list(self, patterns):
        """The flat parameter names ``logging.watch_tensors`` matches (by
        ``re.search``), sorted; a pattern that matches none is warned
        about."""
        watched = set()
        for pattern in patterns:
            rx = re.compile(pattern)
            hits = [n for n in self._flat if rx.search(n)]
            if not hits:
                warning("logging.watch_tensors pattern %r matched no "
                        "params" % pattern)
            watched.update(hits)
        return sorted(watched)

    def _watch_stats(self, grads):
        """The mean, std (over N), min and max of each watched parameter
        (before this step's update), then of each watched gradient, in
        ``metric_names`` order: one float32 vector on the device."""
        rows = []
        for source in (self._flat, grads):
            for name in self._watched:
                x = self._whole(name, source[name].detach()
                                .to(torch.float32))
                rows.append(torch.stack([x.mean(), x.std(correction=0),
                                         x.min(), x.max()]))
        if not rows:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.stack(rows).reshape(-1)

    def _check_accum_geometry(self):
        """accum_steps splits every feed array into equal micro-batches
        along its leading dim, so the per-item row counts must be uniform:
        refuse a training dataset with variable clips per video under
        batch_item default."""
        if self.settings.train.batch_item == defs.batch_item.clip:
            return
        datasets = self.feeder.datasets
        if isinstance(datasets, dict):
            datasets = datasets.get(defs.phase.train, [])
        for d in datasets:
            cpv = getattr(d, "clips_per_video", None)
            if isinstance(cpv, (list, tuple)) and len(set(cpv)) > 1:
                error("accum_steps > 1 needs uniform batch geometry; "
                      "dataset has variable clips-per-video (%d..%d). "
                      "Use batch_item: defs.batch_item.clip or repack "
                      "with a fixed cpv." % (min(cpv), max(cpv)))

    def _check_accum_feed(self, feed):
        for k, v in feed.items():
            if isinstance(v, torch.Tensor) and v.dim() >= 1 and \
                    v.shape[0] % self._accum:
                error("accum_steps=%d does not divide feed '%s' rows (%d); "
                      "adjust batch_size/accum_steps"
                      % (self._accum, k, v.shape[0]))

    def _build_preprocessors(self):
        pre = {}
        for key, itype, tag in self.model.required_input:
            if itype != defs.net_input.visual:
                continue
            dsets = self.feeder.get_dataset_by_tag(tag)
            if not dsets:
                continue
            d = dsets[0]
            if d.device_preprocess and d.processor is not None:
                if not supports_device_path(d.imgproc, d):
                    error("Device preprocessing unsupported for imgproc %s"
                          % d.imgproc)
                # frames come out in the compute dtype: conv1 takes them
                # as they are
                pre[key] = make_preprocessor(
                    d.processor, out_dtype=self.model.compute_dtype,
                    device=self.device)
        return pre

    # -------------------------------------------------------------- step
    def _forward(self, feed, generators):
        """Preprocess, run the model in training mode, pipeline i's
        dropout drawing from ``generators[i]``; returns (logits, labels,
        mask or None)."""
        feed = dict(feed)
        for key, pre in self._preprocessors.items():
            feed[key] = pre(feed[key], feed.pop(key + "/proc_params"))
        with torch.enable_grad():
            logits = self.model.apply(
                self.params, feed, train=True,
                dropout_generator=generators,
                mesh=self.mesh, **self.conv1)
        return logits, feed["labels"], feed.get("label_mask")

    def _grad(self, loss):
        leaves = list(self._flat.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(self._flat.items(), grads)}

    def _step_mean(self, feed):
        """accum_steps 1: the gradient of the masked mean loss."""
        logits, labels, mask = self._forward(feed, self._dropout_gens[0])
        with torch.enable_grad():
            loss = softmax_cross_entropy(logits, labels, mask)
        grads = self._grad(loss)
        correct = _correct(logits.detach(), labels)
        if mask is None:
            acc = correct.mean()
        else:
            m = mask.to(torch.float32)
            acc = (correct * m).sum() / m.sum().clamp(min=1.0)
        return grads, loss.detach(), acc

    def _step_micro_sums(self, feed):
        """accum_steps > 1: every feed array's leading dim is split into
        equal micro-batches; the gradients of the masked loss sums are
        added up and divided by the total mask count at the end, which
        equals the full-batch masked mean up to float reassociation.  On
        a mesh (with any ``accum_steps``) the sums are added over the
        data group before the division, so the count is the global
        batch's."""
        accum = self._accum
        grads, loss_sum, count, correct = None, 0.0, 0.0, 0.0
        for i in range(accum):
            micro = {k: (v.reshape((accum, v.shape[0] // accum) +
                                   tuple(v.shape[1:]))[i]
                         if v.dim() >= 1 else v) for k, v in feed.items()}
            logits, labels, mask = self._forward(micro,
                                                 self._dropout_gens[i])
            mask = (torch.ones(labels.shape[0], device=labels.device)
                    if mask is None else mask.to(torch.float32))
            with torch.enable_grad():
                logp = torch.log_softmax(logits.to(torch.float32), -1)
                per_row = -(labels.to(torch.float32) * logp).sum(-1)
                s = (per_row * mask).sum()
            g = self._grad(s)
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
            loss_sum = loss_sum + s.detach()
            count = count + mask.sum()
            correct = correct + (_correct(logits.detach(), labels)
                                 * mask).sum()
        if self.mesh.size > 1:
            grads, loss_sum, count, correct = self._data_sum(
                grads, loss_sum, count, correct)
        denom = count.clamp(min=1.0)
        grads = {n: (g.to(torch.float32) / denom).to(g.dtype)
                 for n, g in grads.items()}
        return grads, loss_sum / denom, correct / denom

    def _data_sum(self, grads, loss_sum, count, correct):
        """The gradients, loss sum, mask count and correct count added
        over the data group, in one all-reduce of one flat float32
        buffer."""
        names = list(grads)
        flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                          for n in names] +
                         [torch.stack([loss_sum, count, correct])
                          .to(torch.float32)])
        self.mesh.data_sum(flat)
        out, i = {}, 0
        for n in names:
            g = grads[n]
            out[n] = flat[i:i + g.numel()].reshape(g.shape).to(g.dtype)
            i += g.numel()
        return out, flat[i], flat[i + 1], flat[i + 2]

    # ------------------------------------------------------------- feeds
    def prepare_device_feed(self, feed, batches=None):
        """Move a feed to the device and pad it to the batch geometry
        (the epoch tail's missing rows get ``label_mask`` zeros; a
        caller's mask is kept), then check it against ``accum_steps``.
        Safe to run in a prefetch thread, so the copies overlap the
        previous step; ``run_step`` skips this work for the returned
        feed.  ``batches`` is not read: it is there so that this method
        serves as ``FeedPrefetcher``'s ``prepare_fn``.

        On a CUDA device the copies and the padding run on a side stream
        of this engine, so they overlap the step that runs on the
        caller's stream, and this method returns only once they have
        finished.  Of the two ways to keep the datasets' read-buffer ring
        safe (a CUDA event per slot that the reader waits on before it
        refills the slot, or a copy that is done before the feed is
        handed on) this takes the second: a slot can then be refilled at
        once, no slot carries state between threads, and the wait costs
        the prefetch thread one copy per batch, time that it has while
        the step runs (``chip_smoke.py`` phase 8 times the two).
        ``run_step`` marks each tensor as used on its own stream
        (``record_stream``), so the caching allocator does not hand the
        memory back to the side stream while the step still reads it."""
        feed = {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in feed.items()}
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            if any(v.is_cuda for v in feed.values()):
                # tensors already on the card may still be being written
                # on the caller's stream
                self._copy_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._copy_stream):
                feed = self._pad_on_device(feed)
            self._copy_stream.synchronize()
        else:
            feed = self._pad_on_device(feed)
        if self._accum > 1:
            self._check_accum_feed(feed)
        feed[ON_DEVICE] = True
        return feed

    def _pad_on_device(self, feed):
        feed = {k: v.to(self.device, non_blocking=True)
                for k, v in feed.items()}
        return self._geometry.pad_feed(feed)[0]

    def _seed_dropout(self, seed):
        """Seed micro-batch m's pipeline i generator with
        ``fold_in(fold_in(seed, m), i)`` (``fold_in(seed, i)`` for
        accum_steps 1): the streams of the JAX ``fold_in(rng, i)``
        structure, not its bits."""
        for m, gens in enumerate(self._dropout_gens):
            base = seed if self._accum == 1 else fold_in(seed, m)
            if self.mesh.data > 1:
                # each data rank draws its own rows' masks; the ranks of
                # one model group hold the same rows and draw the same
                base = fold_in(base, self.mesh.data_index)
            for i, gen in enumerate(gens):
                gen.manual_seed(fold_in(base, i))

    def _step_body(self, feed):
        """One optimizer step on a prepared feed, all on the device, with
        no value read back to the host: returns the metrics (loss, lr,
        grad_norm, accuracy, then the watched statistics) as one float32
        vector and advances every state tensor in place."""
        if self._accum > 1 or self.mesh.size > 1:
            grads, loss, acc = self._step_micro_sums(feed)
        else:
            grads, loss, acc = self._step_mean(feed)
        grad_norm = self.tx.norm(grads)
        watched = self._watch_stats(grads)
        updates = self.tx.update(grads, self.opt_state, self._flat)
        with torch.no_grad():
            for n, p in self._flat.items():
                p.add_(updates[n])
            if self.ema is not None:
                d = self._ema_decay
                for n, e in self.ema.items():
                    e.mul_(d).add_(self._flat[n] * (1.0 - d))
            step = self._step_t.clamp(0, len(self.lr_array) - 1).reshape(1)
            lr = self._lr_t.index_select(0, step).reshape(())
            self._step_t.add_(1)
        head = torch.stack([loss.to(torch.float32), lr,
                            grad_norm.to(torch.float32),
                            acc.to(torch.float32)])
        return torch.cat([head, watched])

    def _device_feed(self, feed):
        feed = dict(feed)
        if not feed.pop(ON_DEVICE, False):
            feed = self.prepare_device_feed(feed)
            feed.pop(ON_DEVICE)
        return feed

    def _run(self, kind, body, feed, warmups):
        """``body(feed)``: eagerly with graphs off; else the first
        ``warmups`` calls at this feed geometry eagerly on the capture
        stream (real steps, not redone), the last of them followed by the
        capture, and from then on a copy of the feed into the captured
        buffers and a replay (``graphs.ProgramCache``)."""
        if self.graphs:
            return self.graph_cache.run(kind, body, feed, warmups=warmups)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for v in feed.values():
                v.record_stream(stream)
        return body(feed)

    def run_step(self, feed):
        """One optimizer step on a feed dict ({input key: array or
        tensor}, "labels" one-hot, optional "label_mask" and
        "<key>/proc_params" for device preprocessing), or on a feed from
        ``prepare_device_feed``; returns the metrics loss, lr, grad_norm
        and accuracy (and the watched statistics) as floats, read back
        in one copy."""
        feed = self._device_feed(feed)
        self._seed_dropout(fold_in(self.seed + 1, self.global_step))
        out = self._run(("step",), self._step_body, feed, WARMUP_STEPS)
        self._global_step += 1
        values = out.cpu().numpy()
        return {k: float(v) for k, v in zip(self.metric_names, values)}

    def compile_scan_steps(self, num_steps):
        """``num_steps`` optimizer steps on one feed as one program (JAX
        ``Train.compile_scan_steps``): on the card with graphs on, one
        CUDA graph (the first call at a feed geometry runs the steps
        eagerly and then captures them, later calls replay); on the CPU,
        on a gloo mesh or with graphs off, an eager loop.  Returns
        ``many(feed)`` -> {metric: (num_steps,) float32 array}; each call
        advances ``global_step`` by ``num_steps``, and each step's lr
        metric is the schedule's at its own step.

        Dropout: JAX folds the step index into the call's key for each
        step.  Here the generators are seeded once per call, as
        ``run_step`` seeds them at the call's first step, and each later
        step draws on from where the previous one stopped: inside one
        graph nothing can re-seed them.  So the first step's masks are
        those of ``run_step`` and the later ones are not."""
        num_steps = int(num_steps)
        if num_steps < 1:
            error("compile_scan_steps needs num_steps >= 1, got %d"
                  % num_steps)

        def body(feed):
            return torch.stack([self._step_body(feed)
                                for _ in range(num_steps)])

        def many(feed):
            feed = self._device_feed(feed)
            self._seed_dropout(fold_in(self.seed + 1, self.global_step))
            out = self._run(("scan", num_steps), body, feed, 1)
            self._global_step += num_steps
            values = out.cpu().numpy()
            return {k: values[:, j] for j, k in enumerate(self.metric_names)}

        return many

    # ------------------------------------------------------------ state
    def eval_params(self):
        """Parameters an evaluation should use: the EMA weights when
        ema_decay is on and ``val.use_ema`` asks for them, else the live
        ones (detached from the graph); whole tensors on a mesh
        (collective)."""
        source = self._flat
        if self.ema is not None and self.settings.val is not None and \
                getattr(self.settings.val, "use_ema", False):
            source = self.ema
        return unflatten_tree(sharding.gather_params(
            {n: p.detach() for n, p in source.items()}, self.mesh,
            self._split))

    def state_dict(self):
        """{"params", "opt_state_leaves", "ema_params" (with the EMA),
        "global_step"}: the parameters and the EMA as flat {name: CPU
        tensor} dicts in the port's names and layouts, and the optimizer
        state as the JAX package holds it, the optax leaves in optax's
        order (``opt_state_leaf_list``; the step counts int32, Adam's
        two counts both this tier's count).  Each tensor is a copy, so
        later steps leave a snapshot being written alone.  On a mesh the
        tensors are whole (collective: every rank calls it), as one
        process would hold them."""
        def snap(t, name=None):
            return self._whole(name, t.detach()).to("cpu", copy=True)

        leaves = []
        for tier, slot, name in self._opt_leaves:
            st = self.opt_state[tier]
            if slot == "count":
                leaves.append(st["count"].detach().to("cpu", torch.int32,
                                                      copy=True))
            else:
                leaves.append(snap(st[slot][name], name))
        out = {"params": {n: snap(p, n) for n, p in self._flat.items()},
               "opt_state_leaves": leaves,
               defs.names.global_step: self.global_step}
        if self.ema is not None:
            out["ema_params"] = {n: snap(e, n) for n, e in self.ema.items()}
        return out

    def load_state_dict(self, state, restored_names=None):
        """Restore what ``state_dict`` returned (or a restore of a
        checkpoint into it, a JAX package's included), into this
        engine's tensors.  ``restored_names``: the names
        ``restore_checkpoint`` loaded from the file; when a checkpoint
        was restored and none of them is an ``ema_params`` leaf, the EMA
        starts at the restored params (the JAX
        ``Train.load_state_dict``).  ``opt_state_leaves`` is taken when
        it holds as many leaves as this optimizer, as JAX takes it;
        otherwise the optimizer state is kept (and that is logged).  A
        tier's two Adam counts must agree.  The tensors are whole; on a
        mesh each rank takes its slices."""
        leaves = state.get("opt_state_leaves")
        if leaves is not None and len(leaves) != len(self._opt_leaves):
            info("The state holds %d optimizer leaves, this optimizer %d: "
                 "the optimizer state is kept as it is"
                 % (len(leaves), len(self._opt_leaves)))
            leaves = None
        with torch.no_grad():
            for n, p in self._flat.items():
                p.copy_(self._local(n, state["params"][n]))
            counts = {}
            for (tier, slot, name), v in zip(self._opt_leaves,
                                              leaves or ()):
                st = self.opt_state[tier]
                if slot != "count":
                    st[slot][name].copy_(self._local(name, v))
                    continue
                c = int(v)
                if counts.setdefault(tier, c) != c:
                    error("Optimizer tier %r holds two step counts, %d and "
                          "%d; optax advances both together"
                          % (tier, counts[tier], c))
                st["count"].fill_(c)
            if self.ema is not None:
                source = state.get("ema_params")
                if restored_names and not any(
                        n.startswith("ema_params") for n in restored_names):
                    info("Checkpoint carries no EMA state; seeding the EMA "
                         "at the restored params")
                    source = self._flat
                if source is None:
                    pass
                elif source is self._flat:
                    for n, e in self.ema.items():
                        e.copy_(source[n])
                else:
                    for n, e in self.ema.items():
                        e.copy_(self._local(n, source[n]))
        gs = state.get(defs.names.global_step)
        if gs is not None:
            self.global_step = int(gs)
