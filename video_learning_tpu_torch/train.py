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
As in JAX, every feed is padded to the run's ``BatchGeometry`` (the epoch
tail gets ``label_mask`` zeros) and moved to the device by
``prepare_device_feed``, which a ``FeedPrefetcher`` runs in its thread;
``run_step`` skips that work for a feed so prepared.  Not ported: the
mesh and sharding code, ``compile_scan_steps`` and ``watch_tensors``.
Dropout draws from torch generators seeded with
``fold_in(seed + 1, global_step)``: the same structure of streams as the
JAX ``fold_in``, not the same bits.
"""

import math
import os

import numpy as np
import torch

from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.ops.preprocess import (make_preprocessor,
                                                     supports_device_path)
from video_learning_tpu_torch.utils import (error, fold_in, info,
                                            resolve_device)

# the key prepare_device_feed adds to a feed it has padded and moved
ON_DEVICE = "__on_device__"

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

    if settings.run_folder:
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
def global_norm(tensors):
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    summed tensor by tensor in order."""
    total = 0.0
    for t in tensors:
        total = total + t.to(torch.float32).square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


class _Tier:
    """One base optimizer (``optax.sgd`` / ``adam`` / ``rmsprop`` /
    ``adamw``) over a subset of the parameters, with its own step count.
    ``update`` returns the additive updates and advances the state."""

    def __init__(self, kind, lr_array, mult, weight_decay):
        if kind not in (defs.optim.sgd, defs.optim.adam, defs.optim.rmsprop,
                        defs.optim.adamw):
            error("Undefined optimizer %s" % kind)
        self.kind = kind
        self.lr_array = np.asarray(lr_array, np.float32)
        self.mult = mult
        self.weight_decay = float(weight_decay)

    def lr(self, count):
        lr = self.lr_array[min(max(count, 0), len(self.lr_array) - 1)]
        if self.mult is not None:
            lr = lr * np.float32(self.mult)
        return float(np.float32(lr))

    def init(self, params):
        state = {"count": 0}
        if self.kind in (defs.optim.adam, defs.optim.adamw):
            state["mu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind != defs.optim.sgd:
            state["nu"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def update(self, grads, state, params):
        count = state["count"]
        step_size = -self.lr(count)
        out = {}
        for n, g in grads.items():
            if self.kind == defs.optim.sgd:
                u = g
            elif self.kind == defs.optim.rmsprop:
                nu = (1 - RMS_DECAY) * g.square() + RMS_DECAY * state["nu"][n]
                state["nu"][n] = nu
                u = torch.rsqrt(nu + RMS_EPS) * g
            else:
                mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"][n]
                nu = (1 - ADAM_B2) * g.square() + ADAM_B2 * state["nu"][n]
                state["mu"][n], state["nu"][n] = mu, nu
                c = np.float32(count + 1)
                bc1 = float(np.float32(1) - np.power(np.float32(ADAM_B1), c))
                bc2 = float(np.float32(1) - np.power(np.float32(ADAM_B2), c))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
                if self.kind == defs.optim.adamw and params[n].dim() > 1:
                    u = u + self.weight_decay * params[n]
            out[n] = step_size * u
        state["count"] = count + 1
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
        if labels is None:
            self.tiers = {"regular": _Tier(train.optimizer, lr_array, None,
                                           wd)}
        else:
            self.tiers = {"regular": _Tier(train.optimizer, lr_array, None,
                                           wd),
                          "modified": _Tier(train.optimizer, lr_array,
                                            train.lr_mult, wd)}

    def _split(self, tree):
        if self.labels is None:
            return {"regular": tree}
        out = {tier: {} for tier in self.tiers}
        for n, v in tree.items():
            out[self.labels[n]][n] = v
        return out

    def init(self, params):
        parts = self._split(params)
        return {tier: t.init(parts[tier]) for tier, t in self.tiers.items()}

    def update(self, grads, state, params):
        """Updates to add to the parameters; ``state`` advances in
        place."""
        if self.clip_norm is not None:
            g_norm = global_norm(grads.values())
            if not bool(g_norm < self.clip_norm):
                grads = {n: (g / g_norm) * self.clip_norm
                         for n, g in grads.items()}
        if self.clip_per_tensor is not None:
            clipped = {}
            for n, g in grads.items():
                norm = torch.sqrt(g.square().sum())
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
    GPU; pass ``device="cpu"`` to train on the CPU.  ``conv1_dw`` picks
    the stem conv's weight-gradient kernel ("shifted" or "blocked")."""

    def __init__(self, settings, feeder, model, seed=0, params=None,
                 device="cuda", conv1_dw="shifted"):
        if not settings.train:
            error("Train needs settings.train")
        self.device = resolve_device(device)
        self.settings = settings
        self.model = model
        self.feeder = feeder
        self.conv1_dw = conv1_dw
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
        # float32 leaves that require gradients, in name order; the nested
        # tree the model reads holds the same tensors
        self._flat = {n: flat[n].detach().to(self.device, torch.float32)
                      .clone().requires_grad_(True) for n in sorted(flat)}
        self.params = unflatten_tree(self._flat)
        _, modified = model.param_groups()
        self.tx = make_optimizer(settings, self.lr_array,
                                 make_label_tree(self._flat, modified))
        self.opt_state = self.tx.init(self._flat)
        self._ema_decay = float(getattr(settings.train, "ema_decay", 0.0)
                                or 0.0)
        self.ema = ({n: p.detach().clone() for n, p in self._flat.items()}
                    if self._ema_decay else None)
        self.seed = int(seed)
        self.global_step = int(settings.global_step)
        self._preprocessors = self._build_preprocessors()

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
    def _forward(self, feed, seed):
        """Preprocess, run the model in training mode; returns (logits,
        labels, mask or None)."""
        feed = dict(feed)
        for key, pre in self._preprocessors.items():
            feed[key] = pre(feed[key], feed.pop(key + "/proc_params"))
        with torch.enable_grad():
            logits = self.model.apply(
                self.params, feed, train=True,
                dropout_generator=torch.Generator().manual_seed(seed),
                conv1_dw=self.conv1_dw)
        return logits, feed["labels"], feed.get("label_mask")

    def _grad(self, loss):
        leaves = list(self._flat.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(self._flat.items(), grads)}

    def _step_mean(self, feed, seed):
        """accum_steps 1: the gradient of the masked mean loss."""
        logits, labels, mask = self._forward(feed, seed)
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

    def _step_micro_sums(self, feed, seed):
        """accum_steps > 1: every feed array's leading dim is split into
        equal micro-batches; the gradients of the masked loss sums are
        added up and divided by the total mask count at the end, which
        equals the full-batch masked mean up to float reassociation."""
        accum = self._accum
        grads, loss_sum, count, correct = None, 0.0, 0.0, 0.0
        for i in range(accum):
            micro = {k: (v.reshape((accum, v.shape[0] // accum) +
                                   tuple(v.shape[1:]))[i]
                         if v.dim() >= 1 else v) for k, v in feed.items()}
            logits, labels, mask = self._forward(micro, fold_in(seed, i))
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
        denom = count.clamp(min=1.0)
        grads = {n: (g.to(torch.float32) / denom).to(g.dtype)
                 for n, g in grads.items()}
        return grads, loss_sum / denom, correct / denom

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

    def run_step(self, feed):
        """One optimizer step on a feed dict ({input key: array or
        tensor}, "labels" one-hot, optional "label_mask" and
        "<key>/proc_params" for device preprocessing), or on a feed from
        ``prepare_device_feed``; returns the metrics loss, lr, grad_norm
        and accuracy as floats."""
        feed = dict(feed)
        if not feed.pop(ON_DEVICE, False):
            feed = self.prepare_device_feed(feed)
            feed.pop(ON_DEVICE)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for v in feed.values():
                v.record_stream(stream)
        seed = fold_in(self.seed + 1, self.global_step)
        if self._accum > 1:
            grads, loss, acc = self._step_micro_sums(feed, seed)
        else:
            grads, loss, acc = self._step_mean(feed, seed)
        grad_norm = global_norm(grads.values())
        updates = self.tx.update(grads, self.opt_state, self._flat)
        with torch.no_grad():
            for n, p in self._flat.items():
                p.add_(updates[n])
            if self.ema is not None:
                d = self._ema_decay
                for n, e in self.ema.items():
                    e.mul_(d).add_(self._flat[n] * (1.0 - d))
        step = min(max(self.global_step, 0), len(self.lr_array) - 1)
        self.global_step += 1
        return {"loss": float(loss), "lr": float(self.lr_array[step]),
                "grad_norm": float(grad_norm), "accuracy": float(acc)}

    # ------------------------------------------------------------ state
    def eval_params(self):
        """Parameters an evaluation should use: the EMA weights when
        ema_decay is on and ``val.use_ema`` asks for them, else the live
        ones (detached from the graph)."""
        source = self._flat
        if self.ema is not None and self.settings.val is not None and \
                getattr(self.settings.val, "use_ema", False):
            source = self.ema
        return unflatten_tree({n: p.detach() for n, p in source.items()})

    def state_dict(self):
        """{"params", "opt_state", "ema_params" (with the EMA),
        "global_step"}: flat {name: CPU tensor} dicts in the port's
        names and layouts (optimizer slots as "<tier>/<slot>/<param>")."""
        opt = {}
        for tier, st in self.opt_state.items():
            opt[tier + "/count"] = torch.tensor(st["count"])
            for slot in ("mu", "nu"):
                for n, t in st.get(slot, {}).items():
                    opt["%s/%s/%s" % (tier, slot, n)] = t.detach().cpu()
        out = {"params": {n: p.detach().cpu() for n, p in self._flat.items()},
               "opt_state": opt, defs.names.global_step: self.global_step}
        if self.ema is not None:
            out["ema_params"] = {n: e.cpu() for n, e in self.ema.items()}
        return out

    def load_state_dict(self, state):
        """Restore what ``state_dict`` returned, into this engine's
        tensors (on its device)."""
        with torch.no_grad():
            for n, p in self._flat.items():
                p.copy_(state["params"][n])
            for tier, st in self.opt_state.items():
                st["count"] = int(state["opt_state"][tier + "/count"])
                for slot in ("mu", "nu"):
                    for n, t in st.get(slot, {}).items():
                        t.copy_(state["opt_state"]["%s/%s/%s"
                                                   % (tier, slot, n)])
            if self.ema is not None:
                saved = state.get("ema_params")
                for n, e in self.ema.items():
                    e.copy_(saved[n] if saved is not None else self._flat[n])
        self.global_step = int(state[defs.names.global_step])
