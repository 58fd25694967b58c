"""The cells' drivers: set-up, one timed call, and the check that decides
``correct``, for the two kinds of traffic.

``TrainCell`` drives ``Train.run_step`` (graphs on, on the card): set-up
builds one trainer from the seed's weights and runs its first
``CHECK_STEPS`` steps through ``run_step`` on distinct pool batches,
keeping the parameters after each of them; the window runs the same
trainer on.  The first ``WARMUP_STEPS`` of them run eagerly, the rest
are replays of the captured step, as every step of the window is.  The
check runs each of the reference's steps on the same inputs from the
state the program's step started from: the seed's weights for step 1,
the program's own parameters after the step before for the later ones.

``InferCell`` drives ``ServingModule.__call__`` (one bucket of the
traffic's clips, graphs on): every call's logits come back to the host
and are kept with the pool batch they answered; the check compares every
one of them with the reference's answer to that batch.

Nothing here reads the program's own numbers but its outputs: the
metrics ``run_step`` returns (the loss), its parameters, and the
serving call's logits.
"""

import gc
import statistics
import time

import numpy as np
import torch

from lrcn_bench import inputs, weights
from lrcn_bench.reference import lrcn as ref

CHECK_STEPS = 3
# a leaf whose step-1 reference gradient norm is under this share of the
# median leaf's moves by round-off alone; it is left out of the
# comparisons of leaves
ROUNDING_LEAF_SHARE = 1e-3
# float32's relative resolution, against which a leaf's update is sized
# (``TrainCell.numbers``' ``resolution``)
EPS32 = 2.0 ** -23


def sub_seed(seed, k):
    """The seed of the run's k-th stream (weights, frames, host draws,
    trainer, embeddings, reference sample)."""
    return (int(seed) * 1000003 + k) % (1 << 63)


def flatten(tree, prefix=""):
    """{name: tensor} of a nested dict / list tree, names joined by '/'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, prefix + str(k) + "/"))
    return out


def build_program(cfg, traffic):
    """(settings, Model) of the program for this configuration and
    traffic, built through its own configuration entry point."""
    from video_learning_tpu_torch import flagship as fl
    caption = cfg["task"] == "caption"
    imgproc = (fl.TRAIN_IMGPROC if traffic.get("crop") == "random"
               else fl.SERVING_IMGPROC)
    kw = dict(num_classes=cfg["num_classes"], fpc=cfg["frames_per_clip"],
              image=cfg["image"],
              lstm=(cfg["lstm"]["hidden"], cfg["lstm"]["layers"]),
              raw_hw=tuple(cfg["raw_hw"]), mean_scalars=tuple(cfg["mean_bgr"]),
              imgproc=imgproc, batch_size=traffic["items"],
              compute_dtype=cfg["compute_dtype"], num_batches=1000,
              base_lr=cfg["train"]["base_lr"], lr_mult=None,
              clip_norm=cfg["train"]["clip_norm"],
              optimizer=cfg["train"]["optimizer"])
    if caption:
        cap = cfg["caption"]
        kw.update(caption=True, emb_dim=cap["embedding_dim"],
                  max_T=cap["max_T"])
    settings, model = fl.flagship(**kw)
    settings.train.dropout_keep_prob = cfg["train"]["dropout_keep_prob"]
    if caption:
        vocab = model.caption_dataset.vocabulary
        if (vocab.index("EOS"), vocab.index("BOS")) != (cap["eos_index"],
                                                        cap["bos_index"]):
            raise ValueError("the program's EOS / BOS ids differ from %s's"
                             % cfg["name"])
    return settings, model


def _meta_leaves(model):
    return flatten(model.init_params(0, device="meta"))


def _unflatten(flat):
    from video_learning_tpu_torch.checkpoint import unflatten_tree
    return unflatten_tree(flat)


def _leaf_gaps(prog, ref_t, kept):
    """{leaf: |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖)} over the leaves ``kept``."""
    pn = {n: float(prog[n].double().norm()) for n in kept}
    rn = {n: float(ref_t[n].double().norm()) for n in kept}
    med = statistics.median(rn.values())
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in kept}


def _release():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _cpu(flat):
    return {n: t.detach().to("cpu", copy=True) for n, t in flat.items()}


class _Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seed = seed
        self.items = traffic["items"]
        self.calls = 0
        self.read = None
        # set-up's phases: {name: seconds since the previous mark}
        self.started = self._t = time.monotonic()
        self.phases = {}

    def _mark(self, name):
        now = time.monotonic()
        self.phases[name] = now - self._t
        self._t = now

    def check(self):
        """Every number the check can compare ({name: value}), kept as
        ``self.read``; the cell's limits file picks those compared."""
        self.read = self._numbers()
        return self.read

    def _weights(self, model):
        self.p0 = weights.make(self.cfg, _meta_leaves(model),
                               sub_seed(self.seed, 0), self.device)

    def _traffic(self, embedding=None):
        self.data = inputs.Traffic(self.cfg, self.traffic,
                                   (sub_seed(self.seed, 1),
                                    sub_seed(self.seed, 2)),
                                   self.device, embedding=embedding)


class TrainCell(_Cell):
    """The training step (``Train.run_step``)."""

    def setup(self):
        from video_learning_tpu_torch.train import Train
        cfg = self.cfg
        settings, model = build_program(cfg, self.traffic)
        self._mark("program")
        self._weights(model)
        emb = None
        if cfg["task"] == "caption":
            emb = weights.embedding(cfg, sub_seed(self.seed, 4), self.device)
            model.caption_dataset.embedding_matrix = emb.cpu().numpy()
        self._mark("weights")
        self.train_seed = sub_seed(self.seed, 3)
        self.dropout_pipeline = [s["name"] for s in model.specs].index(
            cfg["param_prefix"]["head"].rstrip("/"))
        self.engine = Train(settings, settings.feeder, model,
                            seed=self.train_seed,
                            params=_unflatten(self.p0), device=self.device)
        self._mark("trainer")
        self._traffic(emb)
        self._mark("inputs")
        self.crops, self.losses, self.p_after = [], [], []
        for step in range(CHECK_STEPS):
            crops = self.data.draw_crops()
            self.crops.append(crops)
            self.losses.append(self._step(step, crops)["loss"])
            self._mark("step%d" % (step + 1))
            self.p_after.append(_cpu(flatten(self.engine.params)))
            self._mark("keep%d" % (step + 1))
        self.next = CHECK_STEPS

    def _step(self, k, crops):
        return self.engine.run_step(
            self.data.train_feed(k % len(self.data.frames), crops))

    def call(self):
        self._step(self.next, self.data.draw_crops())
        self.next += 1
        self.calls += 1

    def release(self):
        del self.engine
        _release()

    def reference_batches(self):
        """The check steps' inputs as the reference takes them."""
        cfg, out = self.cfg, []
        caption = cfg["task"] == "caption"
        keep_p = cfg["train"]["dropout_keep_prob"]
        H = cfg["lstm"]["hidden"]
        rows = self.items * (cfg["caption"]["max_T"] if caption else 1)
        for step, crops in enumerate(self.crops):
            k = step % len(self.data.frames)
            lab = self.data.batches[k]
            batch = {"frames": self.data.frames[k],
                     "crops": crops.to(self.device),
                     "mirror": self.traffic.get("mirror") == "random",
                     "labels": lab["labels"],
                     "keep": ref.dropout_keep(self.train_seed, step,
                                              self.dropout_pipeline,
                                              (rows, H), keep_p,
                                              self.device)}
            if caption:
                batch.update(words=lab["caption_words"],
                             lengths=lab["caption_lengths"].long(),
                             label_mask=lab["label_mask"])
            out.append(batch)
        return out

    def reference_step(self, k, start, rnd=ref.identity):
        """(loss, clipped gradients) of the reference's check step ``k``
        (0-based), one step from ``start`` ({name: tensor}) on that
        step's inputs."""
        start = {n: t.to(self.device) for n, t in start.items()}
        with ref.exact_float32():
            losses, clipped, _ = ref.train_steps(
                start, self.cfg, [self.reference_batches()[k]],
                self.traffic["ref_block_items"], rnd=rnd)
        return losses[0], clipped[0]

    def starts(self):
        """The state before each check step: the seed's weights, then the
        program's own parameters after each step."""
        return [self.p0] + list(self.p_after[:-1])

    def reference(self, starts):
        """(losses, clipped gradients) of the reference's check steps,
        step k from ``starts[k]``."""
        out = [self.reference_step(k, s) for k, s in enumerate(starts)]
        return [l for l, _ in out], [c for _, c in out]

    def numbers(self, losses, p_after, starts, ref_out):
        """What the check can compare of a trainer's readings (the check
        steps' losses and the params after each step) against the
        reference's steps from the same states (``starts``).
        ``loss_gap``: the widest relative gap of a step's loss
        (``loss1_gap`` step 1's).  Of the gradient as the optimizer got
        it, (params before - after) / lr, the gap of norms of the worst
        leaf and of the median leaf (``*_median``): at step 1
        (``grad1_gap``) and the widest over the steps (``grad_gap``; the
        last step is the first replay of the captured step).  Leaves
        whose step-1 reference gradient is under ``ROUNDING_LEAF_SHARE``
        of the median leaf's are left out.  ``self.detail`` names each
        step's worst leaf and sizes its update against float32's
        resolution of its values: the RMS update over the RMS of EPS32 *
        |value|."""
        r_losses, r_clipped = ref_out
        lr = self.cfg["train"]["base_lr"]
        before = [_cpu(s) for s in starts]
        g_ref = [_cpu(c) for c in r_clipped]
        norms = {n: float(g.double().norm()) for n, g in g_ref[0].items()}
        med = statistics.median(norms.values())
        kept = [n for n in norms if norms[n] >= ROUNDING_LEAF_SHARE * med]
        steps = [_leaf_gaps({n: (before[k][n] - p_after[k][n]) / lr
                             for n in kept}, g_ref[k], kept)
                 for k in range(len(p_after))]

        def resolution(k, n):
            ulp = float((EPS32 * before[k][n].double().abs()).norm())
            return float((lr * g_ref[k][n]).double().norm()) / max(ulp,
                                                                    1e-300)

        worst = [max(g, key=g.get) for g in steps]
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        self.detail = {
            "losses": losses, "reference_losses": r_losses,
            "leaves_left_out": sorted(set(norms) - set(kept)),
            "step_gaps": [[max(g.values()), statistics.median(g.values())]
                          for g in steps],
            "worst": worst,
            "resolution": [resolution(k, n) for k, n in enumerate(worst)],
            "least_resolution": min(resolution(0, n) for n in kept)}
        return {"loss_gap": max(loss), "loss1_gap": loss[0],
                "grad1_gap": max(steps[0].values()),
                "grad1_gap_median": statistics.median(steps[0].values()),
                "grad_gap": max(max(g.values()) for g in steps),
                "grad_gap_median": max(statistics.median(g.values())
                                       for g in steps)}

    def _numbers(self):
        starts = self.starts()
        return self.numbers(self.losses, self.p_after, starts,
                            self.reference(starts))

    def compared_items(self):
        return CHECK_STEPS * self.items


class InferCell(_Cell):
    """The serving call (``ServingModule.__call__``)."""

    def setup(self, quantize=None):
        from video_learning_tpu_torch.serving import ServingModule
        cfg = self.cfg
        settings, model = build_program(cfg, self.traffic)
        if cfg["task"] != "classify":
            raise ValueError("an inference cell serves a clip classifier")
        self._mark("program")
        self._weights(model)
        self._mark("weights")
        self.module = ServingModule(model, _unflatten(self.p0),
                                    batch_items=[self.items],
                                    device=self.device, quantize=quantize)
        self._mark("module")
        self.module.warmup()
        self._mark("warmup")
        self._traffic()
        self._mark("inputs")
        for k in range(2):
            self.module(*self.data.infer_args(k))
        self._mark("calls")
        self.outputs = []

    def call(self):
        k = self.calls % len(self.data.frames)
        self.outputs.append((k, self.module(*self.data.infer_args(k))))
        self.calls += 1

    def release(self):
        del self.module
        _release()

    def _reference_inputs(self, k):
        cfg = self.cfg
        return ref.preprocess(self.data.frames[k], self.data.center,
                              cfg["mean_bgr"], (cfg["image"], cfg["image"]),
                              False)

    def _reference_logits(self, k):
        cfg, block = self.cfg, self.traffic["ref_block_items"]
        fpc = cfg["frames_per_clip"]
        x = self._reference_inputs(k)
        with ref.exact_float32(), torch.no_grad():
            return torch.cat([ref.classify(self.p0, cfg,
                                           x[i * fpc:(i + block) * fpc])
                              for i in range(0, self.items, block)]).cpu()

    def _numbers(self):
        """What the check can compare of every call's logits against the
        reference's for the same pool batch: ``logit_gap``, the widest
        gap of a logit over the largest reference logit; ``row_gap``,
        the widest row's relative L2 gap (``row_gap_median`` the median
        row's); ``rms_gap``, the RMS gap of all logits over the
        reference's RMS."""
        by_k = {}
        for k, out in self.outputs:
            by_k.setdefault(k, []).append(out)
        gaps, rel, sq, ref_sq = [], [], 0.0, 0.0
        for k, outs in sorted(by_k.items()):
            want = self._reference_logits(k).numpy()
            scale = float(np.abs(want).max())
            for out in outs:
                gaps.extend(np.abs(out - want).max(1) / scale)
                rel.extend(np.linalg.norm(out - want, axis=1) /
                           np.linalg.norm(want, axis=1))
                sq += float(((out - want) ** 2).sum())
                ref_sq += float((want ** 2).sum())
        return {"logit_gap": float(max(gaps)), "row_gap": float(max(rel)),
                "row_gap_median": float(np.median(rel)),
                "rms_gap": (sq / ref_sq) ** 0.5}

    def compared_items(self):
        return len(self.outputs) * self.items


CELLS = {"train": TrainCell, "infer": InferCell}
