"""Run driver: the train and val phases of a run config.

Counterpart of ``video_learning_tpu/run_task.py``: ``Settings`` -> ``Feeder``
-> ``Model`` -> ``Train`` or ``Validation`` -> checkpoint restore ->
``do_train`` or ``do_test``.  Training runs the epochs through a
``FeedPrefetcher`` (caption framing, padding and the copy to the device
in its thread), logs loss, lr and nats per step and streams them with
``clips_per_sec`` (from the second step on) and any ``watch_tensors``
statistics to the metrics JSONL, tracks the minimum loss, saves every
``save_interval`` batches and out of turn at the end, saves and stops on
SIGTERM (resume with ``resume_file: latest``), and with
``eval_every_epochs`` evaluates inline (``eval_state.json``,
``early_stop_patience``, ``eval_keep_best`` -> ``best.ckpt``).
Validation fuses and accumulates the logits and writes
``accuracy_<run_id>`` and ``accuracy_top<k>_<run_id>``, or for a
captioner decodes, writes ``coco.results.json`` and scores it.

On a mesh the ranks share the run folder: started by
``python -m torch.distributed.run --nproc-per-node N -m
video_learning_tpu_torch.run_task config.json`` (the config's
``mesh_shape`` arranges them; without one they all go on the data axis)
each rank trains on its host shard of the training data and evaluates
the whole validation set, and only global rank 0 writes the checkpoints,
``eval_state.json``, the metrics JSONL, the chunk files and the accuracy
files.  Every rank stops and saves together on a SIGTERM that reached
any of them (the save gathers the sharded tensors, a collective), and
none leaves before rank 0's last write has landed.

Usage: python -m video_learning_tpu_torch.run_task config.{json,yml}
[--device cpu] [--backend gloo]   (runs on the GPU by default, one card
per rank over NCCL; YAML needs PyYAML)
"""

import argparse
import json
import math
import os
import signal
import time

import numpy as np
import torch

from video_learning_tpu_torch import checkpoint as ckpt_mod
from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.config import Settings
from video_learning_tpu_torch.data import captions as captions_mod
from video_learning_tpu_torch.data.feeder import count_clips, prepare_feed
from video_learning_tpu_torch.data.prefetch import FeedPrefetcher
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.observe import MetricsWriter, StepProfiler
from video_learning_tpu_torch.parallel.mesh import init_distributed, is_primary
from video_learning_tpu_torch.train import Train
from video_learning_tpu_torch.utils import elapsed_str, error, info
from video_learning_tpu_torch.val import Validation


def print_iter_info(settings, feeder, num_data, num_labels, padding,
                    batch_index=None):
    dataset = feeder.datasets[settings.phase][0]
    if batch_index is None:
        batch_index = dataset.batch_index
    padinfo = " (%d padding)" % padding if padding > 0 else ""
    epoch_str = "" if settings.phase == defs.phase.val else \
        "epoch: %2d/%2d," % (settings.train.epoch_index + 1,
                             settings.train.epochs)
    info("Mode: [%s], %s batch %4d / %4d : %s data%s, %s labels"
         % (settings.phase, epoch_str, batch_index,
            len(dataset.batches), str(num_data), padinfo, str(num_labels)))


def _host_tensors(feed):
    """A host feed's arrays as CPU tensors (``BatchGeometry`` pads
    tensors)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in feed.items()}


def _install_preempt_handler():
    """Record SIGTERM (a scheduler's notice before it reclaims the
    machine) instead of dying mid-step, so the train loop can save a
    resumable checkpoint and stop.  Returns (flag, restore_fn); nothing
    is installed off the main thread."""
    flag = {"sig": None}

    def handler(signum, frame):
        flag["sig"] = signum

    try:
        prev = signal.signal(signal.SIGTERM, handler)
    except ValueError:          # not the main thread
        return flag, lambda: None
    return flag, lambda: signal.signal(signal.SIGTERM, prev)


def _make_inline_validation(settings, feeder, model, device):
    """The Validation of the inline eval (``eval_every_epochs``): logits
    stay in memory (no chunk files), preprocessors from the val
    datasets."""
    old_interval = settings.val.logits_save_interval
    settings.val.logits_save_interval = None
    feeder.set_phase(defs.phase.val)
    try:
        return Validation(settings, model, device=device)
    finally:
        feeder.set_phase(defs.phase.train)
        settings.val.logits_save_interval = old_interval


def run_inline_eval(settings, val, params, feeder, model):
    """One pass over the val datasets with ``params``; returns top-1.
    The train datasets' positions are untouched, and the loop body is
    do_test's ``run_val_batch``."""
    val.reset_accumulation()
    feeder.set_phase(defs.phase.val)
    try:
        feeder.rewind_datasets(next_epoch=False)
        geometry = BatchGeometry()
        while feeder.loop():
            feed, batches = feeder.get_feed(model.required_input)
            feed = _host_tensors(prepare_feed(feed, batches))
            feed, _, padding = geometry.pad_feed(feed)
            run_val_batch(settings, val, params, model, feed, batches,
                          padding, [])
        return val.get_accuracy()
    finally:
        val.release_params()
        feeder.set_phase(defs.phase.train)


def _eval_state_path(settings):
    return os.path.join(settings.run_folder, "checkpoints",
                        "eval_state.json")


def _load_eval_state(settings):
    """(best_acc, stale_evals) of a resumed run, so that a resume keeps
    best.ckpt and the early-stop count."""
    try:
        with open(_eval_state_path(settings)) as f:
            d = json.load(f)
        return float(d["best_acc"]), int(d["stale_evals"])
    except (OSError, ValueError, KeyError):
        return -1.0, 0


def _save_eval_state(settings, best_acc, stale_evals):
    if not is_primary():        # shared run folder: one writer
        return
    path = _eval_state_path(settings)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"best_acc": best_acc, "stale_evals": stale_evals}, f)
    os.replace(tmp, path)


def _progress(settings, batch, step, suffix=""):
    return "ep_%d_btch_%d_gs_%d%s" % (1 + settings.train.epoch_index, batch,
                                      step, suffix)


def _any_rank(engine, flag):
    """Whether ``flag`` holds on any rank of the engine's mesh (an
    all-reduce; the flag itself off a mesh)."""
    if engine.mesh.size == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=engine.device)
    return bool(engine.mesh.world_max(t).item() > 0)


def do_train(settings, engine, feeder, model, writer):
    """The epoch and batch loop, with a prefetcher that prepares the next
    batches on the device while a step runs."""
    required_input = model.required_input
    run_batch_count = 0
    min_train_loss = (1e9, -1)
    eval_every = int(settings.train.eval_every_epochs or 0)
    patience = int(settings.train.early_stop_patience or 0)
    inline_val = None
    best_acc, stale_evals = -1.0, 0
    if eval_every and settings.should_resume():
        best_acc, stale_evals = _load_eval_state(settings)
    preempt, restore_handler = _install_preempt_handler()
    preempted = False
    step_tic = None     # end-to-end clock of clips_per_sec
    fpc_by_tag = {d.tag: d.num_frames_per_clip
                  for d in feeder.get_datasets()}
    profiler = None
    if settings.profile_steps:
        profiler = StepProfiler(os.path.join(settings.run_folder, "profile"),
                                settings.profile_steps[0],
                                settings.profile_steps[1])
    info("Starting train")

    def prepare(feed, batches):
        # in the prefetch thread: caption framing, padding, the copy
        return engine.prepare_device_feed(prepare_feed(feed, batches))

    try:
        for _ in range(settings.train.epoch_index, settings.train.epochs):
            epoch_start_count = run_batch_count
            for feed, batches, batch_index in FeedPrefetcher(
                    feeder, required_input, prepare):
                num_data = [b.visual.shape[0] for b in batches.values()]
                # the prefetch thread's cursor is ahead: log this batch's
                print_iter_info(settings, feeder, num_data,
                                len(feed["labels"]), 0,
                                batch_index=batch_index + 1)
                run_batch_count += 1
                if profiler:
                    profiler.maybe_start(engine.global_step)
                metrics = engine.run_step(feed)
                settings.global_step = engine.global_step
                if profiler:
                    profiler.maybe_stop(engine.global_step)
                # wall time between completed steps (host input, copy and
                # step, overlap included); the first step has none
                now = time.monotonic()
                if step_tic is not None:
                    metrics["clips_per_sec"] = round(
                        count_clips(batches, fpc_by_tag)
                        / max(now - step_tic, 1e-9), 2)
                step_tic = now
                if metrics["loss"] < min_train_loss[0]:
                    min_train_loss = (metrics["loss"], engine.global_step)
                nats = metrics["loss"] / math.log(settings.num_classes)
                info("Learning rate %2.8f, global step: %d, batch "
                     "loss/nats : %2.5f / %2.3f%s"
                     % (metrics["lr"], engine.global_step,
                        metrics["loss"], nats,
                        (", clips/s: %2.1f" % metrics["clips_per_sec"])
                        if "clips_per_sec" in metrics else ""))
                writer.write(engine.global_step, **metrics)
                saved_this_batch = feeder.should_save(run_batch_count)
                if saved_this_batch:
                    feeder.save(engine.state_dict(),
                                _progress(settings, batch_index + 1,
                                          engine.global_step),
                                engine.global_step,
                                batch_index=batch_index + 1)
                    # a save is not training throughput
                    step_tic = time.monotonic()
                if _any_rank(engine, preempt["sig"] is not None):
                    info("Caught signal %s (preemption): saving "
                         "checkpoint and stopping after %d batches this "
                         "epoch." % (preempt["sig"] or "on another rank",
                                     batch_index + 1))
                    if saved_this_batch:
                        info("Position already checkpointed by the "
                             "periodic save this batch; skipping the "
                             "duplicate.")
                    else:
                        feeder.save(engine.state_dict(),
                                    _progress(settings, batch_index + 1,
                                              engine.global_step,
                                              "_preempt"),
                                    engine.global_step,
                                    batch_index=batch_index + 1)
                    preempted = True
                    break
            if preempted:
                # the .snap holds the position; the epoch is not done
                break
            if run_batch_count > 0:
                info("Epoch [%d] training run complete."
                     % (1 + settings.train.epoch_index))
            else:
                info("Resumed epoch [%d] is already complete."
                     % (1 + settings.train.epoch_index))
            settings.train.epoch_index += 1
            feeder.rewind_datasets()
            if eval_every and run_batch_count > epoch_start_count and \
                    settings.train.epoch_index % eval_every == 0:
                if inline_val is None:
                    inline_val = _make_inline_validation(
                        settings, feeder, model, engine.device)
                acc = run_inline_eval(settings, inline_val,
                                      engine.eval_params(), feeder, model)
                step_tic = None   # an eval is not training throughput
                info("Inline validation after epoch %d: accuracy %2.5f"
                     % (settings.train.epoch_index, acc))
                writer.write(engine.global_step, val_accuracy=acc)
                if acc > best_acc:
                    best_acc, stale_evals = acc, 0
                    if settings.train.eval_keep_best:
                        # the position is the next epoch's start; resume
                        # it with resume_file: best
                        feeder.save(engine.state_dict(), "best",
                                    engine.global_step, batch_index=0,
                                    fixed_name="best")
                else:
                    stale_evals += 1
                _save_eval_state(settings, best_acc, stale_evals)
                if patience and stale_evals >= patience:
                    info("Early stop: val accuracy has not improved "
                         "over %2.5f for %d evals." % (best_acc,
                                                       stale_evals))
                    break
        info("Minimum training loss: %2.5f at global step %d"
             % min_train_loss)
        if run_batch_count > 0 and not preempted and \
                not feeder.should_save(run_batch_count):
            info("Saving model checkpoint out of turn (training "
                 "finished).")
            feeder.save(engine.state_dict(),
                        _progress(settings, feeder.get_num_batches(),
                                  settings.global_step),
                        settings.global_step)
    finally:
        # join an async write (and raise its error) even when the loop
        # raised, so no checkpoint logged as saved is left half-written
        try:
            feeder.finish_saves()
            engine.mesh.barrier()
        finally:
            restore_handler()
    if preempted:
        info("Training preempted — resume with resume_file: latest to "
             "continue from the saved position.")


def run_val_batch(settings, val, params, model, feed, batches, padding,
                  caption_rows):
    """Forward and accumulate one padded validation batch; a captioner's
    decoded rows (one per real item, EOS-trimmed) go to
    ``caption_rows``."""
    if model.caption_dataset is not None:
        main = batches[defs.dataset_tag.main]
        real_items = len(main.caption["caption_lengths"])
        idx_rows = val.run_forward(params, feed, decode=True)
        dset = model.caption_dataset
        for row in idx_rows[:real_items]:
            caption_rows.append(captions_mod.trim_at_eos(
                row, dset.vocabulary, dset.max_caption_length))
    else:
        logits = val.run_forward(params, feed)
        val.process_validation_logits(
            defs.dataset_tag.main, settings, logits,
            np.asarray(feed["labels"]), padding)
        val.save_validation_logits_chunk()


def do_test(settings, val, params, feeder, model, writer):
    """The validation loop; returns top-1 (None for a captioner)."""
    tic = time.time()
    geometry = BatchGeometry()
    caption_rows = []
    top_ks = list(settings.val.top_k or [])
    for k in top_ks:
        # before the loop, not after an hours-long pass
        if k >= settings.num_classes:
            error("val: top_k=%d needs more than %d classes"
                  % (k, settings.num_classes))
    while feeder.loop():
        feed, batches = feeder.get_feed(model.required_input)
        feed = _host_tensors(prepare_feed(feed, batches))
        feed, n_valid, padding = geometry.pad_feed(feed)
        num_data = [b.visual.shape[0] for b in batches.values()]
        print_iter_info(settings, feeder, num_data, n_valid, padding)
        run_val_batch(settings, val, params, model, feed, batches,
                      padding, caption_rows)
    accuracy = None
    if model.caption_dataset is not None:
        val.process_description(settings, caption_rows)
    else:
        val.save_validation_logits_chunk(save_all=True)
        accs = val.get_accuracies([1] + top_ks)
        accuracy = accs[1]
        info("Validation run complete in [%s], accuracy: %2.5f"
             % (elapsed_str(tic), accuracy))
        for k in top_ks:
            info("Top-%d accuracy: %2.5f" % (k, accs[k]))
        if val.validation_logits_save_interval is not None and \
                is_primary():       # shared run folder: one writer
            with open(os.path.join(settings.run_folder,
                                   "accuracy_" + settings.run_id),
                      "w") as f:
                f.write(str(accuracy))
            for k in top_ks:
                with open(os.path.join(
                        settings.run_folder,
                        "accuracy_top%d_%s" % (k, settings.run_id)),
                          "w") as f:
                    f.write(str(accs[k]))
    writer.flush()
    return accuracy


def main(init_file, device="cuda", backend=None):
    """Run the phase of the run config ``init_file`` on ``device``; a
    rank started by ``torch.distributed.run`` first joins its group
    (``parallel.mesh.init_distributed(device, backend)``)."""
    device = init_distributed(device, backend)
    settings = Settings()
    feeder = settings.initialize(init_file)
    model = Model(settings)
    writer = MetricsWriter(settings.tensorboard_folder, settings.run_id,
                           settings.timestamp,
                           events=settings.tensorboard_events,
                           primary=is_primary())
    try:
        if settings.train:
            engine = Train(settings, feeder, model, seed=settings.seed,
                           device=device)
            engine.global_step = settings.global_step
            ignorables = model.get_ignorable_variable_names()
            if not settings.train.ema_decay:
                # an EMA checkpoint continues cleanly without the EMA
                ignorables = ignorables + ["ema_params"]
            loaded = []
            state = feeder.init_saveload(
                engine.state_dict(), settings.resume_file, ignorables,
                loaded_out=loaded)
            engine.load_state_dict(state, restored_names=loaded)
            do_train(settings, engine, feeder, model, writer)
        else:
            val = Validation(settings, model, device=device)
            params = model.init_params(settings.seed, device=device)
            use_ema = bool(settings.val and settings.val.use_ema)
            state, ignorables = ckpt_mod.prepare_eval_state(
                params, model.get_ignorable_variable_names(), use_ema)
            feeder.compute_save_interval()
            loaded = []
            resumed = settings.should_resume()
            if resumed:
                state = feeder.init_saveload(
                    state, settings.resume_file, ignorables,
                    loaded_out=loaded)
            eval_params, _ = ckpt_mod.select_eval_params(
                state, loaded, use_ema, resumed, "val: use_ema")
            do_test(settings, val, eval_params, feeder, model, writer)
    finally:
        writer.close()
    info("Run [%s] complete." % settings.run_id, email=True)


def cli(argv=None):
    parser = argparse.ArgumentParser(
        description="Train or validate from a run config.")
    parser.add_argument("init_file", help="JSON (or YAML) run config.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run on "
                             "the CPU; cuda:0 puts every rank on card 0)")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="process-group backend of a multi-rank run "
                             "(default nccl on cuda, gloo on the cpu; "
                             "gloo lets ranks share a card)")
    args = parser.parse_args(argv)
    main(args.init_file, device=args.device, backend=args.backend)


if __name__ == "__main__":
    cli()
