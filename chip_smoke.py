#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (each raises on failure; nothing is caught and passed over):

1. the card's name and power limit; build the CUDA kernels from
   ``video_learning_tpu_torch/csrc`` with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (and smaller ones),
   with times beside the bound and the one-call library equivalent
   where there is one; the LRN kernels' designs, the vector LRN forward
   against its staged design bit for bit, and copies or adds of the
   same bytes as the memory rate reachable; lstm_step at B = 1, 8, 128
   and 32 (H = 256), 64 and 256 (H = 512) and ragged shapes (3 x 40,
   2 x 37, 257 x 512), each launched twice for the same bits, with its
   plan and how many of its clusters the card holds at once, its bound
   at the 3xTF32 rate beside the old float32-core one;
3. the full-width flagship serving forward (227x227, fpc 16, 2x256 LSTM,
   101 classes, bf16, random weights from a fixed seed): with the plain
   versions locked out, the first forward (eager, then the capture of
   its graph) launches exactly 2 LRN (both the vector design) and 32
   lstm_step kernels and one replay runs exactly as many, the logits must
   be finite
   and of shape (clips, 101), one clip in float32 must agree with the same
   forward on the CPU, and forwards at 32 clips are timed;
4. the HTTP server over a saved and reloaded serving module: single and
   concurrent /predict requests, rows equal to direct calls, /metrics
   showing a coalesced batch;
5. the full-width flagship training step (128 clips x 16 frames of
   240x320 uint8, device crop/mean/mirror, bf16, SGD at lr 0.001 with a
   global-norm clip of 10, as the JAX bench.py trains): with the plain
   versions locked out each of the first three steps (eager; eager, then
   the capture; a replay) launches exactly 2 LRN, 2 LRN backward, 32
   lstm_step and 1 conv1_dw_shifted kernels (every LRN forward and
   backward launch in its vector design), and a step with
   ``conv1_dw="blocked"`` launches 1 conv1_dw and moves conv1 as the
   shifted one does; one float32 step at 1 clip agrees between the card
   and the CPU; training steps are timed and one is profiled, which also
   lists the layout copies (``aten::contiguous``) at the LRN sites.

6. captioning at full width (the JAX ``bench.py`` caption workload:
   240x320 uint8 frames, device crop to 227, AlexNet to fc7, state_fc
   4096 -> 512, a 1x512 LSTM, 10,000 words, 300-d embeddings, T = 20,
   bf16, random weights from a fixed seed): with the plain versions
   locked out a greedy decode of 64 items launches exactly 2 LRN and 20
   lstm_step kernels, a beam-4 decode 2 LRN and 20 lstm_step kernels of
   256 rows each, and one caption training step (SGD at lr 0.001, a
   global-norm clip of 10, dropout 0.5) 2 LRN, 2 LRN backward (vector),
   20 lstm_step and 1 conv1_dw_shifted; greedy and beam-4 decodes of 2
   items in float32 agree between the card and the CPU (tokens equal,
   except at a step whose CPU margin lies within 1e-4 of a tie); greedy
   captions/s at 1, 8, 32 and 64 items, beam-4 at 64 and the training
   step are timed, one greedy decode is profiled (the card's idle share),
   and one /predict to a served, saved and reloaded caption module
   answers the captions of a direct call.  Phase 2 also holds lstm_step
   at the decode shapes (64 and 256 rows of 512).
7. int8 (w8a8) serving at the width of phase 3, as the JAX ``bench.py
   --eval --int8`` runs it: bf16, int8 and int8_static (calibrated on 32
   clips) serving modules with buckets of 1, 32 and 128 clips.  With the
   plain versions locked out one forward of 1 or 32 clips launches
   exactly 2 LRN, 32 lstm_step and 9 int8 GEMMs (``ops/int8_mm.py``,
   cuBLASLt through ``torch._int_mm``) in both int8 modes; int8 logits
   differ from bf16 by more than 0 and less than 50% of the bf16 logit
   scale; one float32 clip agrees between the card and the CPU within
   1e-3 x max(1, max|logit|); clips/s at 1, 32 and 128 clips for the
   three modules and peak memory at 128; one profiled 32-clip forward of
   bf16 and of int8 (idle share) and each int8 layer's quantize, im2col
   and GEMM times (every GEMM equal to the exact product) against the
   layer it replaces; an int8_static module with buckets [1, 8, 32]
   saved, reloaded and served: a 1-item /predict runs at bucket 1 and
   answers a direct call's rows, and the loopback selftest runs at 1 and
   8 items per request; a greedy int8 caption decode of 64 items
   launches 2 LRN, 20 lstm_step and 9 int8 GEMMs, is timed beside the
   bf16 one, and 2 items in float32 decode the same tokens on the card
   and the CPU (phase 6's tie rule).  Which shapes ``torch._int_mm``
   itself refuses on the card is printed.
8. training from a packed dataset: 424 one-clip videos of 16 240x320x3
   uint8 frames from a seeded numpy stream (1.56 GB, written by the
   port's ``RecordWriter`` into a temporary directory that is checked
   for space first and removed at the end), a JSON run config of phase
   5's training configuration with a new order every epoch, and the
   port's ``Settings().initialize`` -> ``Model`` -> ``Train`` ->
   ``FeedPrefetcher(prepare_fn=Train.prepare_device_feed)`` ->
   ``run_step`` over one epoch: the native reader is active, the batch
   plan is [128, 128, 128, 40], the tail is padded to 128 rows with 40
   ``label_mask`` ones, each step launches exactly phase 5's kernels
   with the plain versions locked out, every loss is finite; the fed
   steps are timed beside phase 5's, the feeder alone (``get_feed`` plus
   ``prepare_device_feed``, with pinned ring buffers and with fresh
   pageable ones) in ms per batch and host-to-device GB/s, one fed step
   is profiled (the card's idle share), the process's peak host RSS is
   read; a second ``Settings`` resumed from a hand-written ``.snap``
   [2, 0, 2] reads batch 2's frames and labels first (and batch 0's
   crop and mirror draws: resume leaves the draw stream at its start,
   as the JAX package does).
9. the run driver, in phase 8's folder (removed after phase 9): a val
   split of 32 videos x 4 clips of 16 240x320x3 uint8 frames packed by
   the port's RecordWriter, and JSON run configs of phase 5's training
   configuration with an EMA, an inline eval every epoch (8 videos a
   batch, top-5), one async save per epoch and the output FC's weights
   watched.  ``run_task.main`` on the train config trains one epoch of
   phase 8's split with the plain versions locked out: every step
   launches phase 5's kernels, every inline-eval batch 2 lrn and 32
   lstm_step; the metrics JSONL holds loss, lr, clips_per_sec (from
   step 2) and the watch statistics, and val_accuracy; the checkpoint
   and its .snap exist, conv1 stored as (11, 11, 3, 96).  What an async
   save costs the step after it is timed on the trained engine.
   ``run_task.main`` on the val config evaluates that checkpoint's EMA
   weights: 2 lrn and 32 lstm_step per batch, accuracy files equal to
   ``get_accuracies``, clips/s, one profiled batch (idle share); one
   batch of one video in float32 agrees between the card and the CPU
   within 1e-3 x max(1, max|logit|).  A caption val phase at phase 6's
   width (10,000 words, 300-d embeddings, T 20, state_fc 4096 -> 512,
   1x512 LSTM, random weights) over 64 packed images with a
   COCO_val2014_<id>.jpg paths file and a synthetic ground truth: 2 lrn
   and 20 lstm_step per greedy decode batch, 64 unique ids in
   coco.results.json, every score finite, captions/s.
10. media to answer, in phase 8's folder before it is removed, with no
   PIL and no YAML: 16 folders of 80 240x320 binary P6 frames written
   with numpy are packed by the port's ``serialize.main`` from a JSON
   config (rand_clips, cpv 4, fpc 16, a fixed seed, every record
   validated, the log in the folder); ``check_serialized_data`` counts
   the .size sidecar's records and ``compute_image_mean`` gives finite
   means; frames/s and MB/s.  ``tools/infer.main`` runs phase 9's val
   config and checkpoint (``--ema``, top-5) over the 16 folders: 16
   rows, 2 lrn and 32 lstm_step per val batch with the plain versions
   locked out, items/s end to end; one item in float32 agrees between
   the card and the CPU within 1e-3 x max(1, max|logit|).
   ``export_serving.export`` writes the same checkpoint with buckets
   [1, 8], float and int8_static (meta ``ema`` true, ``run_id``
   phase9_infer_val_resume); each artifact, loaded by ``serving.load``,
   answers infer's last batch (2 lrn, 32 lstm_step, and 9 int8 GEMMs
   for int8_static, per call): float logits within 1e-3 x max(1,
   max|logit|) of infer's, int8_static within (0, 50%) of the logit
   scale; export seconds and first-call ms.  Caption preprocessing:
   COCO-style annotations over 8 P6 images with a 10,000-word
   vocabulary and a 300-d GloVe-style file go through
   ``process_annotations`` and ``produce_vocab_embeddings``, the images
   are packed, ``infer`` of a fresh captioner at phase 6's width
   (``--checkpoint none``, T from the packed set's .size) gives 8
   captions with 2 lrn and 20 lstm_step per decode batch, and its
   export's token ids equal infer's.
11. compiled programs.  First the card's dropout against its
   definition: two eager float32 steps of 32 clips with dropout 0.5 and
   accum_steps 2, each mask read where the model calls it (kept units
   exactly x / 0.5, kept shares within 5 sigma of 0.5, the micro-batches'
   and the steps' masks agreeing on a share within 5 sigma of 0.5, the
   generators' seeds distinct).  Then every graphed program against the
   eager one it replaces, in float32 with TF32 off and cuDNN's
   deterministic algorithms (the eager step is not reproducible without
   them): the 8-clip training step with dropout 0.5 in two
   configurations (Adam with an EMA and a watched tensor; SGD with
   accum_steps 2), 3 replays after a ``load_state_dict`` into the
   captured engine against 3 eager steps from the same state (metrics,
   and every parameter, moment, count and EMA tensor within 1e-3 x its
   largest eager update + 1e-7 x its max|value|), ``compile_scan_steps(3)``
   as one graph against the eager loop with the same dropout stream,
   greedy and beam-4 tokens of 64 items at phase 6's width (phase 6's
   tie rule), and the classifier's float32 and int8_static serving
   forward at buckets 1, 8 and 32 (logits within 1e-5 x max(1,
   max|logit|)).  What one replay runs, counted from the profiler's
   kernel records by symbol, and what an eager call launches, counted by
   the wrappers, equal the listed counts: per training step lrn 2,
   lrn_bwd 2, lstm_step 32, conv1_dw_shifted 1 (twice each with
   accum_steps 2), 3 times that per scan, per decode lrn 2 and lstm_step
   20, per forward lrn 2 and lstm_step 32 (and int8_mm 9).  Then, in
   bf16 at full width and recorded, not held: eager and graphed times
   of the 128-clip step and ``compile_scan_steps(6)``, the greedy
   decodes at 1, 8, 32 and 64 items and beam-4 at 64 (with lstm_step's
   time per launch inside a graph), the 64-caption training step and the
   serving forward at buckets 1, 8 and 32, each with its capture time,
   pool memory and the card's idle share of one profiled replay, and
   the copy of a 128-clip feed into the captured buffers.
12. the (data x model) mesh, last, in phase 8's folder before it is
   removed (after phase 11: once other processes have used the card the
   profiler loses a kernel record of each profiled replay, and phase 11
   counts replays from those records): ranks started by
   ``parallel.launch`` (or ``torch.distributed.run``) share the card over
   gloo (NCCL refuses two ranks on one device), so this measures the
   code, not multi-GPU scaling; the kernels are phase 1's.  Four ranks
   on a (data=2, model=2) mesh: all_reduce SUM and MAX, all_gather and
   broadcast of CUDA tensors, exact; at full width (240x320 uint8 frames
   cropped to 227 on the card, 101 classes, 2x256 LSTM) one float32 step
   (TF32 off, cuDNN deterministic, dropout off) of a 128-clip batch (64
   a data rank) whose label_mask zeros all fall on data rank 1, once
   with SGD and clip 10 and once with Adam, an EMA and accum_steps 2,
   from the seed's parameters with fc6's and fc7's kernels scaled so
   that the LSTM's gates do not saturate, each against one process on
   the card running the global batch as the mesh's micro-batches: rank 0
   gathers the state and holds every tensor by the train tests' rule
   (SGD within 2% of its largest update; Adam within two updates, at
   most 1% beyond 10%), reporting phase 11's rule (1e-3 of the update)
   beside it, and the step's metrics within 1e-5 relative; each rank's
   launches per step with the plain versions locked out (lrn 2, lrn_bwd
   2, lstm_step 32, conv1_dw_shifted 1; twice that with accum_steps 2);
   the float32 forward of 16 clips, each rank's rows within 1e-3 x
   max(1, max|logit|) of the single-process rows, and the int8 and
   int8_static forwards held so to a single-process run of the global
   batch that takes the mesh's int8 activations (phase 7's rule); three
   timed bf16 steps per rank (wall, the collectives' time, bytes and
   GB/s).  Two ranks: phase 6's captioner in float32 on a (1, 2) mesh,
   greedy and beam-4 tokens of 64 items equal to the single-process ones
   (phase 6's tie rule); a ``--mesh data=2`` export of phase 9's
   checkpoint through a float32 twin of its val config, loaded in the
   2-rank group, its logits within 1e-3 x max(1, max|logit|) of the
   single-process artifact's on the same 8 items.  And ``run_task`` as 2
   ranks through ``torch.distributed.run`` on phase 8's packed set
   (host_shards auto: 212 videos a rank): a train epoch with an inline
   eval (equal loss streams in the ranks' logs, each checkpoint once
   with its .snap, one metrics JSONL, eval_state.json), a val phase (the
   accuracy files and one .total of 32 rows), and a resume from
   ``latest`` whose steps continue the first run's.

13. the remaining tools and audionet, in phase 8's folder before
   it is removed, without the profiler (graph replays run unmetered;
   captures still with the plain versions locked out), launches counted
   by the wrappers with the plain versions locked out.
   ``validate_pretrained`` on a synthesized 1000-class bvlc file exits 0
   (manifest recorded), 0 (matched) and 1 for a modified file against
   that manifest, each fixture forward launching its 2 LRN kernels; its
   fc6 and fc7 features on the card within 1e-3 normwise of the CPU's
   (float32, TF32 off).  ``profile_ablation`` at phase 5's width (128
   clips x 16 frames of 240x320 uint8, crop 227, bf16), its stage rows
   and its ``--per-layer`` rows: the JAX tool's rows and names, every
   time finite and above 0, each row's kernel launches per call exact
   (LRN rows lrn; forward+backward rows lrn_bwd, all in the vector
   design, and conv1_dw_shifted; the LSTM row lstm_step), its approximate
   step printed beside phase 5's.  ``run_task`` trains 2 epochs of 32
   one-clip videos (16 a batch, phase 9's configuration, an lr decay)
   and saves 2 checkpoints; over a val split of 8 videos x 2 clips in
   float32 (TF32 off, cuDNN deterministic) each checkpoint's val phase
   run directly, ``evaluate_multiple_checkpoints`` in process, with
   ``--only 2``, ``--omit 2`` and ``--subprocess --only 1`` (a child
   ``run_task`` with NVIDIA_TF32_OVERRIDE=0), and ``validate_checkpoints``
   over a folder of one checkpoint give the same accuracies, and each
   one-checkpoint evaluation's logits equal its direct run's (bit for
   bit in this process, within 1e-5 of the logit scale in the child).
   On the card's artifacts: ``inspect_checkpoint``; ``modify_checkpoint``
   (rename, regex-rename, create), whose output restores in ``run_task``
   with the original's logits; ``combine_logits`` of a val run's logits
   with themselves gives its accuracy at every weight, as does
   ``compute_evaluation_stats``, and ``view_logits_info`` counts its
   rows; ``export_tfrecord`` of phase 10's caption image records frames
   them in pure Python (no tensorflow there), each frame's CRC checked,
   one record per ``.size`` item; ``lr_calc`` prints the schedule
   ``Train`` wrote.  audionet's float32 logits on the card within 1e-4
   normwise of the CPU's.  Cuts: the tools run on tens of videos, and
   ``export_tfrecord`` on the caption records rather than the 236 MB
   video pack (its pure-Python CRC32C frames a few MB/s).  Not run on
   the card's machine: ``import_tfrecord`` (needs tensorflow),
   ``split_video`` and the mp3 path of ``audio/spectrograms`` (need
   ffmpeg), spectrogram PNGs (need PIL); each raises there, as the CPU
   tests show.
14. resume and serve over a mesh, last, in phase 8's folder before it is
   removed, without the profiler (float32 with TF32 off and cuDNN
   deterministic where it compares).  Phase 5's training step with Adam,
   an EMA and two tiers (lr_mult 2) at 128 clips in bf16: 3 uninterrupted
   steps against 2 steps, ``save_checkpoint``, a fresh ``Train``,
   ``restore_checkpoint(strict=True)``, ``load_state_dict`` and step 3.
   The file names the optimizer state as the JAX package does,
   ``opt_state_leaves/0..N-1`` with N = 2 x tiers + 2 x parameters (no
   ``opt_state/`` name); each tier resumes at the schedule's lr of step
   3; the resumed step, counted with the plain versions locked out,
   launches lrn 2, lrn_bwd 2, lstm_step 32 and conv1_dw_shifted 1; its
   metrics within 1e-5 relative and every state tensor within phase
   11's rule.  The same at 8 clips in float32 into an engine that has
   captured its step before the restore, so the resumed step is a replay
   into the restored tensors: bitwise equal to the uninterrupted step.
   Meanwhile 4 gloo ranks sharing the card export phase 12's checkpoint
   in float32 as a (data 2, model 2) artifact with buckets [2, 8, 32],
   and each loads it; after the resumed runs each runs ``tools.serve``:
   rank 0 serves while five clients post 1, 1, 1, 8 and 32 items at
   once (the 1-item requests coalesce), and the other ranks follow; the
   rows within 1e-3 x max(1, max|logit|) of the single-process module
   of the artifact's parameters (eager, as the mesh), every call on
   every rank launching lrn 2 and lstm_step 32; then a 1 s ``selftest``
   a size on the mesh and on the single process (recorded, not held:
   the ranks share one card), and every rank exits 0 after rank 0's
   stop.
15. conv1's other lowerings, the frozen conv1 and remat, in a
   process of its own (after phases 12 and 14 ran other processes on
   the card, this process's profiler loses kernel records of replays).
   At a training step's 2048 frames in bf16, as CUDA-graph replays in
   turns: conv1's forward, direct and space-to-depth
   (``alexnet.conv1_space_to_depth``), within a few bf16 steps of each
   other, and its weight gradient, ``conv1_dw_shifted`` and im2col
   (``conv1_dw_im2col``), within 1e-4 of the scale, each beside its
   bound.  Phase 5's 128-clip bf16 step with ``conv1_fwd="s2d"``,
   ``conv1_dw="im2col"``, ``freeze_conv1=True`` and ``settings.remat``:
   with the plain versions locked out each of its first three steps
   (eager; eager, then the capture; a replay, counted by the profiler)
   launches lrn 2 (remat: 4, the recompute), lrn_bwd 2 (freeze: 1,
   nothing below conv2 needs a gradient), lstm_step 32 and
   conv1_dw_shifted 1 (im2col and freeze: 0), every LRN launch the
   vector design; each graphed step timed beside the default one in
   turns, the eager step's peak memory and the graph pool's bytes of
   each.  In float32 (TF32 off, cuDNN deterministic, dropout 0.5) 3
   steps of 8 clips with remat, eager and graphed, against the eager
   steps without remat (phase 11's rule; bitwise equality printed), and
   what one remat replay runs.  One s2d and one im2col float32 step at
   1 clip, card against CPU (phase 5's rule).

16. CUDA graphs over NCCL, last, in a process of its own that joins a
   one-rank NCCL group bound to the card (``device_id``) and leaves it
   at its end.  The card holds one rank, and on a world of one the port
   issues no collective, so the phase's mesh (``OneRankNcclMesh``)
   reports two ranks while its data and model axes stay 1, and issues
   every collective on that group, counting those a capture records.
   On it, with TF32 off and cuDNN deterministic: phase 11's float32
   8-clip steps in both configurations, 3 replays after a restore
   bitwise equal to 3 eager steps on the mesh and, against the eager
   steps without a mesh, bitwise or within phase 11's rule (printed),
   each capture recording the step's ``data_sum``; ``compile_scan_steps(3)``
   held the same way (3 ``data_sum``); the classifier's serving module
   at buckets 1, 8 and 32 in float32, int8 and int8_static, replays
   bitwise equal to the eager module on the mesh or within 1e-5 x
   max(1, max|logit|), each dynamic-int8 capture holding the amax's
   ``data_max``; ``Validation.run_forward`` of one 8-clip batch and the
   greedy and beam-4 decodes of 64 items (phase 6's tie rule); the list
   form of all_gather inside a capture.  Then phase 5's 128-clip bf16
   step graphed on the mesh and without one, each of its first three
   steps launching lrn 2, lrn_bwd 2, lstm_step 32 and conv1_dw_shifted
   1 (the replay's counted by the profiler), its capture recording the
   ``data_sum``, the two timed in turns.  The model axis's column split
   needs two ranks, and so two cards: not shown.

Phases 3-10 run the port's defaults, which on the card are graph
replays: a program's first call at a shape runs eagerly and then
captures it (a training step's second), later calls replay.  Every
capture runs with the plain versions locked out.  A launch count is
measured: a wrapper counts the kernels it launches to run at once (a
launch that a capture records counts apart, ``graphs.py``), and inside
the blocks that count, each replay runs under the profiler and its
kernels are counted from the profiler's kernel records by symbol, and
must equal what its capture recorded.  Times taken in those blocks leave
the profiler's own time out.

The line before the last lists every ported kernel as JSON; its launches
are those of the main path's counted runs: phase 3's two forwards (the
first eager, then a replay) for lrn and lstm_step, phase 5's three
steps (two eager, then a replay) for lrn_bwd and conv1_dw_shifted, and
the eager blocked step for conv1_dw.  The last line is ``{"ok": true,
"device": {...}}``.
Without a CUDA device, or without the package beside it, the script exits
nonzero and prints no result.
"""

import argparse
import collections
import gc
import glob
import http.client
import importlib.util
import io
import json
import math
import os
import random
import re
import resource
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from video_learning_tpu_torch import checkpoint, run_task, serving
from video_learning_tpu_torch import graphs as graphs_mod
from video_learning_tpu_torch import val as val_mod
from video_learning_tpu_torch.batching import BatchGeometry
from video_learning_tpu_torch.config import Settings
from video_learning_tpu_torch.data import native_io, records, serialize
from video_learning_tpu_torch.data.prefetch import FeedPrefetcher
from video_learning_tpu_torch.defs import defs
from video_learning_tpu_torch.flagship import (SERVING_IMGPROC, SERVING_MEAN,
                                               caption_feed,
                                               caption_flagship, flagship)
from video_learning_tpu_torch.models import alexnet, audionet, layers
from video_learning_tpu_torch.models import lstm as decode_mod
from video_learning_tpu_torch.models import pipeline as pipeline_mod
from video_learning_tpu_torch.models.pipeline import Model
from video_learning_tpu_torch.ops import _build
from video_learning_tpu_torch.ops import conv1_dw as conv1_mod
from video_learning_tpu_torch.ops import int8_mm as int8_mod
from video_learning_tpu_torch.ops import lrn as lrn_mod
from video_learning_tpu_torch.ops import lstm_step as lstm_mod
from video_learning_tpu_torch.ops.preprocess import make_preprocessor
from video_learning_tpu_torch.parallel import launch
from video_learning_tpu_torch.parallel import mesh as mesh_mod
from video_learning_tpu_torch.parallel.mesh import Mesh
from video_learning_tpu_torch.tools import check_serialized_data
from video_learning_tpu_torch.tools import combine_logits
from video_learning_tpu_torch.tools import compute_evaluation_stats
from video_learning_tpu_torch.tools import compute_image_mean
from video_learning_tpu_torch.tools import evaluate_multiple_checkpoints
from video_learning_tpu_torch.tools import export_tfrecord
from video_learning_tpu_torch.tools import export_serving as export_mod
from video_learning_tpu_torch.tools import infer as infer_mod
from video_learning_tpu_torch.tools import inspect_checkpoint, lr_calc
from video_learning_tpu_torch.tools import modify_checkpoint
from video_learning_tpu_torch.tools import process_annotations
from video_learning_tpu_torch.tools import produce_vocab_embeddings
from video_learning_tpu_torch.tools import profile_ablation
from video_learning_tpu_torch.tools import serve as serve_mod
from video_learning_tpu_torch.tools import validate_checkpoints
from video_learning_tpu_torch.tools import validate_pretrained
from video_learning_tpu_torch.tools import view_logits_info
from video_learning_tpu_torch.train import WARMUP_STEPS, Train

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the
# float32 rate outside the tensor cores and the dense bf16 tensor-core
# rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
# the fastest float32-accurate route for a product: 3xTF32 on the tensor
# cores, three TF32 products (495 TFLOP/s dense) for each float32 one
PEAK_3XTF32_OPS_PER_S = 495e12 / 3
PEAK_INT8_OPS_PER_S = 1979e12

SERVE_CLIPS = 32        # clips per timed serving forward
FPC, IMAGE, RAW_HW, CLASSES, HIDDEN, LAYERS = 16, 227, (240, 320), 101, 256, 2
LRN_SITES = ((57, 57, 96), (28, 28, 256))   # conv1 and conv2 at 227x227
TRAIN_CLIPS = 128       # clips per training step (bench.py's batch)
CAPTION_ITEMS = 64      # captions per decode / training step (bench.py)
BEAM = 4                # beam width of the beam-search decode
INT8_MODES = ("int8", "int8_static")
INT8_CLIPS = (1, 32, 128)   # clips per timed forward, and the buckets
INT8_CALIB_CLIPS = 32       # clips of the int8_static calibration batch
# int8 GEMMs of a forward to fc7: conv2 x2 groups, conv3, conv4 x2,
# conv5 x2, fc6, fc7
INT8_MM_PER_FORWARD = 9


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no GPU")
    return out[0]


def _events_ms(run, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, iters=5, reps=5, warmup=2):
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    cost of launching (Python, the wrapper, ctypes) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = _events_ms(graph.replay, reps) / iters
    del graph
    torch.cuda.empty_cache()        # hand the graph's pool back
    return ms


def eager_ms(fn, iters=100):
    """Mean milliseconds per call of ``iters`` back-to-back eager calls,
    host launch cost included (what the serving loop pays)."""
    fn()
    return _events_ms(fn, iters)


def bound_ms(nbytes, ops, peak_ops=PEAK_F32_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def errors(out, ref):
    out, ref = out.double(), ref.double()
    diff = (out - ref).abs()
    rel = diff / ref.abs().clamp_min(1e-30)
    return float(diff.max()), float(torch.where(ref != 0, rel, diff).max())


# ------------------------------------------------------------- phase 2
def lrn_case(n, h, w, c, dtype, gen, radius=2):
    x = F.relu(torch.randn((n, h, w, c), generator=gen, device="cuda")
               * 40.0).to(dtype)
    before = dict(lrn_mod.lrn.variant_launches)
    out = lrn_mod.lrn(x, radius)
    variant, = [k for k, v in lrn_mod.lrn.variant_launches.items()
                if v != before[k]]
    ref = lrn_mod.lrn_reference(x, radius)
    torch.cuda.synchronize()
    rtol, atol = (1e-2, 1e-6) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    abs_err, rel_err = errors(out, ref)
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        raise AssertionError("lrn %s %s: kernel disagrees with plain "
                             "(max abs %.3g, max rel %.3g; rtol %g atol %g)"
                             % (tuple(x.shape), dtype, abs_err, rel_err,
                                rtol, atol))
    xt = x.permute(0, 3, 1, 2)    # channels_last NCHW view, no copy
    size = 2 * radius + 1         # torch's alpha is per window element

    def library():
        return F.local_response_norm(xt, size, alpha=size * 2e-5,
                                     beta=0.75, k=1.0)

    lib_err = errors(library().permute(0, 2, 3, 1), ref)[0]
    del ref
    numel = x.numel()
    bnd, by = bound_ms(2 * numel * x.element_size(), 12 * numel)
    # the rate this card's memory reaches for the same traffic: a copy
    # reads x and writes a tensor of its size
    same_bytes = torch.empty_like(x)
    case = {
        "shape": list(x.shape), "dtype": str(dtype).replace("torch.", ""),
        "radius": radius, "max_abs_err": abs_err, "max_rel_err": rel_err,
        "rtol": rtol, "variant": variant,
        "ms": cuda_ms(lambda: lrn_mod.lrn(x, radius)),
        "plain_ms": cuda_ms(lambda: lrn_mod.lrn_reference(x, radius)),
        "library_ms": cuda_ms(library),
        "library_max_abs_err": lib_err, "bound_ms": bnd, "bound_by": by,
        "same_bytes_copy_ms": cuda_ms(lambda: same_bytes.copy_(x))}
    case["share_of_bound"] = bnd / case["ms"]
    staged = ""
    if variant == "vector":
        # the staged design on a copy that starts 2 bytes into its storage
        # (no 16-byte chunks): the same arithmetic, so the same bits
        buf = torch.empty(numel + 1, dtype=dtype, device="cuda")
        xu = buf[1:].view(x.shape)
        xu.copy_(x)
        if not torch.equal(lrn_mod.lrn(xu, radius), out):
            raise AssertionError("lrn %s %s: the vector and staged designs "
                                 "differ" % (tuple(x.shape), dtype))
        case["staged_ms"] = cuda_ms(lambda: lrn_mod.lrn(xu, radius))
        staged = "; staged design %.4f ms, bit for bit equal" % \
            case["staged_ms"]
        del buf, xu
    log("  lrn %-18s %-8s r=%d max_abs %.3g max_rel %.3g | %s kernel %.4f "
        "ms (%.0f%% of bound) plain %.4f ms library %.4f ms bound %.1f us "
        "(%s); a copy of the same bytes %.4f ms%s"
        % (tuple(x.shape), case["dtype"], radius, abs_err, rel_err, variant,
           case["ms"], 100 * case["share_of_bound"], case["plain_ms"],
           case["library_ms"], bnd * 1e3, by, case["same_bytes_copy_ms"],
           staged))
    del same_bytes
    return case


def lstm_case(batch, gen, H=HIDDEN):

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    xproj, h, c = rnd(batch, 4 * H), torch.tanh(rnd(batch, H)), rnd(batch, H)
    wh, b = rnd(H, 4 * H, scale=0.05), rnd(4 * H, scale=0.1)
    out_h, out_c = lstm_mod.lstm_step(xproj, h, c, wh, b)
    ref_h, ref_c = lstm_mod.lstm_step_reference(xproj, h, c, wh, b)
    torch.cuda.synchronize()
    rtol = atol = 1e-5
    abs_err = max(errors(out_h, ref_h)[0], errors(out_c, ref_c)[0])
    rel_err = max(errors(out_h, ref_h)[1], errors(out_c, ref_c)[1])
    if not (torch.allclose(out_h, ref_h, rtol=rtol, atol=atol) and
            torch.allclose(out_c, ref_c, rtol=rtol, atol=atol)):
        raise AssertionError("lstm_step B=%d H=%d: kernel disagrees with "
                             "plain (max abs %.3g)" % (batch, H, abs_err))
    again_h, again_c = lstm_mod.lstm_step(xproj, h, c, wh, b)
    if not (torch.equal(again_h, out_h) and torch.equal(again_c, out_c)):
        raise AssertionError("lstm_step B=%d H=%d: two launches differ"
                             % (batch, H))
    nbytes = 4 * (batch * 4 * H + 2 * batch * H + 4 * H * H + 4 * H
                  + 2 * batch * H)
    ops = 2 * batch * H * 4 * H + 20 * batch * H
    bnd, by = bound_ms(nbytes, ops, PEAK_3XTF32_OPS_PER_S)
    p = lstm_mod.card_plan(batch, H, xproj.device)
    resident = _build.library().vlt_lstm_step_max_clusters(
        H, p.rows, p.wj, p.k_cta, p.split)
    case = {
        "batch": batch, "hidden": H, "max_abs_err": abs_err,
        "max_rel_err": rel_err, "rtol": rtol, "atol": atol,
        "ms": cuda_ms(lambda: lstm_mod.lstm_step(xproj, h, c, wh, b),
                      iters=50),
        "plain_ms": cuda_ms(
            lambda: lstm_mod.lstm_step_reference(xproj, h, c, wh, b),
            iters=50),
        "eager_ms": eager_ms(lambda: lstm_mod.lstm_step(xproj, h, c, wh, b)),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "bound_f32_cores_ms": bound_ms(nbytes, ops)[0],
        "plan": p._asdict(), "clusters": p.tiles * p.groups,
        "resident_clusters": resident}
    case["share_of_bound"] = bnd / case["ms"]
    log("  lstm_step B=%-4d H=%d max_abs %.3g, two launches equal | kernel "
        "%.4f ms (%.0f%% of bound) plain %.4f ms bound %.2f us (%s); eager "
        "launch-to-launch %.4f ms; %d clusters of %d CTAs x %d threads "
        "(%d resident at once); no single library call computes it"
        % (batch, H, abs_err, case["ms"], 100 * case["share_of_bound"],
           case["plain_ms"], bnd * 1e3, by, case["eager_ms"],
           case["clusters"], p.split, p.threads, resident))
    return case


def lrn_bwd_case(n, h, w, c, dtype, gen, radius=2):
    x = F.relu(torch.randn((n, h, w, c), generator=gen, device="cuda")
               * 40.0).to(dtype)
    g = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    before = dict(lrn_mod.lrn_backward.variant_launches)
    out = lrn_mod.lrn_backward(x, g, radius)
    variant, = [k for k, v in lrn_mod.lrn_backward.variant_launches.items()
                if v != before[k]]
    ref = lrn_mod.lrn_backward_reference(x, g, radius)
    torch.cuda.synchronize()
    # f32: the same formula, sums in the same order; bf16: dx within one
    # bf16 ulp of the plain version
    rtol, atol = ((1e-2, 1e-2 * float(g.float().abs().max()))
                  if dtype == torch.bfloat16 else (1e-5, 1e-5))
    abs_err, rel_err = errors(out, ref)
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        raise AssertionError("lrn_bwd %s %s: kernel disagrees with plain "
                             "(max abs %.3g, max rel %.3g; rtol %g atol %g)"
                             % (tuple(x.shape), dtype, abs_err, rel_err,
                                rtol, atol))
    if not torch.equal(lrn_mod.lrn_backward(x, g, radius), out):
        raise AssertionError("lrn_bwd %s %s: two runs differ"
                             % (tuple(x.shape), dtype))
    # library yardstick: autograd's backward of F.local_response_norm on
    # the same channels_last input (the port never calls it)
    size = 2 * radius + 1
    xt = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    y = F.local_response_norm(xt, size, alpha=size * 2e-5, beta=0.75, k=1.0)
    gt = g.permute(0, 3, 1, 2)

    def library():
        return torch.autograd.grad(y, xt, gt, retain_graph=True)

    lib_err = errors(library()[0].permute(0, 2, 3, 1), ref)[0]
    # the rate this card's memory reaches for the same traffic: one torch
    # add reads x and g and writes a tensor of their size, with no work
    same_bytes = torch.empty_like(x)
    numel = x.numel()
    bnd, by = bound_ms(3 * numel * x.element_size(), 30 * numel)
    case = {
        "shape": list(x.shape), "dtype": str(dtype).replace("torch.", ""),
        "radius": radius, "max_abs_err": abs_err, "max_rel_err": rel_err,
        "rtol": rtol, "atol": atol,
        "ms": cuda_ms(lambda: lrn_mod.lrn_backward(x, g, radius)),
        "plain_ms": cuda_ms(
            lambda: lrn_mod.lrn_backward_reference(x, g, radius)),
        "library_ms": eager_ms(library, iters=5),
        "library_max_abs_err": lib_err, "bound_ms": bnd, "bound_by": by,
        "variant": variant,
        "same_bytes_add_ms": cuda_ms(lambda: torch.add(x, g,
                                                       out=same_bytes))}
    case["share_of_bound"] = bnd / case["ms"]
    log("  lrn_bwd %-18s %-8s r=%d max_abs %.3g max_rel %.3g | %s kernel "
        "%.4f ms (%.0f%% of bound) plain %.4f ms library %.4f ms bound "
        "%.1f us (%s); an add of the same bytes %.4f ms"
        % (tuple(x.shape), case["dtype"], radius, abs_err, rel_err, variant,
           case["ms"], 100 * case["share_of_bound"], case["plain_ms"],
           case["library_ms"], bnd * 1e3, by, case["same_bytes_add_ms"]))
    del y, xt, same_bytes
    return case


def conv1_dw_case(fn, n, dtype, gen, graph_plain=True):
    """One conv1 weight-gradient kernel at the training geometry (227x227
    frames, a 57x57x96 gradient), against its plain version.
    ``graph_plain``: time the plain version from a CUDA graph; without,
    eagerly (at 2048 frames a graph of its tap-sized temporaries would
    hold tens of GB)."""
    x = torch.randn((n, IMAGE, IMAGE, 3), generator=gen,
                    device="cuda").to(dtype)
    oh = -(-IMAGE // 4)
    g = torch.randn((n, oh, oh, 96), generator=gen, device="cuda").to(dtype)
    plain = (conv1_mod.conv1_dw_reference if fn is conv1_mod.conv1_dw
             else conv1_mod.conv1_dw_shifted_reference)
    out = fn(x, g)
    ref = plain(x, g)
    torch.cuda.synchronize()
    case = {"shape": [n, IMAGE, IMAGE, 3], "dtype":
            str(dtype).replace("torch.", "")}
    # float32 sums in another order (bf16 products are exact in f32)
    atol = 1e-5 * float(ref.abs().max())
    abs_err, rel_err = errors(out, ref)
    if not torch.allclose(out, ref, rtol=1e-5, atol=atol):
        raise AssertionError(
            "%s %s %s: kernel disagrees with plain (max abs %.3g; rtol "
            "1e-5 atol %.3g)" % (fn.__name__, case["shape"], dtype,
                                 abs_err, atol))
    if not torch.equal(fn(x, g), out):
        raise AssertionError("%s: two runs differ" % fn.__name__)
    del ref
    case.update(max_abs_err=abs_err, max_rel_err=rel_err, rtol=1e-5,
                atol=atol, plain_ms=(
                    cuda_ms(lambda: plain(x, g), iters=2, reps=2)
                    if graph_plain else eager_ms(lambda: plain(x, g),
                                                 iters=2)))
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

    def library():
        return torch.nn.grad.conv2d_weight(xn, (96, 3, 11, 11), gn,
                                           stride=4, padding=4)

    nbytes = x.numel() * x.element_size() + g.numel() * g.element_size() \
        + 11 * 11 * 3 * 96 * 4
    ops = 2 * 11 * 11 * 3 * 96 * n * oh * oh
    bnd, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S)
    case.update(ms=cuda_ms(lambda: fn(x, g), iters=3, reps=3),
                library_ms=cuda_ms(library, iters=3, reps=3),
                bound_ms=bnd, bound_by=by)
    case["share_of_bound"] = bnd / case["ms"]
    log("  %-16s %-18s %-8s max_abs %.3g | kernel on the raw frames %.3f "
        "ms (%.0f%% of bound) plain %.3f ms library %.3f ms bound %.3f ms "
        "(%s)"
        % (fn.__name__, tuple(case["shape"]), case["dtype"], abs_err,
           case["ms"], 100 * case["share_of_bound"], case["plain_ms"],
           case["library_ms"], bnd, by))
    return case


def phase_kernels(clips):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_frames = clips * FPC
    train_frames = TRAIN_CLIPS * FPC
    log("phase 2: kernels against their plain versions")
    lrn_cases = [lrn_case(8 * FPC, *site, dtype, gen)
                 for site in LRN_SITES
                 for dtype in (torch.bfloat16, torch.float32)]
    # a ragged channel count, and a radius the kernel does not unroll
    lrn_cases += [lrn_case(8 * FPC, 5, 5, 7, torch.float32, gen),
                  lrn_case(8 * FPC, 5, 5, 40, torch.bfloat16, gen, radius=3)]
    lrn_main = [lrn_case(n_frames, *site, torch.bfloat16, gen)
                for site in LRN_SITES]
    # the training step's forward sites (not this line's main path)
    lrn_cases += [lrn_case(train_frames, *site, torch.bfloat16, gen)
                  for site in LRN_SITES]
    # the caption path's sites (phase 6): conv1 and conv2 of its frames
    cap_lrn = [lrn_case(CAPTION_ITEMS, *site, torch.bfloat16, gen)
               for site in LRN_SITES]
    lstm_cases = [lstm_case(b, gen) for b in (1, 8, 128)]
    # the caption decode shapes: greedy (64 rows) and beam-4 (256 rows)
    _, hidden = caption_sizes(caption_flagship()[1])
    lstm_cases += [lstm_case(b, gen, hidden)
                   for b in (CAPTION_ITEMS, BEAM * CAPTION_ITEMS)]
    # ragged: H not a multiple of the j tile, H not a multiple of 4 (the
    # kernel's 4-byte copies), one row past the plan's 128-row groups
    lstm_cases += [lstm_case(3, gen, 40), lstm_case(2, gen, 37),
                   lstm_case(BEAM * CAPTION_ITEMS + 1, gen, hidden)]
    lstm_main = lstm_case(clips, gen)
    log("  lstm_step bound at the 3xTF32 rate (495 / 3 TFLOP/s) beside the "
        "one at the float32 CUDA-core rate (67 TFLOP/s) used before: %s"
        % ", ".join("(%d, %d) %.2f / %.2f us" % (
            k["batch"], k["hidden"], k["bound_ms"] * 1e3,
            k["bound_f32_cores_ms"] * 1e3) for k in lstm_cases + [lstm_main]))
    bwd_cases = [lrn_bwd_case(8 * FPC, *site, dtype, gen)
                 for site in LRN_SITES
                 for dtype in (torch.bfloat16, torch.float32)]
    bwd_cases += [lrn_bwd_case(8 * FPC, 5, 5, 7, torch.float32, gen),
                  lrn_bwd_case(8 * FPC, 5, 5, 40, torch.bfloat16, gen,
                               radius=3)]
    bwd_main = [lrn_bwd_case(train_frames, *site, torch.bfloat16, gen)
                for site in LRN_SITES]
    bwd_cases += [lrn_bwd_case(CAPTION_ITEMS, *site, torch.bfloat16, gen)
                  for site in LRN_SITES]
    dw = {}
    for fn in (conv1_mod.conv1_dw, conv1_mod.conv1_dw_shifted):
        cases = [conv1_dw_case(fn, 256, dtype, gen)
                 for dtype in (torch.bfloat16, torch.float32)]
        if fn is conv1_mod.conv1_dw_shifted:    # the caption step's split
            cases.append(conv1_dw_case(fn, CAPTION_ITEMS, torch.bfloat16,
                                       gen))
        main = conv1_dw_case(fn, train_frames, torch.bfloat16, gen,
                             graph_plain=False)
        dw[fn.__name__] = (cases + [main], [main])
    return {"lrn": (lrn_cases + cap_lrn + lrn_main, lrn_main),
            "lstm_step": (lstm_cases + [lstm_main], [lstm_main] *
                          (FPC * LAYERS)),
            "lrn_bwd": (bwd_cases + bwd_main, bwd_main), **dw}


# ------------------------------------------------------------- phase 3
_PLAIN = ((lrn_mod, "lrn_reference"), (lrn_mod, "lrn_backward_reference"),
          (lstm_mod, "lstm_step_reference"),
          (conv1_mod, "conv1_dw_reference"),
          (conv1_mod, "conv1_dw_shifted_reference"),
          (int8_mod, "int8_mm_reference"))
# each kernel wrapper (and the int8 GEMM's), by the name its count goes
# under
_WRAPPERS = {"lrn": lrn_mod.lrn, "lrn_bwd": lrn_mod.lrn_backward,
             "lstm_step": lstm_mod.lstm_step, "conv1_dw": conv1_mod.conv1_dw,
             "conv1_dw_shifted": conv1_mod.conv1_dw_shifted,
             "int8_mm": int8_mod.int8_mm}


# each kernel by the symbol the profiler records for it (conv1_dw's
# template argument is by_rows: true for the shifted entry point;
# int8_mm's GEMM is cuBLAS's s8 kernel), and the LRN forward's and
# backward's designs
KERNEL_SYMBOLS = {"lrn": r"lrn_fwd_(vec_)?kernel<",
                  "lrn_bwd": r"lrn_bwd_(vec_)?kernel<",
                  "lstm_step": r"lstm_step_wgmma\b",
                  "conv1_dw": r"conv1_dw_(wgmma|f32)<false>",
                  "conv1_dw_shifted": r"conv1_dw_(wgmma|f32)<true>",
                  "int8_mm": r"gemm_s8|_s8s8|i8i8|imma"}
FWD_SYMBOLS = {"staged": r"lrn_fwd_kernel<", "vector": r"lrn_fwd_vec_kernel<"}
BWD_SYMBOLS = {"staged": r"lrn_bwd_kernel<", "vector": r"lrn_bwd_vec_kernel<"}
# a wrapper's name, as a program's capture records it, by its count's name
_COUNT_NAMES = {"lrn_backward": "lrn_bwd"}


def kernel_counts(prof, symbols=KERNEL_SYMBOLS):
    """{kernel: records} of a profile's kernel records by symbol, and the
    names of all its kernel records."""
    from torch.autograd import DeviceType
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return ({k: sum(1 for n in names if re.search(rx, n))
             for k, rx in symbols.items()}, names)


class _Meter:
    """What graph replays run, measured.  While ``on`` (inside
    ``_PlainLockedOut``) every ``graphs.Program.replay`` runs under the
    profiler, after a sync (earlier work is not the replay's) and with one
    after it; its kernels are counted from the profiler's kernel records
    by symbol into ``kernels`` and ``variants``, and must equal what the
    program's capture recorded.  ``overhead_s`` is the profiler's own
    host time around the replays, which timed calls leave out."""

    def __init__(self):
        self.on = 0
        self.reset()
        self.overhead_s = 0.0
        self.total_replays = 0

    def reset(self):
        self.replays = 0
        self.kernels = dict.fromkeys(KERNEL_SYMBOLS, 0)
        self.variants = dict.fromkeys(BWD_SYMBOLS, 0)
        self.fwd_variants = dict.fromkeys(FWD_SYMBOLS, 0)


_METER = _Meter()
_REPLAY = graphs_mod.Program.replay
_CAPTURE = graphs_mod.Program.capture


def _metered_replay(program):
    if not _METER.on:
        return _REPLAY(program)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t1 = time.monotonic()
    try:
        out = _REPLAY(program)
        torch.cuda.synchronize()
        t2 = time.monotonic()
    finally:
        prof.stop()
    ran, names = kernel_counts(prof)
    designs, _ = kernel_counts(prof, BWD_SYMBOLS)
    fwd_designs, _ = kernel_counts(prof, FWD_SYMBOLS)
    _METER.overhead_s += (t1 - t0) + (time.monotonic() - t2)
    recorded = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name, n in program.launch_counts().items():
        recorded[_COUNT_NAMES.get(name, name)] = n
    if ran != recorded:
        raise AssertionError(
            "a replay of %s ran %s (profiler), its capture recorded %s; "
            "the kernels it ran: %s"
            % (program.name, ran, recorded, sorted(set(names))))
    _METER.replays += 1
    _METER.total_replays += 1
    for k, n in ran.items():
        _METER.kernels[k] += n
    for k, n in designs.items():
        _METER.variants[k] += n
    for k, n in fwd_designs.items():
        _METER.fwd_variants[k] += n
    return out


def _locked_capture(program, *args, **kwargs):
    """Every capture runs with the plain versions locked out: what a
    capture records runs at every replay."""
    with _PlainLockedOut():
        return _CAPTURE(program, *args, **kwargs)


def install_meter():
    """Every capture with the plain versions locked out, and replays
    measured inside ``_PlainLockedOut``."""
    graphs_mod.Program.capture = _locked_capture
    graphs_mod.Program.replay = _metered_replay


class _PlainLockedOut:
    """The main path runs in this block: the plain versions raise (the
    kernels' wrappers must not reach them for CUDA tensors), and graph
    replays are measured (``_Meter``)."""

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in _PLAIN]

        def forbidden(*args, **kwargs):
            raise AssertionError("plain version called on the main path")

        for mod, name in _PLAIN:
            setattr(mod, name, forbidden)
        _METER.on += 1
        return self

    def __exit__(self, *exc):
        _METER.on -= 1
        for (mod, name), fn in zip(_PLAIN, self.saved):
            setattr(mod, name, fn)


def reset_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0
    lrn_mod.lrn_backward.variant_launches = dict.fromkeys(lrn_mod.VARIANTS,
                                                          0)
    lrn_mod.lrn.variant_launches = dict.fromkeys(lrn_mod.VARIANTS, 0)
    _METER.reset()


def counts(names=("lrn", "lstm_step")):
    """Launches since ``reset_counts``: each wrapper's count of the
    kernels it launched to run at once, plus what graph replays ran,
    counted from the profiler (``_Meter``)."""
    return {name: _WRAPPERS[name].launches + _METER.kernels[name]
            for name in names}


def variants():
    """The LRN backward's launches by design, counted as ``counts``
    counts them."""
    return {k: lrn_mod.lrn_backward.variant_launches[k] + _METER.variants[k]
            for k in lrn_mod.VARIANTS}


def fwd_variants():
    """The LRN forward's launches by design, counted as ``counts``
    counts them."""
    return {k: lrn_mod.lrn.variant_launches[k] + _METER.fwd_variants[k]
            for k in lrn_mod.VARIANTS}


def serving_inputs(processor, clips, seed):
    n = clips * FPC
    rs = np.random.RandomState(seed)
    frames = rs.randint(0, 256, (n,) + RAW_HW + (3,), np.uint8)
    return frames, processor.draw_params(n, random.Random(seed))


def phase_forward(results):
    log("phase 3: full-width serving forward")
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                               lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                               mean_scalars=SERVING_MEAN,
                               imgproc=SERVING_IMGPROC,
                               compute_dtype="bfloat16")
    processor = settings.feeder.datasets[0].processor
    t0 = time.monotonic()
    params = model.init_params(seed=0, device="cuda")
    log("  init (torch.Generator seed 0): %.1f s" % (time.monotonic() - t0))
    module = serving.ServingModule(model, params, batch_items=SERVE_CLIPS,
                                   device="cuda")
    frames, prm = serving_inputs(processor, SERVE_CLIPS, seed=0)
    frames_dev = torch.from_numpy(frames).cuda()
    prm_dev = torch.from_numpy(prm).cuda()

    # the main path: the first forward runs eagerly and then captures the
    # bucket's graph, the second is a replay
    want = {"lrn": 2, "lstm_step": FPC * LAYERS}
    reset_counts()
    with _PlainLockedOut():
        module(frames_dev, prm_dev)
        torch.cuda.synchronize()
        eager = counts()
        logits = module(frames_dev, prm_dev)
        torch.cuda.synchronize()
    launched = counts()
    replayed = {k: launched[k] - eager[k] for k in launched}
    log("  the first forward of %d clips launched %s (wrappers), then "
        "captured; a replay ran %s (profiler)"
        % (SERVE_CLIPS, eager, replayed))
    if eager != want or replayed != want or _METER.replays != 1:
        raise AssertionError("expected %s in the first forward and in one "
                             "replay, got %s and %s (%d replays)"
                             % (want, eager, replayed, _METER.replays))
    designs = fwd_variants()
    log("  LRN forward launches by design: %s" % designs)
    if designs != {"staged": 0, "vector": 4}:
        raise AssertionError("the forwards' LRN launches were not all the "
                             "vector design: %s" % designs)
    results["serve_lrn_fwd_variants"] = designs
    if logits.shape != (SERVE_CLIPS, CLASSES) or \
            not np.all(np.isfinite(logits)):
        raise AssertionError("logits %s finite=%s"
                             % (logits.shape, np.all(np.isfinite(logits))))
    results["main_path_launches"] = launched

    # one clip in float32: the card against the port on the CPU
    _, model32 = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                          lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                          mean_scalars=SERVING_MEAN, imgproc=SERVING_IMGPROC,
                          compute_dtype="float32")
    on_gpu = serving.ServingModule(model32, params, batch_items=1,
                                   device="cuda")(frames[:FPC], prm[:FPC])
    on_cpu = serving.ServingModule(model32, params, batch_items=1,
                                   device="cpu")(frames[:FPC], prm[:FPC])
    scale = max(1.0, float(np.abs(on_cpu).max()))
    err = float(np.abs(on_gpu - on_cpu).max())
    tol = 1e-3 * scale
    bf16_err = float(np.abs(logits[:1] - on_cpu).max())
    log("  float32 clip, card vs CPU: max abs %.3g (tolerance %.3g = 1e-3 x "
        "max(1, max|logit|)); bf16 card vs float32 CPU: %.3g"
        % (err, tol, bf16_err))
    if not err <= tol:
        raise AssertionError("card and CPU disagree: %.3g > %.3g"
                             % (err, tol))
    results["fp32_card_vs_cpu_max_abs"] = err
    results["bf16_card_vs_fp32_cpu_max_abs"] = bf16_err

    # throughput at 32 clips: device-resident inputs (the device rate),
    # then host numpy inputs (adds the uint8 host-to-device copy)
    for _ in range(2):
        module(frames_dev, prm_dev)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.monotonic()
    for _ in range(reps):
        module(frames_dev, prm_dev)
    dev_s = (time.monotonic() - t0) / reps
    t0 = time.monotonic()
    for _ in range(5):
        module(frames, prm)
    host_s = (time.monotonic() - t0) / 5
    results["forward_ms_device_inputs"] = dev_s * 1e3
    results["clips_per_s_device_inputs"] = SERVE_CLIPS / dev_s
    results["forward_ms_host_inputs"] = host_s * 1e3
    results["clips_per_s_host_inputs"] = SERVE_CLIPS / host_s
    log("  %d-clip forward: %.2f ms = %.1f clips/s (inputs on the card); "
        "%.2f ms = %.1f clips/s (uint8 numpy inputs)"
        % (SERVE_CLIPS, dev_s * 1e3, SERVE_CLIPS / dev_s, host_s * 1e3,
           SERVE_CLIPS / host_s))

    # where the device time goes in one forward
    profile_rows("one %d-clip forward" % SERVE_CLIPS,
                 lambda: module(frames_dev, prm_dev), dev_s, results,
                 "profile_kernels", top=14)
    return model, params, processor


# ------------------------------------------------------------- phase 4
def post_predict(addr, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/predict?format=npz", body=buf.getvalue(),
                     headers={"Content-Type": "application/x-npz"})
        resp = conn.getresponse()
        body = resp.read()
        dt = time.monotonic() - t0
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError("/predict answered %d: %s"
                             % (resp.status, body[:300]))
    with np.load(io.BytesIO(body)) as z:
        return z["outputs"], dt


def get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError("GET %s answered %d" % (path, resp.status))
    return body


def phase_serve(model, params, processor, results):
    log("phase 4: HTTP serving over a saved and reloaded module")
    batch_items = 8
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/flagship.zip"
        t0 = time.monotonic()
        serving.ServingModule(model, params, batch_items=batch_items,
                              device="cuda").save(path)
        module = serving.load(path, device="cuda")
        log("  save + load: %.1f s" % (time.monotonic() - t0))
    names = [s["name"] for s in module.meta["inputs"]]
    started = threading.Event()
    thread = threading.Thread(
        target=serve_mod.serve, args=(module,),
        kwargs=dict(port=0, window_ms=100.0, started=started,
                    request_timeout_s=300), daemon=True)
    thread.start()
    if not started.wait(timeout=600):
        raise AssertionError("server did not start")
    addr = started.addr
    stats = started.batcher.stats
    latencies = []
    checked = []

    def request(n_items, seed):
        frames, prm = serving_inputs(processor, n_items, seed)
        out, dt = post_predict(addr, dict(zip(names, (frames, prm))))
        latencies.append({"items": n_items, "ms": dt * 1e3})
        checked.append((n_items, out, frames, prm))

    reset_counts()
    try:
        with _PlainLockedOut():
            for seed, n_items in enumerate((1, 3, 8)):
                request(n_items, 100 + seed)
            barrier = threading.Barrier(4)
            errs = []

            def concurrent(n_items, seed):
                try:
                    barrier.wait(timeout=60)
                    request(n_items, seed)
                except BaseException as e:  # re-raised on the main thread
                    errs.append(e)

            workers = [threading.Thread(target=concurrent, args=(n, 200 + i))
                       for i, n in enumerate((1, 1, 3, 2))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=600)
            if errs or any(w.is_alive() for w in workers):
                raise AssertionError("concurrent requests failed: %s" % errs)
            metrics = get(addr, "/metrics")
            get(addr, "/healthz")
            launched = counts()
            calls = sum(stats.device_calls.values())
    finally:
        started.httpd.shutdown()
        thread.join(timeout=120)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")

    coalesced = stats.coalesced
    log("  %d requests in %d device calls, %d coalesced; launches %s"
        % (len(latencies), calls, coalesced, launched))
    for row in latencies:
        log("    request of %d items: %.1f ms" % (row["items"], row["ms"]))
    if "vlx_coalesced_batches_total %d" % coalesced not in metrics or \
            coalesced < 1:
        raise AssertionError("/metrics shows no coalesced batch:\n%s"
                             % metrics)
    if launched != {"lrn": 2 * calls, "lstm_step": FPC * LAYERS * calls}:
        raise AssertionError("serving launches %s for %d device calls"
                             % (launched, calls))
    worst = 0.0
    for n_items, out, frames, prm in checked:
        direct = module(frames, prm)
        if out.shape != (n_items, CLASSES):
            raise AssertionError("response shape %s for %d items"
                                 % (out.shape, n_items))
        worst = max(worst, float(np.abs(out - direct).max()))
    log("  served rows vs direct calls: max abs %.3g (tolerance 1e-3)"
        % worst)
    if not worst <= 1e-3:
        raise AssertionError("served rows differ from direct calls by %.3g"
                             % worst)
    results["serve"] = {"requests": latencies, "device_calls": calls,
                        "coalesced": coalesced, "launches": launched,
                        "rows_vs_direct_max_abs": worst}


# ------------------------------------------------------------- phase 5
TRAIN_KERNELS = ("lrn", "lrn_bwd", "lstm_step", "conv1_dw",
                 "conv1_dw_shifted")


def training_flagship(clips, compute_dtype, **train_kw):
    """The JAX bench.py training configuration (bench.py:54-59)."""
    kw = dict(num_classes=CLASSES, fpc=FPC, image=IMAGE,
              lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW, mean_scalars=SERVING_MEAN,
              device_preprocess=True, batch_size=clips,
              compute_dtype=compute_dtype, num_batches=1000, base_lr=0.001,
              lr_mult=None, clip_norm=10.0)
    kw.update(train_kw)
    return flagship(**kw)


def training_feed(processor, clips, seed, device):
    """Raw uint8 frames made on the device from a seed, the host-drawn
    crop/mirror parameters, one-hot labels."""
    n = clips * FPC
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(0, 256, (n,) + RAW_HW + (3,), generator=gen,
                           device=device, dtype=torch.uint8)
    labels = np.eye(CLASSES, dtype=np.int32)[
        np.random.RandomState(seed).randint(0, CLASSES, clips)]
    return {"frames_main_input": frames,
            "frames_main_input/proc_params": torch.from_numpy(
                processor.draw_params(n, random.Random(seed))).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def conv1_w(engine):
    return checkpoint.flatten_tree(engine.params)[
        "frames/dcnn/conv1/w"].detach().clone()


def locked_step(engine, feed):
    """One training step with every count at 0 just before and the plain
    versions locked out; returns (metrics, launches)."""
    reset_counts()
    with _PlainLockedOut():
        metrics = engine.run_step(dict(feed))
        torch.cuda.synchronize()
    return metrics, counts(TRAIN_KERNELS)


def phase_train(results):
    log("phase 5: full-width training step (%d clips x %d frames, bf16)"
        % (TRAIN_CLIPS, FPC))
    settings, model = training_flagship(TRAIN_CLIPS, "bfloat16")
    processor = settings.feeder.datasets[0].processor
    feed = training_feed(processor, TRAIN_CLIPS, 0, "cuda")
    t0 = time.monotonic()
    shifted = Train(settings, settings.feeder, model, seed=0, device="cuda")
    blocked = Train(settings, settings.feeder, model, seed=0, device="cuda",
                    conv1_dw="blocked")
    log("  two engines from seed 0: %.1f s" % (time.monotonic() - t0))
    w0 = conv1_w(shifted)
    t0 = time.monotonic()
    m_shift, launched = locked_step(shifted, feed)
    log("  first step %.1f s: %s; launched %s"
        % (time.monotonic() - t0, m_shift, launched))
    want = {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
            "conv1_dw": 0, "conv1_dw_shifted": 1}
    if launched != want:
        raise AssertionError("one training step launched %s, expected %s"
                             % (launched, want))
    bwd_variants = variants()
    lrn_designs = fwd_variants()
    log("  LRN forward / backward launches by design: %s / %s"
        % (lrn_designs, bwd_variants))
    if bwd_variants != {"staged": 0, "vector": 2} or \
            lrn_designs != {"staged": 0, "vector": 2}:
        raise AssertionError("the step's LRN launches were not all the "
                             "vector design: forward %s, backward %s"
                             % (lrn_designs, bwd_variants))
    if not all(math.isfinite(v) for v in m_shift.values()):
        raise AssertionError("non-finite metrics %s" % m_shift)
    m_block, launched_b = locked_step(blocked, feed)
    want_b = dict(want, conv1_dw=1, conv1_dw_shifted=0)
    log("  conv1_dw=\"blocked\" step: %s; launched %s"
        % (m_block, launched_b))
    if launched_b != want_b:
        raise AssertionError("the blocked step launched %s, expected %s"
                             % (launched_b, want_b))
    # the same start, feed and dropout: conv1 moves by -lr x (clipped) dW
    # in both.  dW is rounded to bf16 once, so the two sums' order may
    # flip one bf16 rounding (2^-8 relative) and the clip factor differs
    # by the other gradients' reassociation: rtol 2^-7, atol 1e-3 x max.
    d_s, d_b = conv1_w(shifted) - w0, conv1_w(blocked) - w0
    step_err = float((d_s - d_b).abs().max())
    if not torch.allclose(d_b, d_s, rtol=2 ** -7,
                          atol=1e-3 * float(d_s.abs().max())) or \
            float(d_s.abs().max()) == 0.0:
        raise AssertionError("conv1 steps differ: shifted vs blocked max "
                             "abs %.3g of %.3g" % (step_err,
                                                   float(d_s.abs().max())))
    log("  conv1 step, blocked vs shifted: max abs %.3g of max %.3g"
        % (step_err, float(d_s.abs().max())))
    results["train_lrn_bwd_variants"] = bwd_variants
    results["train_lrn_fwd_variants"] = lrn_designs
    results["train_launches_blocked"] = launched_b
    results["train_conv1_step_blocked_vs_shifted_max_abs"] = step_err
    del blocked

    # the main path goes on: the second step runs eagerly and then
    # captures the step's graph, the third is a replay
    feeds = [training_feed(processor, TRAIN_CLIPS, s, "cuda")
             for s in (1, 2)]
    total = dict(launched)
    for i, f in enumerate(feeds):
        metrics, launched = locked_step(shifted, f)
        designs = variants()
        lrn_designs = fwd_variants()
        log("  step %d (%s): %s; launched %s"
            % (i + 2, ("eager, then the capture", "a replay")[i], metrics,
               launched))
        if launched != want or designs != {"staged": 0, "vector": 2} or \
                lrn_designs != designs or _METER.replays != i:
            raise AssertionError("step %d launched %s (%s, %s) in %d "
                                 "replays, expected %s"
                                 % (i + 2, launched, designs, lrn_designs,
                                    _METER.replays, want))
        total = {k: total[k] + launched[k] for k in total}
    results["train_launches"] = total

    train_card_vs_cpu(results)

    # throughput: steps on a device-resident feed, host clock around
    # steps that end in a sync
    for f in feeds:
        shifted.run_step(dict(f))
    torch.cuda.synchronize()
    reps = 6
    t0 = time.monotonic()
    for i in range(reps):
        shifted.run_step(dict(feeds[i % 2]))
    torch.cuda.synchronize()
    step_s = (time.monotonic() - t0) / reps
    results["train_step_ms"] = step_s * 1e3
    results["train_clips_per_s"] = TRAIN_CLIPS / step_s
    results["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("  %d-clip training step: %.2f ms = %.1f clips/s; peak memory "
        "%.1f GB" % (TRAIN_CLIPS, step_s * 1e3, TRAIN_CLIPS / step_s,
                     results["train_peak_mem_gb"]))
    prof = profile_rows("one training step", lambda: shifted.run_step(
        dict(feeds[0])), step_s, results, "train_profile")
    n = TRAIN_CLIPS * FPC
    copies = contiguous_copies(prof, {(n,) + site for site in LRN_SITES})
    results["train_lrn_site_contiguous_copies"] = copies
    log("  aten::contiguous copies of LRN-site-shaped tensors in the "
        "profiled step: %s" % (copies or "none"))


def step_card_vs_cpu(settings, model, start, feed, what, **train_kw):
    """One float32 training step on the card and on the CPU from the same
    parameters and feed (``train_kw`` to both ``Train``s); returns (loss
    rel error, worst gradient tensor rel norm).  ``settings`` trains by SGD at lr 1 without clipping, so
    each parameter moves by exactly minus its gradient.  Dropout is off:
    the card draws its masks from the CUDA generator and the CPU from
    its own, so the two devices' masks differ by design (phase 11 holds
    the card's graphed step to its eager one with dropout on)."""
    settings.train.dropout_keep_prob = 1.0
    steps = {}
    for device in ("cuda", "cpu"):
        eng = Train(settings, settings.feeder, model, params=start,
                    device=device, **train_kw)
        before = {k: v.detach().cpu().clone() for k, v in
                  checkpoint.flatten_tree(eng.params).items()}
        metrics = eng.run_step(dict(feed))
        after = checkpoint.flatten_tree(eng.params)
        steps[device] = (metrics, {k: after[k].detach().cpu() - before[k]
                                   for k in before})
        del eng
    (m_gpu, g_gpu), (m_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    # float32 on both (TF32 off): sums run in other orders, and a relu
    # whose input lies within rounding of zero may switch on one side
    # only, which moves a few gradient elements outright; so the loss is
    # held to 1e-4 relative and each gradient tensor to 1e-2 normwise
    loss_err = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    worst = max(float((g_gpu[k] - g_cpu[k]).norm() /
                      g_cpu[k].norm().clamp_min(1e-30)) for k in g_cpu)
    log("  float32 %s, card vs CPU: loss %.7g vs %.7g (rel %.3g, tolerance "
        "1e-4); worst gradient tensor rel norm %.3g (tolerance 1e-2)"
        % (what, m_gpu["loss"], m_cpu["loss"], loss_err, worst))
    if not (loss_err <= 1e-4 and worst <= 1e-2):
        raise AssertionError("card and CPU training steps disagree")
    if any(float(g.abs().max()) == 0.0 for k, g in g_cpu.items()
           if k.endswith("/w")):
        raise AssertionError("a weight got no gradient")
    return loss_err, worst


def train_card_vs_cpu(results):
    """One float32 step at 1 clip, on the card and on the CPU."""
    settings, model = training_flagship(1, "float32", base_lr=1.0,
                                        clip_norm=None)
    processor = settings.feeder.datasets[0].processor
    loss_err, worst = step_card_vs_cpu(
        settings, model, model.init_params(seed=3, device="cpu"),
        training_feed(processor, 1, 5, "cpu"), "step at 1 clip")
    results["train_fp32_card_vs_cpu"] = {"loss_rel": loss_err,
                                         "grad_rel_norm_max": worst}


def profile_rows(what, fn, wall_s, results, key, top=16):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only (the aten rows would count their kernels twice)
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and
                   ev.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    results[key + "_kernel_us_total"] = total
    results[key] = [{"name": k, "device_us": us, "calls": n}
                    for us, k, n in rows[:30]]
    if not total:
        log("  profiler recorded no device time")
        return prof
    log("  profiler, %s: %.0f us of kernel time (%.0f%% of %.2f ms)"
        % (what, total, 100 * total / (wall_s * 1e6), wall_s * 1e3))
    for us, k, n in rows[:top]:
        log("    %8.0f us %5.1f%% x%-4d %s" % (us, 100 * us / total, n,
                                             k[:90]))
    return prof


def contiguous_copies(prof, shapes):
    """The profiled ``aten::contiguous`` calls on tensors of the given
    shapes, counted by shape and outermost enclosing event.  Each one
    copied: ``Tensor.contiguous()`` returns an already contiguous tensor
    before it reaches the dispatcher, so the profiler records none."""
    found = {}
    for ev in prof.events():
        if ev.name != "aten::contiguous" or not ev.input_shapes or \
                tuple(ev.input_shapes[0]) not in shapes:
            continue
        outer = ev
        while outer.cpu_parent is not None:
            outer = outer.cpu_parent
        key = "%s under %s" % (tuple(ev.input_shapes[0]), outer.name)
        found[key] = found.get(key, 0) + 1
    return found


# ------------------------------------------------------------- phase 6
def device_frames(processor, items, seed, device):
    """``items`` raw uint8 frames made on ``device`` from a seed, and the
    host-drawn crop/mirror parameters there too."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randint(0, 256, (items,) + RAW_HW + (3,), generator=gen,
                           device=device, dtype=torch.uint8)
    prm = torch.from_numpy(processor.draw_params(items, random.Random(seed)))
    return frames, prm.to(device)


class _RowsOf:
    """Records the batch rows of every lstm_step call the decoder makes
    (the wrapper still launches and counts)."""

    def __enter__(self):
        self.rows = []
        self.saved = decode_mod.lstm_step

        def recording(xproj, h, c, wh, b):
            self.rows.append(int(h.shape[0]))
            return self.saved(xproj, h, c, wh, b)

        decode_mod.lstm_step = recording
        return self

    def __exit__(self, *exc):
        decode_mod.lstm_step = self.saved


def caption_sizes(model):
    """(T, H) of a captioner: its word-grid length and LSTM width."""
    net = next(spec["net"] for spec in model.specs if spec["caption"])
    return model.caption_dataset.max_sequence_length, net.lstm_params[0]


def first_difference(a, b):
    """(item, step) of the first differing token of two (B, T) arrays,
    scanning items in order, or None."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        diff = np.flatnonzero(ra != rb)
        if diff.size:
            return i, int(diff[0])
    return None


def decode_margins(model, params, feed, eos):
    """Greedy (with its per-step logits) and beam-BEAM decodes of the
    preprocessed ``feed`` through the decoder on ``Model.decoder_inputs``,
    with the tie tests of phase 6's rule: ``tie_greedy(i, t)``, whether
    item i's top-2 logit margin at step t lies within 1e-4 x max(1,
    max|logit|), and ``tie_beam(i, t)``, whether the least gap among
    its K + 1 best candidate scores up to step t lies within 1e-4 of
    their scale."""
    args = model.decoder_inputs(params, feed)
    ids, logits = decode_mod.greedy_decode(
        **args, return_type=defs.return_type.standard)
    margins = []
    top_k = decode_mod._top_k

    def recording(x, k):
        vals = torch.sort(x, dim=1, descending=True).values[:, :k + 1]
        gaps = (vals[:, :-1] - vals[:, 1:]).min(dim=1).values
        scale = vals.abs().max(dim=1).values.clamp(min=1.0)
        margins.append((gaps / scale).cpu().numpy())
        return top_k(x, k)

    decode_mod._top_k = recording
    try:
        beam = decode_mod.beam_decode(eos_index=eos, beam_width=BEAM,
                                      **args)
    finally:
        decode_mod._top_k = top_k
    logits = logits.cpu().numpy()
    margins = np.stack(margins, axis=1)
    top2 = np.sort(logits, axis=-1)[..., -2:]

    def tie_greedy(i, t):
        margin = top2[i, t, 1] - top2[i, t, 0]
        limit = 1e-4 * max(1.0, float(np.abs(logits[i, t]).max()))
        log("  greedy step %d of item %d: reference top-2 margin %.3g "
            "(limit %.3g)" % (t, i, margin, limit))
        return margin < limit

    def tie_beam(i, t):
        least = float(margins[i, :t + 1].min())
        log("  beam item %d: least reference top-K gap up to step %d: "
            "%.3g (limit 1e-4)" % (i, t, least))
        return least < 1e-4

    return {"greedy": ids.cpu().numpy(), "logits": logits,
            "beam": beam.cpu().numpy(), "margins": margins,
            "tie_greedy": tie_greedy, "tie_beam": tie_beam}


def caption_card_vs_cpu(params_cpu, results):
    """Greedy and beam-4 decodes of 2 items in float32 on the card and on
    the CPU from the same parameters and frames, each through
    ``Model.apply(decode=True)`` and through the decoder called on
    ``Model.decoder_inputs`` (greedy with return_type standard for its
    logits, beam recording its candidate scores).  On the CPU the two
    routes give the same tokens.  Card and CPU tokens must be equal on
    both routes, except from a step where the CPU's choice lies within
    1e-4 x max(1, max|value|) of a tie (its top-2 logit margin for
    greedy, the least gap among its K + 1 best candidate scores for beam;
    for beam any step up to the first differing token counts, since a
    different choice may show in the best beam's tokens only later).
    Greedy logits agree to 1e-3 x max(1, max|logit|) up to the first
    differing step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings, model = caption_flagship(batch_size=2,
                                       compute_dtype="float32")
    dset = model.caption_dataset
    eos = dset.vocabulary.index("EOS")
    frames, prm = device_frames(dset.processor, 2, 11, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = serving._to_device(params_cpu, device)
        pre = make_preprocessor(dset.processor, out_dtype=torch.float32,
                                device=device)
        feed = {"frames_main_input": pre(frames.to(device),
                                         prm.to(device))}
        ref = decode_margins(model, params, feed, eos)
        applied = {}
        settings.captioning.beam_width = BEAM
        for search in ("max", "beam"):
            settings.captioning.caption_search = search
            applied[search] = model.apply(params, feed,
                                          decode=True).cpu().numpy()
        settings.captioning.caption_search = "max"
        out[device] = dict(ref, **{"apply greedy": applied["max"],
                                   "apply beam": applied["beam"]})
    card, cpu = out["cuda"], out["cpu"]
    if not (np.array_equal(cpu["apply greedy"], cpu["greedy"]) and
            np.array_equal(cpu["apply beam"], cpu["beam"])):
        raise AssertionError("on the CPU Model.apply(decode=True) decodes "
                             "other tokens than the decoder called on "
                             "Model.decoder_inputs")
    c_logits, c_marg = cpu["logits"], cpu["margins"]
    top2 = np.sort(c_logits, axis=-1)[..., -2:]
    greedy_tie, beam_tie = cpu["tie_greedy"], cpu["tie_beam"]
    report = {"greedy_min_cpu_margin": float((top2[..., 1] -
                                              top2[..., 0]).min()),
              "beam_min_cpu_margin": float(c_marg.min())}
    for key, tie in (("greedy", greedy_tie), ("apply greedy", greedy_tie),
                     ("beam", beam_tie), ("apply beam", beam_tie)):
        diff = first_difference(card[key], cpu[key])
        report[key.replace(" ", "_") + "_first_difference"] = diff
        log("  float32, 2 items, card vs CPU, %s%s: tokens %s"
            % (key, "-%d" % BEAM if key.endswith("beam") else "",
               "equal" if diff is None else
               "differ first at item %d step %d" % diff))
        if diff is not None and not tie(*diff):
            raise AssertionError("%s tokens differ at a decided step"
                                 % key)
    diff = report["greedy_first_difference"]
    upto = card["greedy"].shape[1] if diff is None else diff[1] + 1
    scale = max(1.0, float(np.abs(c_logits).max()))
    err = float(np.abs(card["logits"][:, :upto] -
                       c_logits[:, :upto]).max())
    report["greedy_logits_max_abs"] = err
    log("  greedy logits up to step %d max abs %.3g (tolerance %.3g); "
        "least CPU top-2 margin %.3g; least CPU top-K gap %.3g (relative)"
        % (upto - 1, err, 1e-3 * scale, report["greedy_min_cpu_margin"],
           report["beam_min_cpu_margin"]))
    if not err <= 1e-3 * scale:
        raise AssertionError("greedy logits disagree: %.3g" % err)
    results["caption_fp32_card_vs_cpu"] = report


def timed_s(fn, reps):
    """Mean seconds per call on the host clock around calls that end in a
    sync, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t0) / reps


def phase_caption(results):
    settings, model = caption_flagship(batch_size=CAPTION_ITEMS)
    dset = model.caption_dataset
    T, H = caption_sizes(model)
    log("phase 6: captioning at full width (%d items, vocabulary %d, T %d, "
        "1x%d LSTM, %s)" % (CAPTION_ITEMS, len(dset.vocabulary), T, H,
                            settings.compute_dtype))
    t0 = time.monotonic()
    params_cpu = model.init_params(seed=0, device="cpu")
    params = serving._to_device(params_cpu, "cuda")
    log("  init (torch.Generator seed 0): %.1f s" % (time.monotonic() - t0))
    pre = make_preprocessor(dset.processor, out_dtype=model.compute_dtype,
                            device="cuda")
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 0, "cuda")

    def decode(n=CAPTION_ITEMS):
        return model.apply(params, {"frames_main_input":
                                    pre(frames[:n], prm[:n])}, decode=True)

    decode(1)                               # first call: lazy set-up
    torch.cuda.synchronize()
    want = {"lrn": 2, "lstm_step": T}
    launched = {}
    for search in ("max", "beam"):
        settings.captioning.caption_search = search
        settings.captioning.beam_width = BEAM
        reset_counts()
        with _PlainLockedOut(), _RowsOf() as rows:
            ids = decode()
            torch.cuda.synchronize()
        launched[search] = counts()
        log("  one %s decode of %d items launched %s; lstm_step rows %s"
            % ("greedy" if search == "max" else "beam-%d" % BEAM,
               CAPTION_ITEMS, launched[search], sorted(set(rows.rows))))
        rows_want = CAPTION_ITEMS * (BEAM if search == "beam" else 1)
        if launched[search] != want or set(rows.rows) != {rows_want}:
            raise AssertionError("%s decode launched %s at rows %s, "
                                 "expected %s at %d rows"
                                 % (search, launched[search],
                                    sorted(set(rows.rows)), want,
                                    rows_want))
        ids = ids.cpu().numpy()
        if ids.shape != (CAPTION_ITEMS, T) or \
                ids.dtype != np.int32 or ids.min() < 0 or \
                ids.max() >= len(dset.vocabulary):
            raise AssertionError("decoded ids %s %s in [%d, %d]"
                                 % (ids.shape, ids.dtype, ids.min(),
                                    ids.max()))
    results["caption_decode_launches"] = launched

    caption_card_vs_cpu(params_cpu, results)

    # times: inputs on the card, host clock around calls ending in a sync
    settings.captioning.caption_search = "max"
    greedy, idle = {}, {}
    for n in (1, 8, 32, CAPTION_ITEMS):
        sec = timed_s(lambda: decode(n), 20)
        greedy[n] = n / sec
        log("  greedy decode of %2d items: %.2f ms = %.1f captions/s"
            % (n, sec * 1e3, n / sec))
        # where the time goes: kernel rows of one profiled decode
        prof = {}
        profile_rows("one greedy decode of %d items" % n,
                     lambda: decode(n), sec, prof, "p",
                     top=12 if n == CAPTION_ITEMS else 4)
        idle[n] = 1.0 - prof["p_kernel_us_total"] / (sec * 1e6)
        log("  the card is idle %.0f%% of a greedy decode of %d items (1 - "
            "kernel time / wall time)" % (100 * idle[n], n))
    results["caption_greedy_captions_per_s"] = greedy
    results["caption_greedy_profile"] = prof["p"]
    results["caption_greedy_idle_share"] = idle
    settings.captioning.caption_search = "beam"
    sec = timed_s(decode, 5)
    results["caption_beam_captions_per_s"] = CAPTION_ITEMS / sec
    log("  beam-%d decode of %d items: %.2f ms = %.1f captions/s"
        % (BEAM, CAPTION_ITEMS, sec * 1e3, CAPTION_ITEMS / sec))
    prof = {}
    profile_rows("one beam-%d decode of %d items" % (BEAM, CAPTION_ITEMS),
                 decode, sec, prof, "p", top=8)
    results["caption_beam_profile"] = prof["p"]
    results["caption_beam_idle_share"] = \
        1.0 - prof["p_kernel_us_total"] / (sec * 1e6)
    settings.captioning.caption_search = "max"

    phase_caption_serve(model, params, dset, results)
    del params
    torch.cuda.empty_cache()
    phase_caption_train(settings, model, params_cpu, results)
    torch.cuda.empty_cache()
    caption_train_card_vs_cpu(params_cpu, results)


def caption_train_card_vs_cpu(params_cpu, results):
    """One float32 caption training step of 2 captions (the 1xH LSTM's
    backward over T steps, the vocabulary-wide head), on the card and on
    the CPU, held as phase 5's step is."""
    settings, model = caption_flagship(batch_size=2,
                                       compute_dtype="float32")
    settings.train.base_lr, settings.train.clip_norm = 1.0, None
    loss_err, worst = step_card_vs_cpu(
        settings, model, params_cpu,
        caption_train_feed(settings, model, 5, "cpu"),
        "caption training step of 2 captions")
    results["caption_train_fp32_card_vs_cpu"] = {
        "loss_rel": loss_err, "grad_rel_norm_max": worst}


def caption_train_feed(settings, model, seed, device):
    """bench.py's caption feed: ``flagship.caption_feed``'s word grid and
    scattered labels on ``device``, with raw uint8 frames made there and
    crop/mirror parameters for the device preprocessing."""
    feed = {k: torch.from_numpy(v).to(device) for k, v in
            caption_feed(settings, model, seed).items()
            if k != "frames_main_input"}
    frames, prm = device_frames(model.caption_dataset.processor,
                                 settings.train.batch_size, seed, device)
    feed["frames_main_input"] = frames
    feed["frames_main_input/proc_params"] = prm
    return feed


def phase_caption_train(settings, model, params_cpu, results):
    engine = Train(settings, settings.feeder, model, params=params_cpu,
                   device="cuda")
    feed = caption_train_feed(settings, model, 0, "cuda")
    t0 = time.monotonic()
    metrics, launched = locked_step(engine, feed)
    log("  first caption training step %.1f s: %s; launched %s"
        % (time.monotonic() - t0, metrics, launched))
    want = {"lrn": 2, "lrn_bwd": 2, "lstm_step": caption_sizes(model)[0],
            "conv1_dw": 0, "conv1_dw_shifted": 1}
    designs = variants()
    if launched != want or designs != {"staged": 0, "vector": 2}:
        raise AssertionError("one caption training step launched %s (LRN "
                             "backward designs %s), expected %s, both "
                             "vector" % (launched, designs, want))
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError("non-finite metrics %s" % metrics)
    results["caption_train_launches"] = launched
    feeds = [feed, caption_train_feed(settings, model, 1, "cuda")]
    step = [0]

    def run():
        engine.run_step(dict(feeds[step[0] % 2]))
        step[0] += 1

    sec = timed_s(run, 6)
    results["caption_train_step_ms"] = sec * 1e3
    results["caption_train_captions_per_s"] = CAPTION_ITEMS / sec
    log("  %d-caption training step: %.2f ms = %.1f captions/s"
        % (CAPTION_ITEMS, sec * 1e3, CAPTION_ITEMS / sec))
    prof = {}
    profile_rows("one caption training step", run, sec, prof, "p", top=10)
    results["caption_train_profile"] = prof["p"]
    results["caption_train_idle_share"] = \
        1.0 - prof["p_kernel_us_total"] / (sec * 1e6)


def phase_caption_serve(model, params, dset, results):
    """One /predict to tools/serve over a saved and reloaded caption
    module: its "captions" are those of a direct call."""
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/caption.zip"
        serving.ServingModule(model, params, batch_items=8,
                              device="cuda").save(path)
        module = serving.load(path, device="cuda")
    frames, prm = device_frames(dset.processor, 2, 21, "cpu")
    frames, prm = frames.numpy(), prm.numpy()
    direct = module.captions_from_ids(module(frames, prm))
    started = threading.Event()
    thread = threading.Thread(
        target=serve_mod.serve, args=(module,),
        kwargs=dict(port=0, window_ms=5.0, started=started,
                    request_timeout_s=300), daemon=True)
    thread.start()
    if not started.wait(timeout=600):
        raise AssertionError("caption server did not start")
    try:
        buf = io.BytesIO()
        np.savez(buf, frames_main_input=frames,
                 **{"frames_main_input/proc_params": prm})
        conn = http.client.HTTPConnection(*started.addr, timeout=300)
        try:
            conn.request("POST", "/predict", body=buf.getvalue(),
                         headers={"Content-Type": "application/x-npz"})
            resp = conn.getresponse()
            status, body = resp.status, resp.read()
        finally:
            conn.close()
    finally:
        started.httpd.shutdown()
        thread.join(timeout=120)
    if thread.is_alive():
        raise AssertionError("caption server thread did not stop")
    if status != 200:
        raise AssertionError("/predict answered %d: %s" % (status,
                                                         body[:300]))
    got = json.loads(body)
    log("  /predict on the reloaded caption module: %s" % got["captions"])
    if got["captions"] != direct or "topk" in got:
        raise AssertionError("served captions %s differ from a direct "
                             "call's %s" % (got["captions"], direct))
    results["caption_served"] = got["captions"]


# ------------------------------------------------------------- phase 7
INT8_COUNTED = ("lrn", "lstm_step", "int8_mm")


def locked_counts(fn, want, what):
    """Run ``fn`` once with the plain versions locked out; its launches of
    the LRN, lstm_step and int8 GEMM wrappers must be ``want``."""
    reset_counts()
    with _PlainLockedOut():
        out = fn()
        torch.cuda.synchronize()
    launched = counts(INT8_COUNTED)
    log("  %s launched %s" % (what, launched))
    if launched != want:
        raise AssertionError("%s launched %s, expected %s"
                             % (what, launched, want))
    return out, launched


def int_mm_refusals():
    """Which of the shapes the int8 serving path meets torch._int_mm
    itself refuses on the card (the reason ops/int8_mm.py pads)."""
    found = {}
    for what, m, k, n in (("16 rows", 16, 64, 64), ("K 20", 32, 20, 64),
                          ("N 101", 32, 64, 101), ("17 rows", 17, 64, 64),
                          ("24 rows", 24, 64, 64), ("32 rows", 32, 64, 64),
                          ("17 x 9216 x 4096", 17, 9216, 4096),
                          ("729 x 1200 x 128", 729, 1200, 128),
                          ("736 x 1200 x 128", 736, 1200, 128)):
        a = torch.ones((m, k), dtype=torch.int8, device="cuda")
        b = torch.ones((k, n), dtype=torch.int8, device="cuda")
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            found[what] = "taken"
        except RuntimeError as e:      # recorded: the check under test
            found[what] = "refused: %s" % str(e).splitlines()[0][:80]
    log("  torch._int_mm on the card: %s" % found)
    return found


def int8_layer_table(dcnn, x, results):
    """Each int8 layer of a forward of x (dynamic scales) against the
    layer it replaces: the activation quantize, the im2col copies and the
    int8 GEMMs (each GEMM held to the plain exact product), the whole
    int8 layer, and the bf16 cuDNN conv / float32-accumulated fc of the
    bf16 forward; device ms from CUDA events around back-to-back calls,
    bounds = max(bytes / 3.35 TB/s, operations / 1979 TOPS)."""
    q = alexnet.quantize_params(dcnn)
    inputs = {}

    def conv(name, inp):
        inputs[name] = inp
        strides, groups = alexnet._conv_stride_groups(name)
        return layers.conv_apply_int8(q[name], inp, strides, "SAME",
                                      groups=groups)

    def fc(name, inp):
        inputs[name] = inp
        return layers.fc_apply_int8(q[name], inp)

    with torch.inference_mode():
        alexnet._forward(dcnn, x, "fc7", torch.bfloat16,
                         alexnet._SERVING_CONV1, conv, fc)
        rows = []
        for name, inp in inputs.items():
            rows.append(int8_layer_row(name, dcnn, q, inp))
    total = {k: sum(r[k] for r in rows) for k in
             ("quantize_ms", "im2col_ms", "gemm_ms", "int8_ms",
              "replaced_ms", "gemm_bound_ms", "im2col_bound_ms",
              "gemm_colmajor_b_ms")}
    log("  int8 layers of a %d-frame forward (device ms; dynamic scales):"
        % x.shape[0])
    log("    %-6s %8s %8s %8s %8s %8s | %8s %8s %8s | %8s %s"
        % ("layer", "quant", "im2col", "gemm", "int8", "bf16", "gemm_bd",
           "im2c_bd", "gemm_err", "gemm_TN", "TN result"))
    for r in rows + [dict(total, layer="total", gemm_max_abs_err=0,
                          gemm_colmajor_b="")]:
        log("    %-6s %8.3f %8.3f %8.3f %8.3f %8.3f | %8.3f %8.3f %8g | "
            "%8.3f %s"
            % (r["layer"], r["quantize_ms"], r["im2col_ms"], r["gemm_ms"],
               r["int8_ms"], r["replaced_ms"], r["gemm_bound_ms"],
               r["im2col_bound_ms"], r["gemm_max_abs_err"],
               r["gemm_colmajor_b_ms"], r["gemm_colmajor_b"]))
    if any(r["gemm_max_abs_err"] != 0 for r in rows):
        raise AssertionError("an int8 GEMM differs from the exact product")
    results["int8_layers"] = rows
    results["int8_layers_total"] = total


def int8_layer_row(name, dcnn, q, inp):
    iters = 10
    xq, _ = layers.quantize_sym(inp, None)
    row = {"layer": name,
           "quantize_ms": eager_ms(lambda: layers.quantize_sym(inp, None),
                                   iters),
           "im2col_ms": 0.0, "gemm_ms": 0.0, "gemm_bound_ms": 0.0,
           "im2col_bound_ms": 0.0, "gemm_max_abs_err": 0}
    if name.startswith("conv"):
        strides, groups = alexnet._conv_stride_groups(name)
        wq = q[name]["wq"]
        cin_g, kh, kw = wq.shape[1:]
        pads = (layers.same_pads(inp.shape[1], kh, 1),
                layers.same_pads(inp.shape[2], kw, 1))
        pairs = []
        for g in range(groups):
            chans = (g * cin_g, (g + 1) * cin_g)
            row["im2col_ms"] += eager_ms(
                lambda: layers.im2col_int8(xq, kh, kw, strides, pads, chans),
                iters)
            cols = layers.im2col_int8(xq, kh, kw, strides, pads, chans)[0]
            row["im2col_bound_ms"] += bound_ms(
                xq.numel() // groups + cols.numel(), 0)[0]
            pairs.append((cols, layers.int8_weight_matrix(wq, groups, g)))
        row["int8_ms"] = eager_ms(lambda: layers.conv_apply_int8(
            q[name], inp, strides, "SAME", groups=groups), iters)
        row["replaced_ms"] = eager_ms(lambda: layers.conv_apply(
            dcnn[name], inp, strides, "SAME", groups=groups,
            compute_dtype=torch.bfloat16), iters)
        row["replaced"] = "cuDNN bf16 conv"
    else:
        pairs = [(xq, q[name]["wq"])]
        row["int8_ms"] = eager_ms(lambda: layers.fc_apply_int8(q[name], inp),
                                  iters)
        row["replaced_ms"] = eager_ms(lambda: layers.fc_apply(
            dcnn[name], inp, torch.bfloat16), iters)
        row["replaced"] = "bf16-rounded float32 GEMM"
    row["gemm_colmajor_b_ms"], row["gemm_colmajor_b"] = 0.0, "exact"
    for a, b in pairs:
        row["gemm_ms"] += eager_ms(lambda: int8_mod.int8_mm(a, b), iters)
        # a probe for later work, not on the port's path: the same GEMM
        # with B column-major (cuBLASLt's TN layout); recorded, not held
        b_cm = b.t().contiguous().t()
        try:
            row["gemm_colmajor_b_ms"] += eager_ms(
                lambda: torch._int_mm(a, b_cm), iters)
            if not torch.equal(torch._int_mm(a, b_cm),
                               int8_mod.int8_mm(a, b)):
                row["gemm_colmajor_b"] = "differs"
        except RuntimeError as e:       # recorded: a probe, not a check
            row["gemm_colmajor_b"] = "refused: %s" % str(e)[:60]
        m, k = a.shape
        n = b.shape[1]
        row["gemm_bound_ms"] += bound_ms(m * k + k * n + 4 * m * n,
                                         2 * m * n * k,
                                         PEAK_INT8_OPS_PER_S)[0]
        err = (int8_mod.int8_mm(a, b) -
               int8_mod.int8_mm_reference(a, b)).abs().max()
        row["gemm_max_abs_err"] = max(row["gemm_max_abs_err"], int(err))
    row["gemm_shapes"] = [[int(a.shape[0]), int(a.shape[1]),
                           int(b.shape[1])] for a, b in pairs]
    return row


class _Quantizations:
    """Records the int8 activations (xq, xs) that each int8 layer of a
    forward computes, in call order; or, given such a record
    (``forced``), makes each layer take the recorded ones in place of its
    own and reports, per layer, the elements whose own rounding on the
    recorded grid differs (flips) and how far the largest such input lay
    from a rounding tie, in grid steps."""

    def __init__(self, forced=None):
        self.forced = forced
        self.taken = []
        self.report = []

    def __enter__(self):
        self.saved = layers._int8_input

        def hook(params, x):
            if self.forced is None:
                xq, xs = self.saved(params, x)
                self.taken.append((xq.cpu(), xs.cpu()))
                return xq, xs
            fq, fs = self.forced[len(self.report)]
            t = x.to(torch.float32) / fs
            flipped = torch.round(t).clamp(-127, 127).to(torch.int8) != fq
            tie = (t - t.floor() - 0.5).abs()[flipped]
            self.report.append({
                "flips": int(flipped.sum()), "elements": fq.numel(),
                "max_tie_distance": float(tie.max()) if tie.numel() else 0})
            return fq, fs

        layers._int8_input = hook
        return self

    def __exit__(self, *exc):
        layers._int8_input = self.saved


def forced_card_vs_cpu(run, what):
    """``run(device)`` on the card, then on the CPU twice: as it is, and
    with each int8 layer taking the card's int8 activations (the rounding
    decisions) in place of its own.  A float32 rounding difference at
    conv1 moves an int8 activation across a .5 step of its grid now and
    then, and such a flip moves the logits by more than 1e-3 (the
    unforced spread is printed).  So the card is held to the forced CPU
    run, and every flip to a near tie: each input the CPU would round
    otherwise lies within 1e-3 grid steps of a tie.  Returns (card,
    forced CPU, unforced CPU) outputs as numpy, and the flip report."""
    with _Quantizations() as card:
        on_card = run("cuda")
    with _Quantizations(card.taken) as forced:
        on_cpu = run("cpu")
    free = run("cpu")
    flips = forced.report
    log("  %s: flips per int8 layer on the card's grid (CPU input vs card "
        "activation) %s, farthest from a tie %.3g steps"
        % (what, [f["flips"] for f in flips],
           max(f["max_tie_distance"] for f in flips)))
    if len(flips) != len(card.taken) or \
            not all(f["max_tie_distance"] < 1e-3 for f in flips):
        raise AssertionError("%s: an int8 activation differs card vs CPU "
                             "away from a rounding tie: %s" % (what, flips))
    return on_card, on_cpu, free, flips


def int8_card_vs_cpu(params_cpu, processor, results):
    """One clip of float32 int8 and int8_static logits on the card and on
    the CPU, from the same module (the static one with ranges calibrated
    once, on the CPU), held by ``forced_card_vs_cpu``: the card within
    1e-3 x max(1, max|logit|) of the CPU run that takes the card's int8
    activations.  One clip is 16 rows into fc6, which the card's GEMM
    takes only padded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, model32 = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                          lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                          mean_scalars=SERVING_MEAN, imgproc=SERVING_IMGPROC,
                          compute_dtype="float32")
    frames, prm = device_frames(processor, FPC, 72, "cpu")
    calib = device_frames(processor, 2 * FPC, 73, "cpu")
    ranges = serving.ServingModule(
        model32, params_cpu, batch_items=2, device="cpu",
        quantize="int8_static", calib_feed=calib).meta["act_ranges"]
    report = {}
    for mode in INT8_MODES:
        kw = dict(quantize=mode, act_ranges=ranges
                  if mode == "int8_static" else None)
        # eager on the card too: the record of int8 activations reads
        # each layer's back to the host, which no graph can hold
        mods = {dev: serving.ServingModule(model32, params_cpu,
                                           batch_items=1, device=dev,
                                           graphs=False, **kw)
                for dev in ("cuda", "cpu")}
        card, cpu, free, flips = forced_card_vs_cpu(
            lambda dev: mods[dev](frames, prm), "float32 %s clip" % mode)
        scale = max(1.0, float(np.abs(cpu).max()))
        err = float(np.abs(card - cpu).max())
        spread = float(np.abs(card - free).max())
        log("  float32 %s clip, card vs CPU on the card's int8 activations: "
            "max abs %.3g (tolerance %.3g = 1e-3 x max(1, max|logit|)); "
            "card vs CPU on its own: %.3g" % (mode, err, 1e-3 * scale,
                                              spread))
        if not err <= 1e-3 * scale:
            raise AssertionError("%s: card and CPU disagree: %.3g" % (mode,
                                                                      err))
        report[mode] = {"max_abs": err, "unforced_max_abs": spread,
                        "flips": flips}
    results["int8_fp32_card_vs_cpu"] = report


def phase_int8(results):
    log("phase 7: int8 serving at full width (%d classes, fpc %d, bf16 "
        "conv1, w8a8 conv2..fc7, buckets %s)" % (CLASSES, FPC,
                                                list(INT8_CLIPS)))
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                               lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                               mean_scalars=SERVING_MEAN,
                               imgproc=SERVING_IMGPROC,
                               compute_dtype="bfloat16")
    processor = settings.feeder.datasets[0].processor
    params_cpu = model.init_params(seed=0, device="cpu")
    params = serving._to_device(params_cpu, "cuda")
    results["int_mm_shape_checks"] = int_mm_refusals()
    calib = device_frames(processor, INT8_CALIB_CLIPS * FPC, 70, "cuda")
    frames, prm = device_frames(processor, max(INT8_CLIPS) * FPC, 71,
                                "cuda")
    t0 = time.monotonic()
    modules = {mode: serving.ServingModule(
        model, params, batch_items=list(INT8_CLIPS), device="cuda",
        quantize=mode, calib_feed=calib if mode == "int8_static" else None)
        for mode in (None,) + INT8_MODES}
    log("  bf16, int8 and int8_static modules built in %.1f s; int8_static "
        "ranges (calibrated on %d clips): %s"
        % (time.monotonic() - t0, INT8_CALIB_CLIPS,
           modules["int8_static"].meta["act_ranges"]))
    results["int8_static_act_ranges"] = \
        modules["int8_static"].meta["act_ranges"]

    # launch counts with the plain versions locked out, at 1 clip (fc6
    # takes 16 rows, padded) and at SERVE_CLIPS
    want = {"lrn": 2, "lstm_step": FPC * LAYERS,
            "int8_mm": INT8_MM_PER_FORWARD}
    n32 = SERVE_CLIPS * FPC
    bf16 = modules[None](frames[:n32], prm[:n32])
    scale = float(np.abs(bf16).max())
    launched, deltas = {}, {}
    for mode in INT8_MODES:
        mod = modules[mode]
        for clips in (1, SERVE_CLIPS):
            n = clips * FPC
            out, launched[mode] = locked_counts(
                lambda: mod(frames[:n], prm[:n]), want,
                "one %s forward of %d clips" % (mode, clips))
            if out.shape != (clips, CLASSES) or \
                    not np.all(np.isfinite(out)):
                raise AssertionError("%s logits %s" % (mode, out.shape))
        # int8 against bf16 on the card: quantization did something, and
        # not too much (the JAX multichip dryrun's check)
        delta = float(np.abs(out - bf16).max())
        log("  %s vs bf16, %d clips: max |delta logit| %.4g, bf16 logit "
            "scale %.4g (need 0 < delta < 50%% of it)"
            % (mode, SERVE_CLIPS, delta, scale))
        if not 0 < delta < 0.5 * scale:
            raise AssertionError("%s delta %.4g outside (0, %.4g)"
                                 % (mode, delta, 0.5 * scale))
        deltas[mode] = delta
    results["int8_launches"] = launched
    results["int8_vs_bf16_max_abs"] = deltas
    results["int8_bf16_logit_scale"] = scale

    int8_card_vs_cpu(params_cpu, processor, results)

    # clips/s, inputs on the card; peak memory at the largest batch
    rates, peaks = {}, {}
    for mode in (None,) + INT8_MODES:
        name = mode or "bf16"
        mod = modules[mode]
        for clips, reps in zip(INT8_CLIPS, (20, 10, 5)):
            n = clips * FPC
            sec = timed_s(lambda: mod(frames[:n], prm[:n]), reps)
            rates["%s@%d" % (name, clips)] = clips / sec
            log("  %-11s forward of %3d clips: %8.3f ms = %9.1f clips/s"
                % (name, clips, sec * 1e3, clips / sec))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mod(frames, prm)
        peaks[name] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "resident_gb": resident / 1e9}
        log("  %-11s at %d clips: peak memory %.2f GB (%.2f GB resident "
            "before the call)" % (name, max(INT8_CLIPS),
                                  peaks[name]["peak_gb"],
                                  peaks[name]["resident_gb"]))
    results["int8_clips_per_s"] = rates
    results["int8_peak_memory"] = peaks

    # where the time goes at SERVE_CLIPS: kernels by name, the card's
    # idle share, and each int8 layer against the layer it replaces
    for mode in (None, "int8"):
        mod = modules[mode]
        name = mode or "bf16"
        sec = SERVE_CLIPS / rates["%s@%d" % (name, SERVE_CLIPS)]
        prof = {}
        profile_rows("one %d-clip %s forward" % (SERVE_CLIPS, name),
                     lambda: mod(frames[:n32], prm[:n32]), sec, prof, "p",
                     top=14)
        idle = 1.0 - prof["p_kernel_us_total"] / (sec * 1e6)
        log("  the card is idle %.0f%% of a %d-clip %s forward"
            % (100 * idle, SERVE_CLIPS, name))
        results["int8_profile_" + name] = prof["p"]
        results["int8_idle_share_" + name] = idle
    pre = make_preprocessor(processor, out_dtype=torch.bfloat16,
                            device="cuda")
    int8_layer_table(params["frames"]["dcnn"], pre(frames[:n32], prm[:n32]),
                     results)
    del modules
    torch.cuda.empty_cache()
    phase_int8_serve(model, params, processor, calib, results)
    del params
    torch.cuda.empty_cache()
    phase_int8_caption(results)


def phase_int8_serve(model, params, processor, calib, results):
    """An int8_static module with buckets [1, 8, 32] saved and reloaded;
    a 1-item /predict runs at bucket 1 and answers a direct call's rows;
    the loopback selftest at 1 and 8 items per request."""
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/int8_static.zip"
        made = serving.ServingModule(model, params, batch_items=[1, 8, 32],
                                     device="cuda", quantize="int8_static",
                                     calib_feed=calib)
        made.save(path)
        module = serving.load(path, device="cuda")
    if module.meta != made.meta:
        raise AssertionError("reloaded meta differs")
    frames, prm = device_frames(processor, FPC, 74, "cpu")
    frames, prm = frames.numpy(), prm.numpy()
    direct = module(frames, prm)
    reload_err = float(np.abs(direct - made(frames, prm)).max())
    if module.last_bucket != 1 or not reload_err <= 1e-3:
        raise AssertionError("reloaded module: bucket %s, rows differ by "
                             "%.3g" % (module.last_bucket, reload_err))
    names = [s["name"] for s in module.meta["inputs"]]
    started = threading.Event()
    thread = threading.Thread(
        target=serve_mod.serve, args=(module,),
        kwargs=dict(port=0, window_ms=5.0, started=started,
                    request_timeout_s=300), daemon=True)
    thread.start()
    if not started.wait(timeout=600):
        raise AssertionError("int8 server did not start")
    try:
        out, dt = post_predict(started.addr, dict(zip(names, (frames, prm))))
        calls = dict(started.batcher.stats.device_calls)
        metrics = get(started.addr, "/metrics")
    finally:
        started.httpd.shutdown()
        thread.join(timeout=120)
    if thread.is_alive():
        raise AssertionError("int8 server thread did not stop")
    err = float(np.abs(out - direct).max())
    log("  reloaded int8_static module (buckets %s): 1-item /predict %.1f "
        "ms at buckets %s, rows vs a direct call max abs %.3g (reload vs "
        "made %.3g)" % (module.meta["buckets"], dt * 1e3, calls, err,
                        reload_err))
    if calls != {1: 1} or 'vlx_device_calls_total{bucket="1"} 1' not in \
            metrics or not err <= 1e-3:
        raise AssertionError("1-item /predict: device calls %s, rows differ "
                             "by %.3g" % (calls, err))
    rows = serve_mod.selftest(module, item_counts=(1, 8), duration_s=1.5,
                              concurrency=8, window_ms=3.0)
    for r in rows:
        log("  selftest %d items/request: %.1f requests/s, %.1f items/s, "
            "p50 %.1f ms, p99 %.1f ms, %d errors"
            % (r["items_per_request"], r["rps"], r["items_per_sec"],
               r["p50_ms"], r["p99_ms"], r["errors"]))
        if r["errors"] or not r["requests"]:
            raise AssertionError("selftest row %s" % r)
    results["int8_serve"] = {"predict_ms": dt * 1e3, "device_calls": calls,
                             "rows_vs_direct_max_abs": err,
                             "selftest": rows}


def phase_int8_caption(results):
    """The captioner's frame encoder in int8, the decode in float32: a
    greedy decode of 64 items launches lrn 2, lstm_step T and the 9 int8
    GEMMs with the plain versions locked out; int8 and bf16 greedy
    captions/s at 64 items; 2 items in float32 card vs CPU."""
    settings, model = caption_flagship(batch_size=CAPTION_ITEMS)
    dset = model.caption_dataset
    T, _ = caption_sizes(model)
    params_cpu = model.init_params(seed=0, device="cpu")
    params = serving._to_device(params_cpu, "cuda")
    qparams = model.quantize_params(params)
    pre = make_preprocessor(dset.processor, out_dtype=model.compute_dtype,
                            device="cuda")
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 0, "cuda")

    def decode(p, quantize, n=CAPTION_ITEMS):
        return model.apply(p, {"frames_main_input": pre(frames[:n], prm[:n])},
                           decode=True, quantize=quantize)

    decode(qparams, "int8", 1)              # first call: lazy set-up
    ids, launched = locked_counts(
        lambda: decode(qparams, "int8"),
        {"lrn": 2, "lstm_step": T, "int8_mm": INT8_MM_PER_FORWARD},
        "one int8 greedy decode of %d items" % CAPTION_ITEMS)
    ids = ids.cpu().numpy()
    if ids.shape != (CAPTION_ITEMS, T) or ids.dtype != np.int32 or \
            ids.min() < 0 or ids.max() >= len(dset.vocabulary):
        raise AssertionError("int8 decoded ids %s %s" % (ids.shape,
                                                         ids.dtype))
    results["int8_caption_launches"] = launched
    rates = {}
    for name, p, quantize in (("bf16", params, None),
                              ("int8", qparams, "int8")):
        sec = timed_s(lambda: decode(p, quantize), 20)
        rates[name] = CAPTION_ITEMS / sec
        log("  %s greedy decode of %d items: %.2f ms = %.1f captions/s"
            % (name, CAPTION_ITEMS, sec * 1e3, CAPTION_ITEMS / sec))
    results["int8_caption_captions_per_s"] = rates
    del params, qparams
    torch.cuda.empty_cache()

    settings, model = caption_flagship(batch_size=2, compute_dtype="float32")
    frames, prm = device_frames(dset.processor, 2, 11, "cpu")

    def run(device):
        q = model.quantize_params(serving._to_device(params_cpu, device))
        pre = make_preprocessor(dset.processor, out_dtype=torch.float32,
                                device=device)
        feed = {"frames_main_input": pre(frames.to(device), prm.to(device))}
        ids = model.apply(q, feed, decode=True, quantize="int8")
        _, logits = decode_mod.greedy_decode(
            **model.decoder_inputs(q, feed, quantize="int8"),
            return_type=defs.return_type.standard)
        return ids.cpu().numpy(), logits.cpu().numpy()

    (card, _), (cpu, c_logits), (free, _), flips = forced_card_vs_cpu(
        run, "float32 int8 greedy decode of 2 items")
    diff = first_difference(card, cpu)
    top2 = np.sort(c_logits, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    log("  float32 int8 greedy decode of 2 items, card vs CPU on the card's "
        "int8 activations: tokens %s; least CPU top-2 margin %.3g; on its "
        "own: tokens %s"
        % ("equal" if diff is None else
           "differ first at item %d step %d" % diff, margin,
           "equal" if first_difference(card, free) is None else "differ"))
    if diff is not None:
        i, t = diff
        limit = 1e-4 * max(1.0, float(np.abs(c_logits[i, t]).max()))
        if not top2[i, t, 1] - top2[i, t, 0] < limit:
            raise AssertionError("int8 caption tokens differ at a decided "
                                 "step")
    results["int8_caption_fp32_card_vs_cpu"] = {
        "first_difference": diff, "min_cpu_margin": margin,
        "flips": flips}


# ------------------------------------------------------------- phase 8
FED_PLAN = [TRAIN_CLIPS] * 3 + [40]     # 424 one-clip videos, 128 a batch
FED_SEED = 8
FED_WANT = {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
            "conv1_dw": 0, "conv1_dw_shifted": 1}


def pack_videos(folder, videos, seed):
    """``videos`` one-clip videos of FPC 240x320x3 uint8 frames and a
    label each, from one seeded numpy stream, packed by the port's
    RecordWriter with the ``.size`` sidecar and a paths file.  Returns
    the paths file (a dataset's ``data_path``)."""
    frame_bytes = RAW_HW[0] * RAW_HW[1] * 3
    # phase 9 adds its val split, one checkpoint of ~0.5 GB (and a probe
    # save) and the caption files in the same folder, phase 10 its media,
    # their packs and its artifacts, phase 12 its reference states,
    # artifacts and run folder
    need = (videos + RUN_VAL_VIDEOS * RUN_VAL_CPV) * FPC * \
        (frame_bytes + 64) + (3 << 29) + MEDIA_BYTES + MESH_BYTES
    free = shutil.disk_usage(folder).free
    if free < need + (1 << 30):
        raise RuntimeError("phases 8-10 write %.2f GB into %s, which has "
                           "%.2f GB free" % (need / 1e9, folder,
                                             free / 1e9))
    base = os.path.join(folder, "videos.train")
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLASSES, videos)
    with records.RecordWriter(base + ".tfrecord") as w:
        for v in range(videos):
            clip = rng.integers(0, 256, (FPC,) + RAW_HW + (3,), np.uint8)
            for frame in clip:
                w.write(records.encode_image_example(frame, int(labels[v])))
    records.write_size_file(videos, [1] * videos, base + ".tfrecord",
                            defs.input_mode.video, 1, FPC)
    with open(base, "w") as f:
        f.write("".join("vid%04d %d\n" % (v, labels[v])
                        for v in range(videos)))
    return base


def fed_config(folder, data_path, name, resume_file=None):
    """A JSON run config with ``config.example.yml``'s ``run:`` schema:
    the flagship pipelines of ``bench.py`` (AlexNet to fc7, 2x256 LSTM,
    avg fusion), bf16, SGD at lr 0.001 with a global-norm clip of 10,
    dropout 0.5, random crop and mirror with the mean subtracted on the
    card, a new order every epoch.  Returns its path."""
    run = {
        "resume_file": resume_file,
        "run_folder": os.path.join(folder, "run"),
        "phase": "defs.phase.train", "seed": 0,
        "mesh_shape": {"data": 1, "model": 1}, "compute_dtype": "bfloat16",
        "data": {"packed-train": {
            "data_path": data_path, "prepend_folder": "",
            "raw_image_shape": "(%d, %d, 3)" % RAW_HW,
            "image_shape": "(%d, %d, 3)" % (IMAGE, IMAGE),
            "mean_image": list(SERVING_MEAN),
            "data_format": "defs.data_format.tfrecord",
            "frame_format": "jpg",
            "imgproc": ["defs.imgproc.rand_crop", "defs.imgproc.rand_mirror",
                        "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item.default",
            "phase": "defs.phase.train", "tag": "defs.dataset_tag.main",
            "device_preprocess": True, "epoch_shuffle": True}},
        "network": {"num_classes": CLASSES, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc7"}},
            {"clf": {"input": "frames",
                     "representation": "defs.representation.nop",
                     "classifier": "defs.classifier.lstm",
                     "lstm_params": [HIDDEN, LAYERS,
                                     "defs.fusion_method.avg"]}}]},
        "train": {"batch_size": TRAIN_CLIPS, "epochs": 2,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.001,
                  "lr_mult": "None", "clip_norm": 10,
                  "dropout_keep_prob": 0.5},
        "logging": {"save_freq_per_epoch": 1, "level": "logging.WARN"}}
    path = os.path.join(folder, name)
    with open(path, "w") as f:
        json.dump({"run": run}, f, indent=1)
    return path


def fed_epoch(feeder, engine, model, kept, epoch):
    """One epoch of fed steps through FeedPrefetcher and
    ``prepare_device_feed``, each with the counts at 0 just before it
    and the plain versions locked out: checks the batch plan, the tail's
    padding and mask, the launches and the metrics, and keeps the first
    epoch's batches 0 and 2 in ``kept``.  Returns the host-clock wall of
    each step (from the previous step's end, the wait for the batch
    included, the replay meter's own time left out) and each wait."""
    key = model.required_input[0][0]
    walls, waits = [], []
    torch.cuda.synchronize()
    t_prev = time.monotonic()
    for feed, batches, index in FeedPrefetcher(
            feeder, model.required_input,
            prepare_fn=engine.prepare_device_feed):
        waits.append(time.monotonic() - t_prev)
        if epoch == 0 and index in (0, 2):
            kept[index] = {k: feed[k].clone() for k in
                           (key, key + "/proc_params", "labels")}
        rows = int(feed["labels"].shape[0])
        valid = int(feed["label_mask"].sum())
        if rows != TRAIN_CLIPS or valid != FED_PLAN[index] or \
                feed[key].shape[0] != TRAIN_CLIPS * FPC or \
                not bool(feed["label_mask"][:valid].all()):
            raise AssertionError("batch %d: %d label rows, %d valid, %d "
                                 "frames" % (index, rows, valid,
                                             feed[key].shape[0]))
        metered = _METER.overhead_s
        metrics, launched = locked_step(engine, feed)
        now = time.monotonic()
        walls.append(now - t_prev - (_METER.overhead_s - metered))
        t_prev = now
        designs = variants()
        log("  epoch %d batch %d (%d clips, %d padded): %.1f ms (%.1f of "
            "them waiting for the batch), %s; launched %s"
            % (epoch + 1, index, valid, rows - valid, walls[-1] * 1e3,
               waits[-1] * 1e3, metrics, launched))
        if launched != FED_WANT or designs != {"staged": 0, "vector": 2}:
            raise AssertionError("fed step launched %s (%s), expected %s"
                                 % (launched, designs, FED_WANT))
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError("non-finite metrics %s" % metrics)
    if len(walls) != len(FED_PLAN):
        raise AssertionError("%d fed steps in epoch %d" % (len(walls),
                                                           epoch + 1))
    return walls, waits


def feeder_ms(feeder, engine, required_input):
    """One epoch of the feeder alone: per batch, the host ms of
    ``get_feed``, of ``prepare_device_feed`` (which returns once its copy
    is done) and the feed's bytes."""
    rows = []
    while feeder.loop():
        t0 = time.monotonic()
        feed, batches = feeder.get_feed(required_input)
        t1 = time.monotonic()
        engine.prepare_device_feed(feed, batches)
        t2 = time.monotonic()
        rows.append({"get_feed_ms": (t1 - t0) * 1e3,
                     "prepare_ms": (t2 - t1) * 1e3,
                     "bytes": int(sum(v.nbytes for v in feed.values()))})
    feeder.rewind_datasets(next_epoch=True)
    full = rows[:-1]
    out = {"batches": rows,
           "get_feed_ms": float(np.mean([r["get_feed_ms"] for r in full])),
           "prepare_ms": float(np.mean([r["prepare_ms"] for r in full]))}
    out["h2d_gb_per_s"] = float(np.mean([r["bytes"] / r["prepare_ms"] / 1e6
                                         for r in full]))
    return out


def device_busy_us(prof):
    """Device time of the profiled window's kernels, copies left out."""
    from torch.autograd import DeviceType
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and
               not ev.key.startswith(("Memcpy", "Memset")))


def phase_fed(results, folder):
    """Phase 8 in ``folder``; its packed train split stays there for
    phase 9.  Returns the split's paths file."""
    clips = sum(FED_PLAN)
    log("phase 8: training from a packed dataset (%d one-clip videos x %d "
        "frames of %dx%d, bf16)" % ((clips, FPC) + RAW_HW))
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.monotonic()
    data_path = pack_videos(folder, clips, FED_SEED)
    size = os.path.getsize(data_path + ".tfrecord")
    results["fed_pack_s"] = time.monotonic() - t0
    log("  packed %.2f GB in %.1f s" % (size / 1e9,
                                        results["fed_pack_s"]))
    t0 = time.monotonic()
    settings = Settings()
    feeder = settings.initialize(fed_config(folder, data_path,
                                            "run.json"))
    model = Model(settings)
    engine = Train(settings, feeder, model, device="cuda")
    dset = feeder.get_datasets()[0]
    log("  Settings -> Model -> Train: %.1f s; native reader %s"
        % (time.monotonic() - t0, native_io.lib_path))
    if dset.native_reader is None:
        raise AssertionError("the native record reader is not active")
    if dset.batches != FED_PLAN:
        raise AssertionError("batch plan %s, expected %s"
                             % (dset.batches, FED_PLAN))
    # two epochs: the first pays the first uses (the pinned ring's
    # slots, made as they are first filled); each starts with a read
    # and copy that nothing overlaps, and its last two steps (the
    # third full batch and the tail, both 128 rows) run with the
    # prefetch queue ahead of them
    key = model.required_input[0][0]
    kept, walls, waits = {}, [], []
    for epoch in range(2):
        w, q = fed_epoch(feeder, engine, model, kept, epoch)
        walls.append(w)
        waits.append(q)
        feeder.rewind_datasets(next_epoch=True)
    if dset.native_reader is None:
        raise AssertionError("the native reader fell back")
    steady = float(np.mean(walls[1][2:]))
    results["fed_step_ms"] = [[x * 1e3 for x in w] for w in walls]
    results["fed_wait_ms"] = [[x * 1e3 for x in q] for q in waits]
    results["fed_full_step_ms_mean"] = [float(np.mean(w[:3])) * 1e3
                                        for w in walls]
    results["fed_epoch_step_ms_mean"] = [float(np.mean(w)) * 1e3
                                         for w in walls]
    results["fed_steady_step_ms"] = steady * 1e3
    for epoch, w in enumerate(walls):
        log("  epoch %d, three full fed steps: %s ms (mean %.2f; over "
            "the epoch's %d steps %.2f)"
            % (epoch + 1, ", ".join("%.2f" % (x * 1e3) for x in w[:3]),
               results["fed_full_step_ms_mean"][epoch], len(w),
               results["fed_epoch_step_ms_mean"][epoch]))
    log("  fed step with the queue ahead (epoch 2, steps 3-4) %.2f ms "
        "= %.1f clips/s; phase 5's step on card-made inputs: %.2f ms"
        % (steady * 1e3, TRAIN_CLIPS / steady, results["train_step_ms"]))

    # the feeder alone: pinned ring (the default for a CUDA feed),
    # then fresh pageable arrays per batch
    for mode, flag in (("pinned", None), ("pageable", "0")):
        if flag is not None:
            os.environ["VLT_REUSE_READ_BUFFERS"] = flag
        try:
            res = feeder_ms(feeder, engine, model.required_input)
        finally:
            os.environ.pop("VLT_REUSE_READ_BUFFERS", None)
        results["fed_feeder_" + mode] = res
        log("  feeder alone, %s read buffers: get_feed %.1f ms + "
            "prepare_device_feed %.1f ms per %d-clip batch; host to "
            "device %.2f GB/s" % (mode, res["get_feed_ms"],
                                  res["prepare_ms"], TRAIN_CLIPS,
                                  res["h2d_gb_per_s"]))

    # the card's idle share in one fed step (the next batch being
    # read and copied meanwhile)
    batches_iter = iter(FeedPrefetcher(
        feeder, model.required_input,
        prepare_fn=engine.prepare_device_feed))
    engine.run_step(next(batches_iter)[0])
    feed = next(batches_iter)[0]
    prof = profile_rows("one fed step", lambda: engine.run_step(feed),
                        steady, results, "fed_profile", top=8)
    busy = device_busy_us(prof)
    results["fed_idle_share"] = 1.0 - busy / (steady * 1e6)
    log("  kernels (copies left out) %.0f us of the %.2f ms fed step "
        "with the queue ahead: idle share %.3f"
        % (busy, steady * 1e3, results["fed_idle_share"]))
    batches_iter.close()
    del feed

    # resume from a hand-written .snap [batch 2, epoch 0, step 2]
    ckpt = os.path.join(folder, "run", "checkpoints", "resume.ckpt")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    with open(ckpt + ".snap", "w") as f:
        json.dump([2, 0, 2], f)
    resumed = Settings()
    feeder2 = resumed.initialize(fed_config(folder, data_path,
                                            "resume.json", ckpt))
    feed2, _ = feeder2.get_feed(model.required_input)
    same = {k: bool(torch.equal(torch.from_numpy(feed2[k]).cuda(),
                                kept[2][k]))
            for k in (key, "labels")}
    # the JAX Dataset.restore leaves rng at its start, so a resumed
    # run draws batch 0's crops and mirrors
    same["proc_params (batch 0's)"] = bool(torch.equal(
        torch.from_numpy(feed2[key + "/proc_params"]).cuda(),
        kept[0][key + "/proc_params"]))
    results["fed_resume"] = same
    log("  resumed at [2, 0, 2]: global step %d; first batch equal to "
        "batch 2: %s" % (resumed.global_step, same))
    if resumed.global_step != 2 or not all(same.values()):
        raise AssertionError("the resumed batch differs: %s" % same)
    for d in feeder.get_datasets() + feeder2.get_datasets():
        d.reader.close()
        d.native_reader.close()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    results["peak_host_rss_gb"] = rss / 1e6
    log("  peak host RSS of the process %.2f GB (%.2f GB before phase 8)"
        % (rss / 1e6, rss0 / 1e6))
    return data_path


# ------------------------------------------------------------- phase 9
RUN_VAL_VIDEOS, RUN_VAL_CPV, RUN_VAL_ITEMS = 32, 4, 8   # 32 clips a batch
RUN_VAL_SEED = 9
RUN_WATCH = "clf/output_fc/w"
VAL_WANT = {"lrn": 2, "lstm_step": FPC * LAYERS}
CAPTION_WORDS, CAPTION_DIM, CAPTION_T = 10000, 300, 20
CAPTION_IMAGES, CAPTION_BATCH = 64, 32
CAPTION_WANT = {"lrn": 2, "lstm_step": CAPTION_T}


def pack_split(folder, name, videos, cpv, seed, prefix):
    """``videos`` videos of ``cpv`` clips of FPC 240x320x3 uint8 frames
    and a label each, from one seeded numpy stream, packed by the port's
    RecordWriter as ``<folder>/<name>`` with its ``.size`` sidecar and a
    paths file of ``<prefix><index> <label>`` lines.  Returns the paths
    file (a dataset's ``data_path``)."""
    base = os.path.join(folder, name)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, CLASSES, videos)
    with records.RecordWriter(base + ".tfrecord") as w:
        for v in range(videos):
            frames = rng.integers(0, 256, (cpv * FPC,) + RAW_HW + (3,),
                                  np.uint8)
            for frame in frames:
                w.write(records.encode_image_example(frame, int(labels[v])))
    records.write_size_file(videos, [cpv] * videos, base + ".tfrecord",
                            defs.input_mode.video, 1, FPC)
    with open(base, "w") as f:
        f.write("".join("%s%04d %d\n" % (prefix, v, labels[v])
                        for v in range(videos)))
    return base


def pack_val_videos(folder, seed):
    """The val split: RUN_VAL_VIDEOS videos of RUN_VAL_CPV clips."""
    return pack_split(folder, "videos.val", RUN_VAL_VIDEOS, RUN_VAL_CPV,
                      seed, "val")


def run_config(folder, name, phase, train_path, val_path, val_items=None,
               **over):
    """The JSON run config of phase 9: phase 5's training configuration
    (128 clips, bf16, 2x256 LSTM, 101 classes, SGD lr 0.001, clip 10,
    dropout 0.5) with the EMA, an inline eval every epoch on the val
    split (8 videos a batch, top-5), one async save per epoch and the
    output FC's weights watched; ``phase`` "val" evaluates the latest
    checkpoint's EMA weights, ``val_items`` videos a batch (default
    RUN_VAL_ITEMS).  ``over``
    replaces top-level fields.  Returns its path."""
    def data(path, split, imgproc, shuffle):
        return {"data_path": path, "prepend_folder": "",
                "raw_image_shape": "(%d, %d, 3)" % RAW_HW,
                "image_shape": "(%d, %d, 3)" % (IMAGE, IMAGE),
                "mean_image": list(SERVING_MEAN),
                "data_format": "defs.data_format.tfrecord",
                "frame_format": "jpg", "imgproc": imgproc,
                "batch_item": "defs.batch_item.default",
                "phase": "defs.phase." + split,
                "tag": "defs.dataset_tag.main", "device_preprocess": True,
                "epoch_shuffle": shuffle}

    val_data = data(val_path, "val", ["defs.imgproc.center_crop",
                                      "defs.imgproc.sub_mean"], False)
    datasets = {"val": val_data}
    if phase == "train":
        datasets["train"] = data(train_path, "train", [
            "defs.imgproc.rand_crop", "defs.imgproc.rand_mirror",
            "defs.imgproc.sub_mean"], True)
    run = {
        "resume_file": None if phase == "train" else "latest",
        "run_folder": os.path.join(folder, "run9"), "run_id": "phase9",
        "phase": "defs.phase." + phase, "seed": 0,
        "mesh_shape": {"data": 1}, "compute_dtype": "bfloat16",
        "checkpoint_async": True, "data": datasets,
        "network": {"num_classes": CLASSES, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc7"}},
            {"clf": {"input": "frames",
                     "representation": "defs.representation.nop",
                     "classifier": "defs.classifier.lstm",
                     "lstm_params": [HIDDEN, LAYERS,
                                     "defs.fusion_method.avg"]}}]},
        "train": {"batch_size": TRAIN_CLIPS, "epochs": 1,
                  "optimizer": "defs.optim.sgd", "base_lr": 0.001,
                  "lr_mult": "None", "clip_norm": 10,
                  "dropout_keep_prob": 0.5, "ema_decay": 0.99,
                  "eval_every_epochs": 1},
        "val": {"batch_size": val_items or RUN_VAL_ITEMS,
                "logits_save_interval": -1,
                "top_k": [5], "use_ema": True,
                "clip_fusion": ["defs.fusion_type.late",
                                "defs.fusion_method.avg"]},
        "logging": {"save_freq_per_epoch": 1, "level": "logging.WARN",
                    "watch_tensors": [RUN_WATCH]}}
    run.update(over)
    path = os.path.join(folder, name)
    with open(path, "w") as f:
        json.dump({"run": run}, f, indent=1)
    return path


class _PerCall:
    """Wraps ``owner.name`` for a ``with`` block: each call's launch
    counts (the counters' rise over the call; nothing is reset, so the
    totals over a whole run stay intact), its host wall (ending in a
    sync, the replay meter's own time left out), and the arguments
    (``self`` first) and output of the last call."""

    def __init__(self, owner, name, kernels):
        self.owner, self.name, self.kernels = owner, name, kernels
        self.calls, self.last, self.out = [], None, None

    def __enter__(self):
        self.saved = getattr(self.owner, self.name)
        saved, outer = self.saved, self

        def wrapped(*args, **kwargs):
            before = counts(outer.kernels)
            metered = _METER.overhead_s
            t0 = time.monotonic()
            out = saved(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0 - (_METER.overhead_s - metered)
            after = counts(outer.kernels)
            outer.calls.append({"wall_s": wall, "launched": {
                k: after[k] - before[k] for k in outer.kernels}})
            outer.last, outer.out = args, out
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


def _metrics_records(run_folder, phase):
    paths = sorted(glob.glob(os.path.join(run_folder, "tensorboard", phase,
                                          "metrics_*.jsonl")),
                   key=os.path.getmtime)
    return [json.loads(line) for p in paths for line in open(p)]


def _check_calls(calls, want, what):
    for i, c in enumerate(calls):
        if c["launched"] != want:
            raise AssertionError("%s %d launched %s, expected %s"
                                 % (what, i, c["launched"], want))


def run_train_phase(results, folder, train_path, val_path):
    """run_task.main on the train config: one epoch of four fed steps, an
    inline eval, one async save."""
    cfg = run_config(folder, "train9.json", "train", train_path, val_path)
    rf = os.path.join(folder, "run9")
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut(), \
            _PerCall(Train, "run_step", TRAIN_KERNELS) as steps, \
            _PerCall(val_mod.Validation, "run_forward",
                     ("lrn", "lstm_step")) as fwd:
        run_task.main(cfg)
    wall = time.monotonic() - t0
    total = counts(TRAIN_KERNELS)
    results["run_train_wall_s"] = wall
    results["run_train_launches"] = total
    results["run_train_steps"] = steps.calls
    results["run_train_eval_batches"] = fwd.calls
    n_steps, n_eval = len(steps.calls), len(fwd.calls)
    log("  train phase: %d steps, %d inline-eval batches in %.1f s; "
        "launched %s" % (n_steps, n_eval, wall, total))
    for i, c in enumerate(steps.calls):
        log("    step %d: %.1f ms, launched %s"
            % (i + 1, c["wall_s"] * 1e3, c["launched"]))
    if n_steps != len(FED_PLAN) or n_eval != RUN_VAL_VIDEOS // RUN_VAL_ITEMS:
        raise AssertionError("%d steps and %d eval batches" % (n_steps,
                                                              n_eval))
    _check_calls(steps.calls, FED_WANT, "train step")
    _check_calls(fwd.calls, VAL_WANT, "inline eval batch")
    want_total = {k: n_steps * FED_WANT[k] + n_eval * VAL_WANT.get(k, 0)
                  for k in TRAIN_KERNELS}
    if total != want_total:
        raise AssertionError("the train phase launched %s, expected %s"
                             % (total, want_total))

    recs = _metrics_records(rf, "train")
    if [r["step"] for r in recs if "loss" in r] != [1, 2, 3, 4]:
        raise AssertionError("metrics steps %s" % [r["step"] for r in recs])
    keys = ["%s/%s/%s" % (kind, RUN_WATCH, stat) for kind in ("param", "grad")
            for stat in ("mean", "std", "min", "max")]
    for i, r in enumerate(r for r in recs if "loss" in r):
        need = ["loss", "lr"] + keys + (["clips_per_sec"] if i else [])
        if not all(k in r and math.isfinite(r[k]) for k in need):
            raise AssertionError("metrics record %s lacks %s" % (r, need))
    vals = [r["val_accuracy"] for r in recs if "val_accuracy" in r]
    if len(vals) != 1 or not 0.0 <= vals[0] <= 1.0:
        raise AssertionError("inline val_accuracy %s" % vals)
    results["run_train_metrics"] = recs
    ckpts = glob.glob(os.path.join(rf, "checkpoints", "*_gs_*.ckpt"))
    if len(ckpts) != 1 or not os.path.exists(ckpts[0] + ".snap"):
        raise AssertionError("checkpoints %s" % ckpts)
    with open(ckpts[0] + ".snap") as f:
        snap = json.load(f)
    conv1 = tuple(checkpoint.load_flat(ckpts[0])[
        "params/frames/dcnn/conv1/w"].shape)
    if conv1 != (11, 11, 3, 96) or snap != [len(FED_PLAN), 0, len(FED_PLAN)]:
        raise AssertionError("conv1 stored as %s, .snap %s" % (conv1, snap))
    steady = float(np.mean([c["wall_s"] for c in steps.calls[1:]]))
    results["run_train_step_ms"] = steady * 1e3
    log("  metrics: loss %s, clips/s %s, %s/std %s; inline val accuracy "
        "%.4f; checkpoint %s, .snap %s, conv1 stored %s"
        % ([round(r["loss"], 4) for r in recs if "loss" in r],
           [r.get("clips_per_sec") for r in recs if "loss" in r],
           "grad/" + RUN_WATCH,
           [r["grad/%s/std" % RUN_WATCH] for r in recs if "loss" in r],
           vals[0], os.path.basename(ckpts[0]), snap, conv1))
    log("  steps 2-4 of the run: %.2f ms a step = %.1f steps/s (phase 8's "
        "fed step with the queue ahead: %.2f ms)"
        % (steady * 1e3, 1 / steady, results["fed_steady_step_ms"]))
    return steps.last[0], steps.last[1]


def save_probe(results, engine, feed):
    """What an async save costs the step after it: three steps, then
    ``Feeder.save`` of ``state_dict()`` (the part on the step loop's
    thread), the next step while the write runs, ``finish_saves``."""
    feeder = engine.feeder

    def step():
        t0 = time.monotonic()
        engine.run_step(dict(feed))
        torch.cuda.synchronize()
        return time.monotonic() - t0

    before = [step() for _ in range(3)]
    # the probe must not prune the run's checkpoint, which phase 9's val
    # phase resumes
    num_saves, feeder.num_saves = feeder.num_saves, 0
    t0 = time.monotonic()
    path = feeder.save(engine.state_dict(), "probe", engine.global_step,
                       batch_index=0, fixed_name="probe")
    submit = time.monotonic() - t0
    after = step()
    t0 = time.monotonic()
    feeder.finish_saves()
    wait = time.monotonic() - t0
    feeder.num_saves = num_saves
    size = os.path.getsize(path)
    checkpoint.delete_checkpoint(path)
    results["run_save_probe"] = {
        "step_ms_before": [x * 1e3 for x in before],
        "save_call_ms": submit * 1e3, "step_ms_after": after * 1e3,
        "finish_wait_ms": wait * 1e3, "checkpoint_bytes": size}
    log("  async save of %.2f GB: %.1f ms on the step loop (state_dict "
        "copies + submit); the next step %.2f ms against %s before; "
        "finish_saves waited %.1f ms more"
        % (size / 1e9, submit * 1e3, after * 1e3,
           ", ".join("%.2f" % (x * 1e3) for x in before), wait * 1e3))


def val_card_vs_cpu(results, folder, train_path, val_path):
    """One val batch (one video) of the latest checkpoint's EMA weights
    in float32 on the card and on the CPU."""
    from video_learning_tpu_torch.data.feeder import prepare_feed
    cfg = run_config(folder, "val9_f32.json", "val", train_path, val_path,
                     val_items=1, compute_dtype="float32")
    settings = Settings()
    feeder = settings.initialize(cfg)
    model = Model(settings)
    feed, _ = feeder.get_feed(model.required_input)
    feed = run_task._host_tensors(prepare_feed(feed, {}))
    out = {}
    for device in ("cuda", "cpu"):
        state, ign = checkpoint.prepare_eval_state(
            model.init_params(0, device=device), [], True)
        loaded = []
        state = feeder.init_saveload(state, "latest", ign, loaded_out=loaded)
        params, used = checkpoint.select_eval_params(state, loaded, True,
                                                     True, "card vs cpu")
        if not used:
            raise AssertionError("no EMA weights in the checkpoint")
        v = val_mod.Validation(settings, model, device=device)
        out[device] = v.run_forward(params, feed)
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    limit = 1e-3 * max(1.0, float(np.abs(out["cpu"]).max()))
    results["run_val_fp32_card_vs_cpu"] = {"max_abs_err": err,
                                           "limit": limit}
    log("  one val batch (%d clips) in float32, card vs CPU: max abs err "
        "%.3g (limit %.3g)" % (out["cpu"].shape[0], err, limit))
    if not err <= limit:
        raise AssertionError("val logits card vs CPU differ by %g" % err)


def run_val_phase(results, folder, train_path, val_path):
    """run_task.main on the val config from the latest checkpoint's EMA
    weights: launches per batch, the accuracy files, clips/s, one batch
    profiled."""
    cfg = run_config(folder, "val9.json", "val", train_path, val_path)
    rf = os.path.join(folder, "run9")
    reset_counts()
    with _PlainLockedOut(), \
            _PerCall(val_mod.Validation, "run_forward",
                     ("lrn", "lstm_step")) as fwd, \
            _PerCall(run_task, "do_test", ()) as test:
        run_task.main(cfg)
    total = counts()
    batches = len(fwd.calls)
    results["run_val_launches"] = total
    results["run_val_batches"] = fwd.calls
    if batches != RUN_VAL_VIDEOS // RUN_VAL_ITEMS or \
            total != {k: batches * v for k, v in VAL_WANT.items()}:
        raise AssertionError("%d val batches launched %s" % (batches, total))
    _check_calls(fwd.calls, VAL_WANT, "val batch")
    val, params, feed = fwd.last
    accs = val.get_accuracies([1, 5])
    files = {k: float(open(os.path.join(rf, name)).read()) for k, name in
             ((1, "accuracy_phase9_val_resume"),
              (5, "accuracy_top5_phase9_val_resume"))}
    if files != accs:
        raise AssertionError("accuracy files %s, get_accuracies %s"
                             % (files, accs))
    clips = RUN_VAL_VIDEOS * RUN_VAL_CPV
    fwd_s = sum(c["wall_s"] for c in fwd.calls[1:])
    per_batch = RUN_VAL_ITEMS * RUN_VAL_CPV
    results["run_val_clips_per_s"] = per_batch * (batches - 1) / fwd_s
    results["run_val_test_clips_per_s"] = clips / test.calls[0]["wall_s"]
    log("  val phase: %d batches of %d clips, launched %s; top-1 %.4f, "
        "top-5 %.4f (files = get_accuracies); batches 2-%d %.1f clips/s "
        "(forward, inputs from the host); do_test %.1f clips/s over all "
        "%d clips (reads and padding included)"
        % (batches, per_batch, total, accs[1], accs[5], batches,
           results["run_val_clips_per_s"],
           results["run_val_test_clips_per_s"], clips))
    wall = fwd.calls[-1]["wall_s"]
    prof = profile_rows("one val batch", lambda: val.run_forward(params,
                                                                 feed),
                        wall, results, "run_val_profile", top=6)
    busy = device_busy_us(prof)
    results["run_val_idle_share"] = 1.0 - busy / (wall * 1e6)
    log("  kernels (copies left out) %.0f us of the %.2f ms val batch: "
        "idle share %.3f" % (busy, wall * 1e3, results["run_val_idle_share"]))


def caption_files(folder, seed):
    """Phase 6's caption geometry from one seeded stream: a TSV of
    CAPTION_WORDS words (UNK, EOS, BOS last) with CAPTION_DIM-d
    embeddings, CAPTION_IMAGES 240x320 uint8 images with captions packed
    as image records beside a COCO_val2014_<id>.jpg paths file, and a
    ground-truth JSON of two synthetic captions per image.  Returns
    (paths file, embeddings file, ground truth)."""
    rng = np.random.default_rng(seed)
    words = ["w%04d" % i for i in range(CAPTION_WORDS - 3)] + \
        ["UNK", "EOS", "BOS"]
    emb = rng.standard_normal((CAPTION_WORDS, CAPTION_DIM),
                              dtype=np.float32) * 0.1
    emb_path = os.path.join(folder, "vocab.embeddings")
    with open(emb_path, "w") as f:
        for w, row in zip(words, emb):
            f.write(w + "\t" + " ".join("%.5f" % x for x in row) + "\n")
    base = os.path.join(folder, "captions.val")
    ids = [int(i) for i in rng.choice(10 ** 6, CAPTION_IMAGES,
                                       replace=False)]
    caps = [list(rng.integers(0, CAPTION_WORDS - 3,
                              rng.integers(3, CAPTION_T)))
            for _ in ids]
    with records.RecordWriter(base + ".tfrecord") as w:
        for cap in caps:
            w.write(records.encode_image_example(
                rng.integers(0, 256, RAW_HW + (3,), np.uint8), cap))
    records.write_size_file(CAPTION_IMAGES, None, base + ".tfrecord",
                            defs.input_mode.image, CAPTION_T - 1, None)
    with open(base, "w") as f:
        f.write("".join("COCO_val2014_%012d.jpg %s\n"
                        % (i, " ".join(map(str, c)))
                        for i, c in zip(ids, caps)))
    gt = {"images": [{"id": i} for i in ids], "annotations": [
        {"image_id": i, "caption": " ".join(words[int(k)] for k in c[s:])}
        for i, c in zip(ids, caps) for s in (0, 1)]}
    gt_path = os.path.join(folder, "captions_gt.json")
    with open(gt_path, "w") as f:
        json.dump(gt, f)
    return base, emb_path, gt_path


def run_caption_phase(results, folder):
    """run_task.main on a caption val config at phase 6's width (random
    weights from seed 0): greedy decodes, coco.results.json, scores."""
    t0 = time.monotonic()
    data_path, emb_path, gt_path = caption_files(folder, RUN_VAL_SEED)
    prep_s = time.monotonic() - t0
    run = {
        "resume_file": None, "run_folder": os.path.join(folder, "run9c"),
        "run_id": "phase9c", "phase": "defs.phase.val", "seed": 0,
        "mesh_shape": {"data": 1}, "compute_dtype": "bfloat16",
        "data": {"caps": {
            "data_path": data_path, "prepend_folder": "",
            "raw_image_shape": "(%d, %d, 3)" % RAW_HW,
            "image_shape": "(%d, %d, 3)" % (IMAGE, IMAGE),
            "mean_image": list(SERVING_MEAN),
            "data_format": "defs.data_format.tfrecord",
            "frame_format": "jpg",
            "imgproc": ["defs.imgproc.center_crop", "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item.default",
            "phase": "defs.phase.val", "tag": "defs.dataset_tag.main",
            "device_preprocess": True}},
        "network": {"num_classes": CAPTION_WORDS, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc7"}},
            {"capt": {"input": "frames",
                      "representation": "defs.representation.nop",
                      "classifier": "defs.classifier.lstm",
                      "lstm_params": [512, 1, "defs.fusion_method.avg",
                                      "defs.rnn_visual_mode.state_bias"]}}]},
        "val": {"batch_size": CAPTION_BATCH, "logits_save_interval": -1},
        "captioning": {"caption_search": "defs.caption_search.max",
                       "eval_type": "defs.eval_type.coco",
                       "caption_max_length": CAPTION_T - 1,
                       "caption_ground_truth": gt_path,
                       "word_embeddings_file": emb_path},
        "logging": {"level": "logging.WARN"}}
    cfg = os.path.join(folder, "caption9.json")
    with open(cfg, "w") as f:
        json.dump({"run": run}, f, indent=1)
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut(), \
            _PerCall(val_mod.Validation, "run_forward",
                     ("lrn", "lstm_step")) as fwd:
        run_task.main(cfg)
    wall = time.monotonic() - t0
    total = counts()
    batches = len(fwd.calls)
    if batches != CAPTION_IMAGES // CAPTION_BATCH or \
            total != {k: batches * v for k, v in CAPTION_WANT.items()}:
        raise AssertionError("%d caption batches launched %s"
                             % (batches, total))
    _check_calls(fwd.calls, CAPTION_WANT, "caption batch")
    rf = run["run_folder"]
    with open(os.path.join(rf, "coco.results.json")) as f:
        res = json.load(f)
    with open(os.path.join(rf, "coco.results.json.eval.json")) as f:
        scores = json.load(f)
    ids = [r["image_id"] for r in res]
    if len(ids) != CAPTION_IMAGES or len(set(ids)) != CAPTION_IMAGES:
        raise AssertionError("coco.results.json holds %d rows, %d ids"
                             % (len(ids), len(set(ids))))
    if not scores or not all(math.isfinite(v) for v in scores.values()):
        raise AssertionError("caption scores %s" % scores)
    decode_s = sum(c["wall_s"] for c in fwd.calls[1:])
    results["run_caption"] = {
        "files_s": prep_s, "wall_s": wall, "launches": total,
        "batches": fwd.calls, "scores": scores,
        "captions_per_s": CAPTION_BATCH * (batches - 1) / decode_s}
    log("  caption val phase (%d images, %d a batch): files %.1f s, run "
        "%.1f s; launched %s; %d unique ids; scores %s; decode batches 2-%d "
        "%.1f captions/s (frames from the host)"
        % (CAPTION_IMAGES, CAPTION_BATCH, prep_s, wall, total,
           len(set(ids)), {k: round(v, 4) for k, v in scores.items()},
           batches, results["run_caption"]["captions_per_s"]))


def phase_run(results, folder, train_path):
    """Phase 9: the run driver on the card, in phase 8's folder."""
    log("phase 9: the run driver (run_task.main) from JSON run configs")
    t0 = time.monotonic()
    val_path = pack_val_videos(folder, RUN_VAL_SEED)
    results["run_val_pack_s"] = time.monotonic() - t0
    log("  packed the val split (%d videos x %d clips, %.2f GB) in %.1f s"
        % (RUN_VAL_VIDEOS, RUN_VAL_CPV,
           os.path.getsize(val_path + ".tfrecord") / 1e9,
           results["run_val_pack_s"]))
    engine, feed = run_train_phase(results, folder, train_path, val_path)
    feed = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in feed.items()}
    save_probe(results, engine, feed)
    del engine, feed
    torch.cuda.empty_cache()
    run_val_phase(results, folder, train_path, val_path)
    val_card_vs_cpu(results, folder, train_path, val_path)
    torch.cuda.empty_cache()
    run_caption_phase(results, folder)


# ------------------------------------------------------------ phase 10
MEDIA_VIDEOS, MEDIA_CPV, MEDIA_SEED = 16, 4, 10
MEDIA_FRAMES = FPC * (MEDIA_CPV + 1)    # frames per folder: 80
EXPORT_BUCKETS = [1, RUN_VAL_ITEMS]
# the media, three packs of them, two signature batches and their packs,
# three artifacts of ~0.25 GB
MEDIA_BYTES = 5 * MEDIA_VIDEOS * MEDIA_FRAMES * RAW_HW[0] * RAW_HW[1] * 3 \
    + (3 << 28)
CAPTION_MEDIA, CAPTION_PER_IMAGE = 8, 5
INT8_WANT = dict(VAL_WANT, int8_mm=INT8_MM_PER_FORWARD)


def write_media(folder, seed):
    """MEDIA_VIDEOS folders of MEDIA_FRAMES 240x320 binary P6 frames from
    one seeded numpy stream and their ``path label`` list.  Returns (the
    folders, the list file)."""
    rng = np.random.default_rng(seed)
    vids = []
    for v in range(MEDIA_VIDEOS):
        vdir = os.path.join(folder, "media%02d" % v)
        os.makedirs(vdir)
        for i, frame in enumerate(rng.integers(
                0, 256, (MEDIA_FRAMES,) + RAW_HW + (3,), np.uint8)):
            export_mod.write_ppm(os.path.join(vdir, "f_%04d.ppm" % i),
                                 frame)
        vids.append(vdir)
    listing = os.path.join(folder, "media.list")
    with open(listing, "w") as f:
        f.write("".join("%s %d\n" % (v, i % CLASSES)
                        for i, v in enumerate(vids)))
    return vids, listing


def pack_config(folder, name, listing, **over):
    """A JSON ``serialize:`` config: rand_clips of FPC frames, MEDIA_CPV a
    video, a fixed seed, every record validated, the log in ``folder``.
    Returns its path."""
    cfg = {"input_files": [listing], "run_id": name,
           "output_folder": os.path.join(folder, name),
           "num_threads": 4, "num_items_per_thread": 64,
           "num_processes": 1, "raw_image_shape": list(RAW_HW) + [3],
           "clip_offset_or_num": MEDIA_CPV, "num_frames_per_clip": FPC,
           "clipframe_mode": "defs.clipframe_mode.rand_clips",
           "generation_error": "defs.generation_error.abort",
           "do_shuffle": False, "do_validate": True, "validate_pcnt": 100,
           "frame_format": "ppm", "logging_level": "logging.WARN",
           "log_folder": folder, "seed": MEDIA_SEED}
    cfg.update(over)
    path = os.path.join(folder, name + ".json")
    with open(path, "w") as f:
        json.dump({"serialize": cfg}, f, indent=1)
    return path


def media_pack(results, folder, listing):
    """``serialize.main`` on the media, then ``check_serialized_data`` and
    ``compute_image_mean`` on what it wrote."""
    t0 = time.monotonic()
    serialize.main(["serialize", pack_config(folder, "pack10", listing)])
    wall = time.monotonic() - t0
    record = os.path.join(folder, "pack10", "media.list.tfrecord")
    size = records.read_size_file(record + ".size")
    want = sum(size["cpi"]) * size["fpc"]
    checked = check_serialized_data.check(record)
    if checked["count"] != want or want != MEDIA_VIDEOS * MEDIA_CPV * FPC:
        raise AssertionError("%d records, .size says %d" % (checked["count"],
                                                            want))
    means = compute_image_mean.main(["compute_image_mean", record])
    if not np.all(np.isfinite(means)) or len(means) != 3:
        raise AssertionError("image means %s" % means)
    nbytes = os.path.getsize(record)
    results["media_pack"] = {"wall_s": wall, "frames": want,
                             "bytes": nbytes, "frames_per_s": want / wall,
                             "mb_per_s": nbytes / 1e6 / wall,
                             "channel_means": [float(m) for m in means]}
    log("  packed %d frames of %d .ppm folders (%.1f MB) in %.2f s, "
        "records validated: %.1f frames/s, %.1f MB/s; "
        "check_serialized_data %d records = .size; channel means %s"
        % (want, MEDIA_VIDEOS, nbytes / 1e6, wall, want / wall,
           nbytes / 1e6 / wall, checked["count"],
           [round(float(m), 3) for m in means]))


def media_infer(results, folder, cfg, vids):
    """``infer.main`` over the media with phase 9's checkpoint (EMA):
    launches per val batch with the plain versions locked out, items/s
    end to end.  Returns (its last batch's feed, that batch's logits)."""
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut(), \
            _PerCall(val_mod.Validation, "run_forward",
                     ("lrn", "lstm_step")) as fwd:
        rows = infer_mod.main([cfg, "--media"] + vids + [
            "--topk", "5", "--ema", "--workdir",
            os.path.join(folder, "infer10")])
    wall = time.monotonic() - t0
    total = counts()
    batches = len(fwd.calls)
    if batches != MEDIA_VIDEOS // RUN_VAL_ITEMS or \
            total != {k: batches * v for k, v in VAL_WANT.items()}:
        raise AssertionError("%d infer batches launched %s"
                             % (batches, total))
    _check_calls(fwd.calls, VAL_WANT, "infer batch")
    if [r["media"] for r in rows] != vids or \
            not all(len(r["topk"]) == 5 and
                    all(0.0 <= p <= 1.0 for _, p in r["topk"])
                    for r in rows):
        raise AssertionError("infer rows %s" % rows[:2])
    results["media_infer"] = {
        "wall_s": wall, "items_per_s": MEDIA_VIDEOS / wall,
        "launches": total, "batches": fwd.calls, "first_row": rows[0]}
    log("  infer: %d rows of top-5 in %.2f s = %.2f items/s end to end "
        "(packing %d clips x %d frames an item included); %d batches "
        "launched %s; first row %s"
        % (len(rows), wall, MEDIA_VIDEOS / wall, MEDIA_CPV, FPC, batches,
           total, rows[0]["topk"][:2]))
    return fwd.last[2], fwd.out


def media_card_vs_cpu(results, folder, train_path, val_path, vids):
    """One item through ``build_serving_context`` in float32 on the card
    and on the CPU."""
    cfg = run_config(folder, "val10_f32.json", "val", train_path, val_path,
                     val_items=1, compute_dtype="float32")
    out = {}
    for device in ("cuda", "cpu"):
        work = os.path.join(folder, "f32_" + device)
        os.makedirs(work)
        _, feeder, model, params, val, _ = \
            infer_mod.build_serving_context(cfg, vids[:1], "latest",
                                            workdir=work, use_ema=True,
                                            device=device)
        feeder.loop()
        feed, _, _ = infer_mod.next_val_feed(feeder, model,
                                             BatchGeometry())
        out[device] = val.run_forward(params, feed)
        del model, params, val
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    limit = 1e-3 * max(1.0, float(np.abs(out["cpu"]).max()))
    results["media_fp32_card_vs_cpu"] = {"max_abs_err": err, "limit": limit}
    log("  one item (%d clips) in float32, card vs CPU: max abs err %.3g "
        "(limit %.3g)" % (out["cpu"].shape[0], err, limit))
    if not err <= limit:
        raise AssertionError("infer logits card vs CPU differ by %g" % err)


def call_artifact(path, feed, want):
    """``serving.load`` an artifact and call it on ``feed``'s arrays with
    the plain versions locked out; returns (the output, the first call's
    ms, its launches)."""
    module = serving.load(path)
    arrays = [feed[i["name"]] for i in module.meta["inputs"]]
    reset_counts()
    with _PlainLockedOut():
        t0 = time.monotonic()
        out = module(*arrays)
        torch.cuda.synchronize()
        first_ms = (time.monotonic() - t0) * 1e3
    launched = counts(tuple(want))
    if launched != want:
        raise AssertionError("an artifact call launched %s, expected %s"
                             % (launched, want))
    return module, out, first_ms


def media_export(results, folder, cfg, feed, logits):
    """``export_serving.export`` of phase 9's checkpoint (EMA) with
    buckets [1, 8], float and int8_static; each artifact loaded and
    called on infer's batch."""
    got, outs = {}, {}
    for name, int8, want in (("float", False, VAL_WANT),
                             ("int8_static", "static", INT8_WANT)):
        path = os.path.join(folder, "export10_%s.zip" % name)
        t0 = time.monotonic()
        meta = export_mod.export(cfg, path, "latest",
                                 batch_items=EXPORT_BUCKETS, int8=int8,
                                 use_ema=True,
                                 workdir=os.path.join(folder, "x_" + name))
        export_s = time.monotonic() - t0
        if meta["ema"] is not True or \
                meta["run_id"] != "phase9_infer_val_resume" or \
                meta["buckets"] != EXPORT_BUCKETS or \
                meta["quantize"] != ("int8_static" if int8 else None):
            raise AssertionError("export meta %s" % {
                k: meta[k] for k in ("ema", "run_id", "buckets",
                                     "quantize")})
        module, outs[name], first_ms = call_artifact(path, feed, want)
        if outs[name].shape != logits.shape or \
                not np.all(np.isfinite(outs[name])):
            raise AssertionError("artifact output %s"
                                 % (outs[name].shape,))
        got[name] = {"export_s": export_s, "first_call_ms": first_ms,
                     "bucket": module.last_bucket,
                     "bytes": os.path.getsize(path)}
        log("  export %s: %.2f s (%.0f MB), ema %s, run_id %s; first call "
            "at bucket %d %.1f ms, launched %s"
            % (name, export_s, os.path.getsize(path) / 1e6, meta["ema"],
               meta["run_id"], module.last_bucket, first_ms, want))
        del module
    scale = max(1.0, float(np.abs(logits).max()))
    err = float(np.abs(outs["float"] - logits).max())
    delta = float(np.abs(outs["int8_static"] - logits).max())
    got["float_vs_infer_max_abs_err"] = err
    got["int8_static_vs_infer_max_abs_delta"] = delta
    results["media_export"] = got
    log("  artifacts on infer's batch: float max abs err %.3g (limit %.3g),"
        " int8_static delta %.3g (logit scale %.3g)"
        % (err, 1e-3 * scale, delta, scale))
    if not err <= 1e-3 * scale:
        raise AssertionError("float artifact vs infer: %g" % err)
    if not 0.0 < delta < 0.5 * scale:
        raise AssertionError("int8_static artifact vs infer: %g (scale %g)"
                             % (delta, scale))


def caption_media(results, folder):
    """COCO-style annotations over CAPTION_MEDIA P6 images whose
    vocabulary reaches CAPTION_WORDS, a CAPTION_DIM-d GloVe-style text
    file, ``process_annotations`` (vocabulary, then encoded labels),
    ``produce_vocab_embeddings`` and the packed images.  Returns (run
    config of a captioner at phase 6's width, the images)."""
    t0 = time.monotonic()
    rng = np.random.default_rng(MEDIA_SEED)
    img_dir = os.path.join(folder, "capimgs")
    os.makedirs(img_dir)
    words = ["w%04d" % i for i in range(CAPTION_WORDS - 3)]
    n_caps = CAPTION_MEDIA * CAPTION_PER_IMAGE
    per = -(-len(words) // n_caps)
    images, annotations, media = [], [], []
    for i in range(CAPTION_MEDIA):
        name = "COCO_val2014_%012d.ppm" % (i + 1)
        path = os.path.join(img_dir, name)
        export_mod.write_ppm(path, rng.integers(0, 256, RAW_HW + (3,),
                                                np.uint8))
        media.append(path)
        images.append({"id": i + 1, "file_name": name})
        for j in range(CAPTION_PER_IMAGE):
            k = (i * CAPTION_PER_IMAGE + j) * per
            annotations.append({"image_id": i + 1, "caption": " ".join(
                words[k:k + per])})
    ann = os.path.join(folder, "captions10.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    glove = os.path.join(folder, "glove10.txt")
    vecs = rng.standard_normal((len(words), CAPTION_DIM)) * 0.1
    with open(glove, "w") as f:
        for w, row in zip(words, vecs):
            f.write(w + " " + " ".join("%.4f" % x for x in row) + "\n")
    doc = {"caption_files": [ann], "caption_file_formats": ["coco"],
           "vocabulary_file": None, "word_count_thresh": None,
           "caption_max_length": CAPTION_T - 1, "embeddings_file": glove,
           "randomize_missing_embeddings": True}
    cfg = os.path.join(folder, "captions10_cfg.json")
    with open(cfg, "w") as f:
        json.dump({"captions": doc}, f)
    vocab = process_annotations.main(["process_annotations", cfg])
    doc["vocabulary_file"] = vocab
    with open(cfg, "w") as f:
        json.dump({"captions": doc}, f)
    encoded = process_annotations.main(["process_annotations", cfg])[0]
    emb = produce_vocab_embeddings.main(["produce_vocab_embeddings", cfg])
    with open(vocab) as f:
        n_words = len(f.read().split())
    if n_words != CAPTION_WORDS:
        raise AssertionError("vocabulary of %d words" % n_words)
    serialize.main(["serialize", pack_config(
        folder, "capt10", encoded, path_prepend_folder=img_dir,
        clip_offset_or_num=1, num_frames_per_clip=1,
        clipframe_mode="defs.clipframe_mode.iterative")])
    data_path = os.path.join(folder, "capt10", os.path.basename(encoded))
    size = records.read_size_file(data_path + ".tfrecord.size")
    if size["items"] != n_caps or size["labelcount"] != CAPTION_T - 1:
        raise AssertionError(".size of the caption set %s" % size)
    run = {
        "resume_file": None, "run_folder": os.path.join(folder, "run10c"),
        "run_id": "phase10c", "phase": "defs.phase.val", "seed": 0,
        "mesh_shape": {"data": 1}, "compute_dtype": "bfloat16",
        "data": {"caps": {
            "data_path": data_path, "prepend_folder": "",
            "raw_image_shape": "(%d, %d, 3)" % RAW_HW,
            "image_shape": "(%d, %d, 3)" % (IMAGE, IMAGE),
            "mean_image": list(SERVING_MEAN),
            "data_format": "defs.data_format.tfrecord",
            "frame_format": "ppm",
            "imgproc": ["defs.imgproc.center_crop", "defs.imgproc.sub_mean"],
            "batch_item": "defs.batch_item.default",
            "phase": "defs.phase.val", "tag": "defs.dataset_tag.main",
            "device_preprocess": True}},
        "network": {"num_classes": CAPTION_WORDS, "pipelines": [
            {"frames": {"input": "defs.dataset_tag.main",
                        "representation": "defs.representation.dcnn",
                        "frame_encoding_layer": "fc7"}},
            {"capt": {"input": "frames",
                      "representation": "defs.representation.nop",
                      "classifier": "defs.classifier.lstm",
                      "lstm_params": [512, 1, "defs.fusion_method.avg",
                                      "defs.rnn_visual_mode.state_bias"]}}]},
        "val": {"batch_size": CAPTION_MEDIA, "logits_save_interval": -1},
        "captioning": {"caption_search": "defs.caption_search.max",
                       "eval_type": "defs.eval_type.coco",
                       "word_embeddings_file": emb},
        "logging": {"level": "logging.WARN"}}
    path = os.path.join(folder, "caption10.json")
    with open(path, "w") as f:
        json.dump({"run": run}, f, indent=1)
    results["media_caption_prep_s"] = time.monotonic() - t0
    log("  caption preprocessing: %d annotations over %d images, a "
        "%d-word vocabulary, %d-d embeddings, %d captions packed, in %.1f s"
        % (n_caps, CAPTION_MEDIA, n_words, CAPTION_DIM, size["items"],
           results["media_caption_prep_s"]))
    return path, media


def media_caption(results, folder):
    """Caption preprocessing, then ``infer`` of a fresh captioner at
    phase 6's width (greedy, T from the packed set's .size) and its
    export: the artifact's token ids equal infer's."""
    cfg, media = caption_media(results, folder)
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut(), \
            _PerCall(val_mod.Validation, "run_forward",
                     ("lrn", "lstm_step")) as fwd:
        rows = infer_mod.main([cfg, "--media"] + media + [
            "--checkpoint", "none", "--workdir",
            os.path.join(folder, "infer10c")])
    wall = time.monotonic() - t0
    total = counts()
    if len(fwd.calls) != 1 or total != CAPTION_WANT or \
            len(rows) != CAPTION_MEDIA or \
            not all(isinstance(r["caption"], str) for r in rows):
        raise AssertionError("caption infer: %d batches launched %s, %d rows"
                             % (len(fwd.calls), total, len(rows)))
    feed, ids = fwd.last[2], fwd.out
    path = os.path.join(folder, "export10_caption.zip")
    t1 = time.monotonic()
    meta = export_mod.export(cfg, path, "none",
                             batch_items=[CAPTION_MEDIA],
                             workdir=os.path.join(folder, "x_caption"))
    export_s = time.monotonic() - t1
    module, out, first_ms = call_artifact(path, feed, CAPTION_WANT)
    if meta["output"]["kind"] != "token_ids" or \
            not np.array_equal(out, ids) or \
            module.captions_from_ids(out) != [r["caption"] for r in rows]:
        raise AssertionError("caption artifact ids differ from infer's")
    results["media_caption"] = {
        "infer_wall_s": wall, "captions_per_s": CAPTION_MEDIA / wall,
        "launches": total, "export_s": export_s,
        "first_call_ms": first_ms, "first_caption": rows[0]["caption"]}
    log("  caption infer: %d captions in %.2f s (%.2f captions/s end to "
        "end, packing included), launched %s; export %.2f s, the "
        "artifact's token ids = infer's, first call %.1f ms"
        % (len(rows), wall, CAPTION_MEDIA / wall, total, export_s,
           first_ms))


def phase_media(results, folder, train_path):
    """Phase 10: media to answer, in phase 8's folder with phase 9's
    config and checkpoint."""
    log("phase 10: packing, inference on raw media and export")
    val_path = os.path.join(folder, "videos.val")
    cfg = os.path.join(folder, "val9.json")
    t0 = time.monotonic()
    vids, listing = write_media(folder, MEDIA_SEED)
    results["media_write_s"] = time.monotonic() - t0
    log("  wrote %d folders of %d .ppm frames in %.1f s"
        % (MEDIA_VIDEOS, MEDIA_FRAMES, results["media_write_s"]))
    media_pack(results, folder, listing)
    feed, logits = media_infer(results, folder, cfg, vids)
    media_card_vs_cpu(results, folder, train_path, val_path, vids)
    torch.cuda.empty_cache()
    media_export(results, folder, cfg, feed, logits)
    torch.cuda.empty_cache()
    media_caption(results, folder)


# ---------------------------------------------------------------- main
# ------------------------------------------------------------- phase 11
GRAPH_CLIPS = 8         # clips of the float32 graphed-vs-eager steps
DROPOUT_CLIPS = 32      # clips of the float32 steps whose masks are read
GRAPH_STEPS = 3         # steps compared, and the compared scan's length
SCAN_STEPS = 6          # steps of the timed compile_scan_steps program
GRAPH_BUCKETS = [1, 8, 32]
GRAPH_WATCH = ["clf/output_fc/w"]
# the float32 step's two configurations
GRAPH_CONFIGS = {"adam_ema_watch": {"flagship": {"optimizer": "adam",
                                                 "base_lr": 1e-4},
                                    "train": {"ema_decay": 0.9},
                                    "watch": GRAPH_WATCH},
                 "sgd_accum_steps_2": {"train": {"accum_steps": 2}}}


def replay_counts(what, eager_fn, graphed_fn, want, program):
    """The kernels that one replay of ``program`` (``graphed_fn``) runs,
    counted from the profiler's kernel records by symbol (``_Meter``,
    which also holds them to what the capture recorded), against
    ``want``; the replay launches nothing from Python, and an eager call
    of the same program (``eager_fn``) launches ``want`` by its
    wrappers' counts."""
    full = dict.fromkeys(KERNEL_SYMBOLS, 0)
    full.update(want)
    with _PlainLockedOut():
        reset_counts()
        replays = program.replays
        graphed_fn()
        torch.cuda.synchronize()
        replay = dict(_METER.kernels)
        python = {k: _WRAPPERS[k].launches for k in want}
        metered = (_METER.replays, program.replays - replays)
        reset_counts()
        eager_fn()
        torch.cuda.synchronize()
        eager = counts(tuple(want))
    log("  %s: a replay ran %s (profiler); an eager call launched %s "
        "(wrappers)" % (what, replay, eager))
    if replay != full or eager != want or metered != (1, 1) or \
            any(python.values()):
        raise AssertionError("%s: replay %s, eager %s, launched from "
                             "Python in the replay %s, replays %s, "
                             "expected %s" % (what, replay, eager, python,
                                              metered, want))
    return replay


def train_program(engine, kind):
    """A Train's captured program of ``kind`` (("step",) or ("scan",
    n)) and the static feed buffers it reads."""
    cache = engine.graph_cache
    for (key, sig), (program, _) in cache.programs().items():
        if key == kind:
            return program, cache.static_inputs(sig)
    raise AssertionError("no %s program was captured" % (kind,))


def _within(share, want, n, what):
    """A share of n draws within 5 sigma of ``want``."""
    sigma = math.sqrt(want * (1 - want) / n)
    if not abs(share - want) <= 5 * sigma:
        raise AssertionError("%s: %.4f of %d, expected %.2f +- 5 x %.4f"
                             % (what, share, n, want, sigma))


def dropout_on_card(results):
    """The card's dropout held to its definition (the graphed-vs-eager
    checks hold the card to itself): two eager float32 steps of
    DROPOUT_CLIPS clips on one feed with dropout 0.5 and accum_steps 2,
    each mask read where the model calls ``layers.dropout``.  Every kept
    unit is exactly x / 0.5 and every other one 0; each mask keeps a
    share within 5 sigma of 0.5; the two micro-batches' masks, and the
    masks of the two steps, agree on a share within 5 sigma of 0.5 (masks
    drawn alike would agree everywhere); the engine's generators (one per
    micro-batch and pipeline) start from distinct seeds."""
    settings, model = training_flagship(DROPOUT_CLIPS, "float32")
    settings.train.dropout_keep_prob = 0.5
    settings.train.accum_steps = 2
    engine = Train(settings, settings.feeder, model, seed=0, device="cuda",
                   graphs=False)
    processor = settings.feeder.datasets[0].processor
    feed = training_feed(processor, DROPOUT_CLIPS, 80, "cuda")
    calls = []
    plain = pipeline_mod.dropout

    def recording(generator, x, keep_prob):
        y = plain(generator, x, keep_prob)
        calls.append((x.detach().clone(), y.detach().clone(), keep_prob))
        return y

    pipeline_mod.dropout = recording
    try:
        for _ in range(2):
            engine.run_step(dict(feed))
    finally:
        pipeline_mod.dropout = plain
    torch.cuda.synchronize()
    if len(calls) != 4 or any(kp != 0.5 for *_, kp in calls):
        raise AssertionError("%d dropout calls (keep %s), expected 2 "
                             "micro-batches x 2 steps at 0.5"
                             % (len(calls), [kp for *_, kp in calls]))
    masks = []
    for i, (x, y, kp) in enumerate(calls):
        live = x != 0
        kept = y != 0
        if not torch.equal(y[kept], (x / kp)[kept]) or \
                bool((y[~kept] != 0).any()):
            raise AssertionError("dropout call %d: a kept unit is not x / "
                                 "%.1f" % (i, kp))
        n = int(live.sum())
        _within(float((kept & live).sum()) / n, kp, n,
                "dropout call %d, kept share" % i)
        masks.append((kept, live))

    def agree(a, b, what):
        both = a[1] & b[1]
        n = int(both.sum())
        share = float(((a[0] == b[0]) & both).sum()) / n
        _within(share, 0.5, n, what)
        return share

    row = {"units_per_call": int(calls[0][0].numel()),
           "kept_share": [float(m[0].float().mean()) for m in masks],
           "micro_batches_agree": agree(masks[0], masks[1],
                                        "micro-batch masks agree"),
           "steps_agree": agree(masks[0], masks[2], "step masks agree")}
    seeds = [g.initial_seed() for gens in engine._dropout_gens
             for g in gens]
    if len(set(seeds)) != len(seeds):
        raise AssertionError("dropout generators share seeds: %s" % seeds)
    log("  dropout 0.5 on the card, 2 steps x 2 micro-batches of %d units: "
        "kept %s, kept units exactly x / 0.5; micro-batch masks agree on "
        "%.4f, step masks on %.4f (independent: 0.5); %d generators, "
        "distinct seeds" % (row["units_per_call"],
                            ["%.4f" % v for v in row["kept_share"]],
                            row["micro_batches_agree"], row["steps_agree"],
                            len(seeds)))
    results["graphs_dropout_on_card"] = row
    del engine
    torch.cuda.empty_cache()


def graph_engines(opts, with_graphed=True, mesh=None):
    """A float32 eager engine and a graphed one at GRAPH_CLIPS clips,
    dropout 0.5, from one seed, on ``mesh`` if given; the graphed one has
    run its warmup steps and one replay and is then restored to the eager
    one's state (a restore after the capture).  Without
    ``with_graphed``: (eager, None, processor)."""
    engines = []
    for graphs in (False, True)[:1 + with_graphed]:
        settings, model = training_flagship(GRAPH_CLIPS, "float32",
                                            **opts.get("flagship", {}))
        settings.train.dropout_keep_prob = 0.5
        for k, v in opts.get("train", {}).items():
            setattr(settings.train, k, v)
        settings.remat = opts.get("remat", False)
        settings.watch_tensors = opts.get("watch")
        engines.append(Train(settings, settings.feeder, model, seed=0,
                             device="cuda", graphs=graphs, mesh=mesh))
    processor = settings.feeder.datasets[0].processor
    if not with_graphed:
        return engines[0], None, processor
    eager, graphed = engines
    for s in range(WARMUP_STEPS + 1):
        graphed.run_step(training_feed(processor, GRAPH_CLIPS, 40 + s,
                                       "cuda"))
    graphed.load_state_dict(eager.state_dict())
    return eager, graphed, processor


def state_parts(state):
    """{part/name: tensor} of a ``Train.state_dict``: the parameters, the
    EMA and the optimizer's optax leaves by index."""
    out = {"opt_state_leaves/%d" % i: v
           for i, v in enumerate(state["opt_state_leaves"])}
    for part in ("params", "ema_params"):
        out.update({part + "/" + k: v
                    for k, v in state.get(part, {}).items()})
    return out


def states_agree(what, eager, graphed, start):
    """Every parameter, moment, count and EMA tensor of the graphed
    engine within 1e-3 x its largest eager update + 1e-7 x its max|value|
    of the eager one's (``start``: a ``state_dict`` before the updates;
    ``eager`` and ``graphed``: engines or their ``state_dict``s); returns
    whether all are bitwise equal and the worst error as a share of its
    update."""
    se, sg = [state_parts(e if isinstance(e, dict) else e.state_dict())
              for e in (eager, graphed)]
    start = state_parts(start)
    if sorted(se) != sorted(sg):
        raise AssertionError("%s: the states hold other names" % what)
    bitwise, worst = True, 0.0
    for k, v in se.items():
        g = sg[k]
        bitwise = bitwise and torch.equal(v, g)
        if not v.is_floating_point():
            if not torch.equal(v, g):
                raise AssertionError("%s: %s differs" % (what, k))
            continue
        moved = float((v - start[k]).abs().max())
        err = float((g - v).abs().max())
        if err > 1e-3 * moved + 1e-7 * float(v.abs().max()):
            raise AssertionError("%s: %s differs by %.3g (moved %.3g)"
                                 % (what, k, err, moved))
        worst = max(worst, err / moved if moved else 0.0)
    return bitwise, worst


def metrics_agree(what, me, mg):
    for k, v in me.items():
        g = np.asarray(mg[k])
        v = np.asarray(v)
        if k == "accuracy":
            ok = np.array_equal(g, v)
        else:
            ok = np.allclose(g, v, rtol=1e-5,
                             atol=1e-7 * max(1.0, float(np.abs(v).max())))
        if not ok:
            raise AssertionError("%s: %s %s (graphed) vs %s (eager)"
                                 % (what, k, g, v))
    return all(np.array_equal(np.asarray(mg[k]), np.asarray(v))
               for k, v in me.items())


def graphed_step_vs_eager(results):
    """Two configurations (Adam with an EMA and a watched tensor; SGD
    with accum_steps 2), GRAPH_STEPS steps each, then compile_scan_steps
    against the eager loop, with the launch counts of each program."""
    out = {}
    want = {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
            "conv1_dw": 0, "conv1_dw_shifted": 1}
    for name, opts in GRAPH_CONFIGS.items():
        accum = opts.get("train", {}).get("accum_steps", 1)
        eager, graphed, processor = graph_engines(opts)
        start = eager.state_dict()
        feeds = [training_feed(processor, GRAPH_CLIPS, 50 + s, "cuda")
                 for s in range(GRAPH_STEPS)]
        equal = True
        for i, feed in enumerate(feeds):
            equal &= metrics_agree("%s step %d" % (name, i),
                                   eager.run_step(dict(feed)),
                                   graphed.run_step(dict(feed)))
        bitwise, worst = states_agree(name, eager, graphed, start)
        program, _ = train_program(graphed, ("step",))
        log("  float32 %d-clip step, %s, dropout 0.5: %d replays after a "
            "restore equal the eager steps (metrics bitwise %s; state "
            "bitwise %s, worst %.3g of an update)"
            % (GRAPH_CLIPS, name, GRAPH_STEPS, equal, bitwise, worst))
        row = {"metrics_bitwise": bool(equal), "state_bitwise": bitwise,
               "worst_share_of_update": worst}
        row["launches"] = replay_counts(
            "training step (%s)" % name,
            lambda: eager.run_step(dict(feeds[0])),
            lambda: graphed.run_step(dict(feeds[0])),
            {k: accum * v for k, v in want.items()}, program)
        if name == "adam_ema_watch":
            row["scan"] = scan_vs_eager(eager, graphed, feeds[0], want)
        out[name] = row
        del eager, graphed
        torch.cuda.empty_cache()
    results["graphs_equality"] = out


def scan_vs_eager(eager, graphed, feed, want):
    """compile_scan_steps(GRAPH_STEPS) as one graph against the eager
    loop with the same dropout stream (seeded once per call, drawn on
    step after step), from one state."""
    graphed.compile_scan_steps(GRAPH_STEPS)(dict(feed))    # eager warmup
    graphed.load_state_dict(eager.state_dict())
    start = eager.state_dict()
    me = eager.compile_scan_steps(GRAPH_STEPS)(dict(feed))
    mg = graphed.compile_scan_steps(GRAPH_STEPS)(dict(feed))
    equal = metrics_agree("compile_scan_steps", me, mg)
    bitwise, worst = states_agree("compile_scan_steps", eager, graphed,
                                  start)
    log("  compile_scan_steps(%d) as one graph vs the eager loop: losses "
        "%s; metrics bitwise %s, state bitwise %s (worst %.3g of an update)"
        % (GRAPH_STEPS, list(mg["loss"]), equal, bitwise, worst))
    program, _ = train_program(graphed, ("scan", GRAPH_STEPS))
    scan = eager.compile_scan_steps(GRAPH_STEPS)
    graphed_scan = graphed.compile_scan_steps(GRAPH_STEPS)
    launched = replay_counts(
        "compile_scan_steps(%d)" % GRAPH_STEPS, lambda: scan(dict(feed)),
        lambda: graphed_scan(dict(feed)),
        {k: GRAPH_STEPS * v for k, v in want.items()}, program)
    return {"metrics_bitwise": bool(equal), "state_bitwise": bitwise,
            "worst_share_of_update": worst, "launches": launched}


def caption_params():
    """Phase 6's captioner (bf16) and its float32 twin over one set of
    random parameters on the card."""
    settings, model = caption_flagship(batch_size=CAPTION_ITEMS)
    s32, m32 = caption_flagship(batch_size=CAPTION_ITEMS,
                                compute_dtype="float32")
    params = model.init_params(seed=0, device="cuda")
    return (settings, model), (s32, m32), params


def graphed_decode_vs_eager(model32, params, results):
    """Greedy and beam-4 tokens of CAPTION_ITEMS items in float32, graphed
    (``val.ForwardGraphs``, a replay) against eager
    (``val.serving_forward``), equal except from a step where the eager
    decoder's choice lies within 1e-4 of a tie (phase 6's rule, on the
    margins ``decode_margins`` records)."""
    settings, model = model32
    dset = model.caption_dataset
    T = caption_sizes(model)[0]
    pre = {"frames_main_input": make_preprocessor(
        dset.processor, out_dtype=torch.float32, device="cuda")}
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 60, "cuda")
    feed = {"frames_main_input": frames,
            "frames_main_input/proc_params": prm}
    fwd = val_mod.ForwardGraphs()
    eos = dset.vocabulary.index("EOS")
    ref = decode_margins(model, params, {"frames_main_input": pre[
        "frames_main_input"](frames, prm)}, eos)
    out = {}
    settings.captioning.beam_width = BEAM
    for search, key in (("max", "greedy"), ("beam", "beam")):
        settings.captioning.caption_search = search

        def graphed():
            return fwd(model, pre, params, dict(feed), decode=True)

        def eager():
            return val_mod.serving_forward(model, pre, params, dict(feed),
                                           decode=True)

        graphed()                                   # warmup and capture
        ids = graphed().cpu().numpy()
        diff = first_difference(ids, eager().cpu().numpy())
        tie = None
        if diff is not None:
            tie = ref["tie_" + key](*diff)
            if not tie:
                raise AssertionError("graphed %s tokens differ at a decided "
                                     "step %s" % (key, diff))
        program = list(fwd.cache.programs().values())[-1][0]
        launched = replay_counts(
            "%s decode of %d items" % (key, CAPTION_ITEMS), eager, graphed,
            {"lrn": 2, "lstm_step": T}, program)
        log("  float32 %s decode of %d items, graphed vs eager: tokens %s"
            % (key, CAPTION_ITEMS, "equal" if diff is None else
               "differ first at item %d step %d, within a tie" % diff))
        out[key] = {"first_difference": diff, "launches": launched}
    settings.captioning.caption_search = "max"
    results["graphs_decode_equality"] = out


def graphed_buckets_vs_eager(results):
    """The classifier's serving forward at buckets 1, 8 and 32 in float32
    and int8_static: graphed modules (``warmup()`` captures) against
    eager ones, logits within 1e-5 x max(1, max|logit|)."""
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                               lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                               mean_scalars=SERVING_MEAN,
                               imgproc=SERVING_IMGPROC,
                               compute_dtype="float32")
    processor = settings.feeder.datasets[0].processor
    params = model.init_params(seed=0, device="cuda")
    calib = device_frames(processor, INT8_CALIB_CLIPS * FPC, 70, "cuda")
    frames, prm = device_frames(processor, max(GRAPH_BUCKETS) * FPC, 72,
                                "cuda")
    out = {}
    for mode in (None, "int8_static"):
        kw = {"calib_feed": calib} if mode else {}
        graphed = serving.ServingModule(model, params,
                                        batch_items=GRAPH_BUCKETS,
                                        device="cuda", quantize=mode, **kw)
        if mode:
            kw = {"act_ranges": graphed.meta["act_ranges"]}
        eager = serving.ServingModule(model, params,
                                      batch_items=GRAPH_BUCKETS,
                                      device="cuda", quantize=mode,
                                      graphs=False, **kw)
        graphed.warmup()
        errs = {}
        for clips in GRAPH_BUCKETS:
            n = clips * FPC
            got = graphed(frames[:n], prm[:n])
            want = eager(frames[:n], prm[:n])
            scale = max(1.0, float(np.abs(want).max()))
            errs[clips] = float(np.abs(got - want).max()) / scale
            if not errs[clips] <= 1e-5:
                raise AssertionError("%s bucket %d: graphed logits differ "
                                     "by %.3g of the scale"
                                     % (mode or "float32", clips,
                                        errs[clips]))
        want = {"lrn": 2, "lstm_step": FPC * LAYERS}
        if mode:
            want["int8_mm"] = INT8_MM_PER_FORWARD
        n = SERVE_CLIPS * FPC
        program = graphed.graphs.cache.programs()
        program = [p for p, *_ in program.values()][-1]
        launched = replay_counts(
            "%s forward of %d clips" % (mode or "float32", SERVE_CLIPS),
            lambda: eager(frames[:n], prm[:n]),
            lambda: graphed(frames[:n], prm[:n]), want, program)
        log("  %s serving forward, buckets %s, graphed vs eager: worst "
            "%s of the logit scale" % (mode or "float32", GRAPH_BUCKETS,
                                        errs))
        out[mode or "float32"] = {"rel_err": errs, "launches": launched}
        del graphed, eager
    results["graphs_bucket_equality"] = out
    torch.cuda.empty_cache()


def alternating(what, fns, reps, n_items, unit):
    """Mean seconds per call of each of {"eager": fn, "graphed": fn}, in
    turns eager, graphed, graphed, eager (host clock around calls that
    end in a sync, after timed_s's two warm calls); logs the rates."""
    secs = {k: [] for k in fns}
    for k in ("eager", "graphed", "graphed", "eager"):
        secs[k].append(timed_s(fns[k], reps))
    sec = {k: float(np.mean(v)) for k, v in secs.items()}
    log("  %s: eager %.3f ms (%.1f %s/s), graphed %.3f ms (%.1f %s/s)"
        % (what, sec["eager"] * 1e3, n_items / sec["eager"], unit,
           sec["graphed"] * 1e3, n_items / sec["graphed"], unit))
    return sec


def program_record(program, what, fn, sec, top=6):
    """Capture time, pool memory and the idle share of one profiled
    replay (1 - kernel time / the timed wall time of a call)."""
    rows = {}
    prof = profile_rows(what, fn, sec, rows, "p", top=top)
    idle = 1.0 - rows["p_kernel_us_total"] / (sec * 1e6)
    log("  %s: captured in %.2f s, pool +%.2f GB, card idle %.0f%% of a "
        "replay" % (what, program.capture_s, program.pool_bytes / 1e9,
                    100 * idle))
    return {"capture_s": program.capture_s,
            "pool_gb": program.pool_bytes / 1e9, "idle_share": idle,
            "kernel_us": rows["p_kernel_us_total"]}, prof


def time_training(results):
    """The 128-clip bf16 step, eager first; then the graphed step and
    compile_scan_steps(SCAN_STEPS) on the same engine's state.  The two
    forms do not run in turns here: the eager step's 37 GB of
    activations and the graph's pool would nearly fill the card."""
    settings, model = training_flagship(TRAIN_CLIPS, "bfloat16")
    processor = settings.feeder.datasets[0].processor
    feeds = [training_feed(processor, TRAIN_CLIPS, s, "cuda")
             for s in (1, 2)]
    engine = Train(settings, settings.feeder, model, seed=0, device="cuda",
                   graphs=False)
    torch.cuda.reset_peak_memory_stats()
    step = [0]

    def run():
        engine.run_step(dict(feeds[step[0] % 2]))
        step[0] += 1

    eager_s = timed_s(run, 4)
    torch.cuda.synchronize()
    del run
    engine.graphs = True            # the same state, now captured
    torch.cuda.empty_cache()
    for _ in range(WARMUP_STEPS + 1):
        engine.run_step(dict(feeds[0]))

    def run_graphed():
        engine.run_step(dict(feeds[step[0] % 2]))
        step[0] += 1

    graphed_s = timed_s(run_graphed, 4)
    log("  %d-clip bf16 training step: eager %.2f ms (%.1f clips/s), "
        "graphed %.2f ms (%.1f clips/s)"
        % (TRAIN_CLIPS, eager_s * 1e3, TRAIN_CLIPS / eager_s,
           graphed_s * 1e3, TRAIN_CLIPS / graphed_s))
    program, static = train_program(engine, ("step",))
    rec, _ = program_record(program, "the graphed %d-clip step"
                            % TRAIN_CLIPS, run_graphed, graphed_s)
    row = dict(rec, eager_ms=eager_s * 1e3, graphed_ms=graphed_s * 1e3,
               eager_clips_per_s=TRAIN_CLIPS / eager_s,
               graphed_clips_per_s=TRAIN_CLIPS / graphed_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    nbytes = sum(v.numel() * v.element_size() for v in static.values())
    row["feed_copy_ms"] = _events_ms(
        lambda: [static[k].copy_(v) for k, v in feeds[1].items()], 10)
    row["feed_copy_gb"] = nbytes / 1e9
    log("  copy of a %.3f GB feed into the captured buffers: %.3f ms "
        "(%.0f GB/s)" % (nbytes / 1e9, row["feed_copy_ms"],
                         nbytes / 1e6 / row["feed_copy_ms"]))
    many = engine.compile_scan_steps(SCAN_STEPS)
    many(dict(feeds[0]))                            # eager warmup
    many(dict(feeds[0]))                            # capture and replay
    scan_s = timed_s(lambda: many(dict(feeds[0])), 2)
    scan, _ = train_program(engine, ("scan", SCAN_STEPS))
    rec, _ = program_record(scan, "compile_scan_steps(%d)" % SCAN_STEPS,
                            lambda: many(dict(feeds[0])), scan_s)
    row["scan"] = dict(rec, steps=SCAN_STEPS,
                       ms_per_step=scan_s * 1e3 / SCAN_STEPS)
    log("  compile_scan_steps(%d) at %d clips: %.2f ms a step (%.1f "
        "clips/s)" % (SCAN_STEPS, TRAIN_CLIPS, scan_s * 1e3 / SCAN_STEPS,
                      TRAIN_CLIPS * SCAN_STEPS / scan_s))
    results["graphs_train_step"] = row
    del engine, many
    torch.cuda.empty_cache()


def time_captioning(model_bf16, params, results):
    """Greedy decodes at 1, 8, 32 and 64 items and beam-4 at 64, and the
    64-caption training step: eager and graphed in turns."""
    settings, model = model_bf16
    dset = model.caption_dataset
    pre = {"frames_main_input": make_preprocessor(
        dset.processor, out_dtype=model.compute_dtype, device="cuda")}
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 61, "cuda")
    fwd = val_mod.ForwardGraphs()
    out = {}
    settings.captioning.beam_width = BEAM
    for search, sizes in (("max", (1, 8, 32, CAPTION_ITEMS)),
                          ("beam", (CAPTION_ITEMS,))):
        settings.captioning.caption_search = search
        for n in sizes:
            feed = {"frames_main_input": frames[:n],
                    "frames_main_input/proc_params": prm[:n]}
            fns = {"eager": lambda: val_mod.serving_forward(
                       model, pre, params, dict(feed), decode=True),
                   "graphed": lambda: fwd(model, pre, params, dict(feed),
                                          decode=True)}
            what = "%s decode of %d items" % (
                "greedy" if search == "max" else "beam-%d" % BEAM, n)
            sec = alternating(what, fns, 6, n, "captions")
            program = list(fwd.cache.programs().values())[-1][0]
            rec, prof = program_record(program, "graphed " + what,
                                       fns["graphed"], sec["graphed"],
                                       top=4)
            row = dict(rec, eager_captions_per_s=n / sec["eager"],
                       graphed_captions_per_s=n / sec["graphed"])
            lstm = [ev for ev in prof.key_averages()
                    if re.search(KERNEL_SYMBOLS["lstm_step"], ev.key)]
            if lstm:
                row["lstm_step_us_per_launch"] = \
                    lstm[0].self_device_time_total / lstm[0].count
                log("  lstm_step inside the graphed %s: %.2f us a launch "
                    "(%d launches)" % (what, row["lstm_step_us_per_launch"],
                                       lstm[0].count))
            out["%s_%d" % ("greedy" if search == "max" else "beam", n)] = \
                row
    settings.captioning.caption_search = "max"
    results["graphs_decode"] = out

    engines = {}
    for graphs in (False, True):
        engines[graphs] = Train(settings, settings.feeder, model,
                                params=params, device="cuda",
                                graphs=graphs)
    feed = caption_train_feed(settings, model, 0, "cuda")
    fns = {"eager": lambda: engines[False].run_step(dict(feed)),
           "graphed": lambda: engines[True].run_step(dict(feed))}
    for _ in range(WARMUP_STEPS + 1):
        fns["graphed"]()
    sec = alternating("%d-caption training step" % CAPTION_ITEMS, fns, 4,
                      CAPTION_ITEMS, "captions")
    program, _ = train_program(engines[True], ("step",))
    rec, _ = program_record(program, "the graphed %d-caption step"
                            % CAPTION_ITEMS, fns["graphed"],
                            sec["graphed"])
    results["graphs_caption_train"] = dict(
        rec, eager_ms=sec["eager"] * 1e3, graphed_ms=sec["graphed"] * 1e3,
        eager_captions_per_s=CAPTION_ITEMS / sec["eager"],
        graphed_captions_per_s=CAPTION_ITEMS / sec["graphed"])
    del engines, fns
    torch.cuda.empty_cache()


def time_serving(results):
    """The bf16 serving forward at buckets 1, 8 and 32: a graphed module
    and an eager one in turns."""
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                               lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                               mean_scalars=SERVING_MEAN,
                               imgproc=SERVING_IMGPROC,
                               compute_dtype="bfloat16")
    processor = settings.feeder.datasets[0].processor
    params = model.init_params(seed=0, device="cuda")
    modules = {"graphed": serving.ServingModule(
        model, params, batch_items=GRAPH_BUCKETS, device="cuda"),
        "eager": serving.ServingModule(model, params,
                                       batch_items=GRAPH_BUCKETS,
                                       device="cuda", graphs=False)}
    modules["graphed"].warmup()
    frames, prm = device_frames(processor, max(GRAPH_BUCKETS) * FPC, 73,
                                "cuda")
    programs = [p for p, *_ in
                modules["graphed"].graphs.cache.programs().values()]
    out = {}
    for clips, program in zip(GRAPH_BUCKETS, programs):
        n = clips * FPC
        fns = {k: (lambda m=m: m(frames[:n], prm[:n]))
               for k, m in modules.items()}
        sec = alternating("bf16 serving forward at bucket %d" % clips, fns,
                          6, clips, "clips")
        rec, _ = program_record(program, "the graphed bucket %d" % clips,
                                fns["graphed"], sec["graphed"], top=4)
        out[clips] = dict(rec, eager_ms=sec["eager"] * 1e3,
                          graphed_ms=sec["graphed"] * 1e3,
                          eager_clips_per_s=clips / sec["eager"],
                          graphed_clips_per_s=clips / sec["graphed"])
    results["graphs_serving"] = out
    del modules
    torch.cuda.empty_cache()


def phase_graphs(results):
    log("phase 11: CUDA graphs against the eager programs (float32, TF32 "
        "off, cuDNN deterministic), then eager and graphed times (bf16)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the eager float32 step is not reproducible by itself: cuDNN's
    # default backward algorithms add with atomics, and this random net
    # turns their last-bit differences into different relu decisions
    # (two eager runs' gradient norms part by up to 13% at the third
    # step); with deterministic algorithms eager, eager again and the
    # replay agree bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        dropout_on_card(results)
        graphed_step_vs_eager(results)
        graphed_buckets_vs_eager(results)
        model_bf16, model32, params = caption_params()
        graphed_decode_vs_eager(model32, params, results)
    finally:
        torch.backends.cudnn.deterministic = False
    time_captioning(model_bf16, params, results)
    del params
    torch.cuda.empty_cache()
    time_serving(results)
    time_training(results)


# ------------------------------------------------------------- phase 12
# Four ranks of one card: gloo collectives on cuda:0 (NCCL refuses two
# ranks on one device).  They measure the code, not multi-GPU scaling.
MESH_SHAPE = {"data": 2, "model": 2}
MESH_CLIPS = 128        # global clips of a mesh step (64 per data rank)
MESH_TAIL_VALID = 96    # the tail's label_mask ones: its zeros on data 1
MESH_FWD_CLIPS = 16     # global clips of the mesh forwards
MESH_TIME_STEPS = 3     # bf16 steps timed on the mesh
MESH_WANT = {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
             "conv1_dw": 0, "conv1_dw_shifted": 1}
# the float32 configurations held to the single-process step
MESH_CONFIGS = {"sgd": ({}, {}),
                "adam": ({"optimizer": "adam"},
                         {"ema_decay": 0.99, "accum_steps": 2})}
# the card every rank runs on (gloo lets them share it)
MESH_DEVICE = "cuda:0"
# what phase 12 writes into phase 8's folder: two reference states (~1.3
# GB), two artifacts, two or three checkpoints of ~0.5 GB
MESH_BYTES = 4 << 30


def _float32_exact():
    """TF32 off and cuDNN's deterministic algorithms: float32 runs to
    compare (the eager float32 step is not reproducible without them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def mesh_feed(processor, device):
    """The global feed of the float32 mesh steps: an epoch tail whose
    label_mask zeros all fall on data rank 1."""
    feed = training_feed(processor, MESH_CLIPS, 120, device)
    mask = torch.zeros(MESH_CLIPS, dtype=torch.float32, device=device)
    mask[:MESH_TAIL_VALID] = 1.0
    feed["label_mask"] = mask
    return feed


def mesh_start_params(model, device):
    """The seed-0 parameters with fc6's and fc7's kernels scaled by 1/600
    and 1/8, so that fc7's outputs are O(1) and not O(1e3): at the fresh
    init the LSTM's gates saturate, where a float32 rounding difference
    grows by the saturation's slope and the gradient is rounding noise
    (the first mesh step's gradient norm parted from one process's by
    3e-3 on one H100), as ``test_torch_run_task.py``'s weights
    file keeps them out of saturation."""
    params = model.init_params(0, device=device)
    dcnn = params["frames"]["dcnn"]
    with torch.no_grad():
        dcnn["fc6"]["w"].mul_(1.0 / 600)
        dcnn["fc7"]["w"].mul_(1.0 / 8)
    return params


def mesh_engine(name, clips, compute_dtype, device, mesh=None, split=1):
    """A float32 (or bf16) engine of configuration ``name`` from
    ``mesh_start_params``; ``split`` multiplies its accum_steps (one
    process holding the mesh's micro-batches: the data ranks' rows, each
    cut as a rank cuts them)."""
    kw, opts = MESH_CONFIGS[name]
    settings, model = training_flagship(clips, compute_dtype, **kw)
    settings.train.dropout_keep_prob = 1.0
    for k, v in opts.items():
        setattr(settings.train, k, v)
    settings.train.accum_steps = \
        int(getattr(settings.train, "accum_steps", 1) or 1) * split
    return Train(settings, settings.feeder, model, seed=0, device=device,
                 graphs=False, mesh=mesh,
                 params=mesh_start_params(model, device))


class _CollectiveMeter:
    """Times every all_reduce and all_gather of torch.distributed (a
    sync before and after each) and counts its bytes."""

    def __enter__(self):
        import torch.distributed as dist
        self.dist = dist
        self.saved = (dist.all_reduce, dist.all_gather)
        self.s, self.bytes, self.calls = 0.0, 0, 0

        def timed(fn, nbytes):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.s += time.monotonic() - t0
                self.bytes += nbytes(*args)
                self.calls += 1
                return out
            return run

        dist.all_reduce = timed(self.saved[0],
                                lambda t, *a: t.numel() * t.element_size())
        dist.all_gather = timed(self.saved[1], lambda parts, t, *a: sum(
            p.numel() * p.element_size() for p in parts))
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce, self.dist.all_gather = self.saved


def _collectives_exact(mesh, device):
    """all_reduce SUM and MAX, all_gather and broadcast of CUDA tensors
    over gloo, each against its exact result."""
    import torch.distributed as dist
    r, n = mesh.rank, mesh.size
    base = torch.arange(1024, dtype=torch.float32, device=device)
    t = base * (r + 1)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    ok = torch.equal(t, base * (n * (n + 1) // 2))
    t = base * (r + 1)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    ok = ok and torch.equal(t, base * n)
    parts = [torch.empty_like(base) for _ in range(n)]
    dist.all_gather(parts, base + r)
    ok = ok and all(torch.equal(p, base + i) for i, p in enumerate(parts))
    t = base + r
    dist.broadcast(t, 0)
    ok = ok and torch.equal(t, base)
    if not ok:
        raise AssertionError("a gloo collective on CUDA tensors is not "
                             "exact")
    return ["all_reduce SUM", "all_reduce MAX", "all_gather", "broadcast"]


def _mesh_states_agree(name, ref, got, start, adaptive):
    """The gathered mesh state against the single-process one, tensor by
    tensor, as a share of each tensor's largest single-process update
    (``moved``).  Held: the train tests' rule (``test_torch_train.py``),
    every element within 2% of ``moved`` + 1e-6 x max|value| for SGD; for
    Adam, whose step moves every element by about lr whatever its
    gradient (an element whose gradient is rounding noise may step the
    other way), every element within two updates and at most 1% beyond
    10% of one.  Reported: phase 11's rule (1e-3 x ``moved`` + 1e-7 x
    max|value|), which a program held to itself meets, and the elements
    beyond it."""
    worst, beyond, n, failed = 0.0, 0, 0, []
    ref, got, start = state_parts(ref), state_parts(got), state_parts(start)
    for k, v in ref.items():
        g = got[k]
        if not v.is_floating_point():
            if not torch.equal(v, g):
                failed.append("%s: %s vs %s" % (k, g, v))
            continue
        moved = float((v - start[k]).abs().max())
        diff = (g - v).abs()
        vmax = float(v.abs().max())
        beyond += int((diff > 1e-3 * moved + 1e-7 * vmax).sum())
        n += diff.numel()
        worst = max(worst, float(diff.max()) / moved if moved else 0.0)
        if adaptive:
            atol = 1e-6 * vmax
            ok = float(diff.max()) <= 2.0 * moved + atol and float(
                (diff > 0.1 * moved + atol).float().mean()) <= 0.01
        else:
            ok = float(diff.max()) <= 0.02 * moved + 1e-6 * vmax
        if not ok:
            failed.append("%s: %.3g (moved %.3g)"
                          % (k, float(diff.max()), moved))
    return {"worst_share_of_update": worst,
            "elements_beyond_phase11_rule": beyond, "elements": n,
            "failed": failed}


def _metrics_agree(name, ref, got):
    out = {}
    for step, (r, g) in enumerate(zip(ref, got)):
        for k, v in r.items():
            rel = abs(g[k] - v) / max(abs(v), 1e-30)
            out["%d/%s" % (step, k)] = rel
            if k == "accuracy" and g[k] != v:
                raise AssertionError("%s step %d accuracy %s vs %s"
                                     % (name, step, g[k], v))
    return out


def mesh_rank(device, folder, consts=None):
    """One of the 4 ranks of phase 12 on a (2, 2) mesh: the collectives;
    the float32 SGD and Adam steps (rank 0 holds the gathered state to the
    single-process one); launch counts; the float32, int8 and int8_static
    forwards (the int8 activations recorded); bf16 steps timed."""
    from video_learning_tpu_torch.parallel.mesh import make_mesh, shard_feed
    globals().update(consts or {})
    _float32_exact()
    mesh = make_mesh(MESH_SHAPE)
    out = {"rank": mesh.rank, "collectives": _collectives_exact(mesh,
                                                                device)}
    out["steps"] = {}
    for name in MESH_CONFIGS:
        engine = mesh_engine(name, MESH_CLIPS // mesh.data, "float32",
                             device, mesh)
        processor = engine.settings.feeder.datasets[0].processor
        start = engine.state_dict()
        m, launched = locked_step(engine, shard_feed(
            mesh_feed(processor, device), mesh))
        metrics = [m]
        want = {k: v * engine._accum for k, v in MESH_WANT.items()}
        if launched != want:
            raise AssertionError("rank %d %s step launched %s, want %s"
                                 % (mesh.rank, name, launched, want))
        state = engine.state_dict()
        res = {"metrics": metrics, "launches": launched}
        if mesh.rank == 0:
            ref = torch.load(os.path.join(folder, "ref_%s.pt" % name))
            res["metrics_rel"] = _metrics_agree(name, ref["metrics"],
                                                metrics)
            res["state"] = _mesh_states_agree(name, ref["state"], state,
                                              start, name == "adam")
        out["steps"][name] = res
        del engine, start, state
        torch.cuda.empty_cache()

    # forwards of the start params on this rank's rows
    settings, model = training_flagship(MESH_FWD_CLIPS // mesh.data,
                                        "float32")
    settings.mesh_shape = MESH_SHAPE
    processor = settings.feeder.datasets[0].processor
    params = model.init_params(0, device=device)
    feed = shard_feed(training_feed(processor, MESH_FWD_CLIPS, 130, device),
                      mesh)
    out["forward"] = {}
    for mode in (None,) + INT8_MODES:
        settings.val.quantize = mode
        val = val_mod.Validation(settings, model, device=device, mesh=mesh)
        reset_counts()
        with _Quantizations() as q, _PlainLockedOut():
            rows = val.run_forward(params, dict(feed))
        if mode and mesh.model_index == 0:
            torch.save(q.taken, os.path.join(
                folder, "int8_%s_d%d.pt" % (mode, mesh.data_index)))
        out["forward"][str(mode)] = {"rows": rows.tolist(),
                                     "launches": counts(("lrn", "lstm_step",
                                                         "int8_mm"))}
    del params, val
    torch.cuda.empty_cache()

    # bf16 steps for time
    engine = mesh_engine("sgd", MESH_CLIPS // mesh.data, "bfloat16", device,
                         mesh)
    processor = engine.settings.feeder.datasets[0].processor
    feed = shard_feed(training_feed(processor, MESH_CLIPS, 140, device),
                      mesh)
    timed = []
    for s in range(MESH_TIME_STEPS + 1):
        torch.cuda.synchronize()
        with _CollectiveMeter() as cm:
            t0 = time.monotonic()
            m, c = locked_step(engine, feed)
            wall = time.monotonic() - t0
        if c != MESH_WANT:
            raise AssertionError("bf16 mesh step launched %s" % c)
        if s:                       # the first step is the warmup
            timed.append({"wall_ms": wall * 1e3,
                          "collective_ms": cm.s * 1e3,
                          "collective_bytes": cm.bytes,
                          "collective_calls": cm.calls,
                          "loss": m["loss"]})
    out["bf16_steps"] = timed
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mesh_rank_pair(device, folder, cfg, arrays_path, consts=None):
    """One of the 2 ranks of phase 12's second group: phase 6's captioner
    in float32 on a (1, 2) mesh (greedy and beam-4 tokens of
    CAPTION_ITEMS items), then a ``--mesh data=2`` export of phase 9's
    checkpoint through ``cfg`` (its float32 twin), loaded in this group
    and called on the saved arrays."""
    from video_learning_tpu_torch.parallel.mesh import make_mesh
    globals().update(consts or {})
    _float32_exact()
    settings, model = caption_flagship(batch_size=CAPTION_ITEMS,
                                       compute_dtype="float32")
    params = model.init_params(seed=0, device=device)
    dset = model.caption_dataset
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 60, device)
    feed = {"frames_main_input": frames,
            "frames_main_input/proc_params": prm}
    val = val_mod.Validation(settings, model, device=device,
                             mesh=make_mesh({"data": 1, "model": 2}))
    out = {"tokens": {}}
    settings.captioning.beam_width = BEAM
    for search in ("max", "beam"):
        settings.captioning.caption_search = search
        reset_counts()
        with _PlainLockedOut():
            ids = val.run_forward(params, dict(feed), decode=True)
        out["tokens"][search] = ids.tolist()
        out.setdefault("decode_launches", {})[search] = counts()
    del params, val
    torch.cuda.empty_cache()

    path = os.path.join(folder, "export12_mesh.zip")
    t0 = time.monotonic()
    meta = export_mod.export(cfg, path, "latest",
                             batch_items=EXPORT_BUCKETS, use_ema=True,
                             mesh_shape={"data": 2}, device=device,
                             workdir=os.path.join(folder, "x12"))
    out["export_s"] = time.monotonic() - t0
    module = serving.load(path, device=device)
    with np.load(arrays_path) as z:
        arrays = [z[i["name"].replace("/", "_")]
                  for i in module.meta["inputs"]]
    reset_counts()
    with _PlainLockedOut():
        logits = module(*arrays)
    out.update(meta_mesh=meta.get("mesh"), loaded_mesh=module.meta["mesh"],
               bucket=module.last_bucket, logits=logits.tolist(),
               artifact_launches=counts())
    return out


def mesh_references(folder):
    """The single-process float32 steps and forward the mesh is held to,
    on the card, saved for the ranks; returns the forward's inputs and
    model.  The step of one process on the global batch is the masked
    mean either way; it runs as the mesh's micro-batches (accum_steps x
    the data size), so that cuDNN sees the same batches on both sides
    and what differs is the mesh: its split kernels, its sums."""
    _float32_exact()
    for name in MESH_CONFIGS:
        engine = mesh_engine(name, MESH_CLIPS, "float32", "cuda",
                             split=MESH_SHAPE["data"])
        processor = engine.settings.feeder.datasets[0].processor
        metrics = [engine.run_step(mesh_feed(processor, "cuda"))]
        torch.save({"metrics": metrics, "state": engine.state_dict()},
                   os.path.join(folder, "ref_%s.pt" % name))
        del engine
        torch.cuda.empty_cache()
    settings, model = training_flagship(MESH_FWD_CLIPS, "float32")
    processor = settings.feeder.datasets[0].processor
    feed = training_feed(processor, MESH_FWD_CLIPS, 130, "cuda")
    return settings, model, feed


def mesh_forwards_vs_one(results, ranks, settings, model, feed, folder):
    """Each rank's float32 rows within 1e-3 x max(1, max|logit|) of the
    single-process forward's; each int8 mode's rows within that of a
    single-process run of the global batch that takes the mesh's int8
    activations (its data ranks' rows joined), every flip at a near
    tie (phase 7's rule)."""
    params = model.init_params(0, device="cuda")
    report = {}
    for mode in (None,) + INT8_MODES:
        settings.val.quantize = mode
        val = val_mod.Validation(settings, model, device="cuda",
                                 graphs=False)
        if mode is None:
            want = val.run_forward(params, dict(feed))
            flips = None
        else:
            recs = [torch.load(os.path.join(folder, "int8_%s_d%d.pt"
                                            % (mode, d)))
                    for d in range(MESH_SHAPE["data"])]
            forced = []
            for layer in zip(*recs):
                if not all(torch.equal(layer[0][1], r[1]) for r in layer):
                    raise AssertionError("%s: the data ranks' activation "
                                         "scales differ" % mode)
                forced.append((torch.cat([r[0] for r in layer]).cuda(),
                               layer[0][1].cuda()))
            with _Quantizations(forced) as q:
                want = val.run_forward(params, dict(feed))
            flips = q.report
            if not all(f["max_tie_distance"] < 1e-3 for f in flips):
                raise AssertionError("%s: an int8 activation differs mesh "
                                     "vs one process away from a tie: %s"
                                     % (mode, flips))
        scale = max(1.0, float(np.abs(want).max()))
        per = want.shape[0] // MESH_SHAPE["data"]
        err = 0.0
        for res in ranks:
            d = res["rank"] // MESH_SHAPE["model"]
            got = np.asarray(res["forward"][str(mode)]["rows"], np.float32)
            err = max(err, float(np.abs(got - want[d * per:(d + 1) * per])
                                 .max()))
        # int8_static's first forward also runs its float calibration
        want_launch = {k: v * (2 if mode == "int8_static" else 1)
                       for k, v in VAL_WANT.items()}
        want_launch["int8_mm"] = INT8_MM_PER_FORWARD if mode else 0
        for res in ranks:
            if res["forward"][str(mode)]["launches"] != want_launch:
                raise AssertionError("%s mesh forward launched %s"
                                     % (mode, res["forward"][str(mode)]))
        log("  float32 %s forward of %d clips, each rank's rows vs one "
            "process%s: max abs %.3g (tolerance %.3g)"
            % (mode or "float", MESH_FWD_CLIPS,
               " on the mesh's int8 activations" if mode else "", err,
               1e-3 * scale))
        if not err <= 1e-3 * scale:
            raise AssertionError("%s mesh forward vs one process: %g"
                                 % (mode, err))
        report[str(mode)] = {"max_abs": err, "flips": flips}
    results["mesh_forwards"] = report


def mesh_caption_vs_one(results, pair):
    """The (1, 2) captioner's tokens equal the single-process ones on
    both ranks, except from a step where the single-process choice lies
    within 1e-4 of a tie (phase 6's rule)."""
    _float32_exact()
    settings, model = caption_flagship(batch_size=CAPTION_ITEMS,
                                       compute_dtype="float32")
    params = model.init_params(seed=0, device="cuda")
    dset = model.caption_dataset
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 60, "cuda")
    pre = make_preprocessor(dset.processor, out_dtype=torch.float32,
                            device="cuda")
    ref = decode_margins(model, params,
                         {"frames_main_input": pre(frames, prm)},
                         dset.vocabulary.index("EOS"))
    T = caption_sizes(model)[0]
    report = {}
    for search, key in (("max", "greedy"), ("beam", "beam")):
        diffs = []
        for res in pair:
            got = np.asarray(res["tokens"][search])
            diff = first_difference(got, ref[key])
            if diff is not None and not ref["tie_" + key](*diff):
                raise AssertionError("(1, 2) %s tokens differ at a decided "
                                     "step %s" % (key, diff))
            if res["decode_launches"][search] != {"lrn": 2,
                                                  "lstm_step": T}:
                raise AssertionError("(1, 2) %s decode launched %s"
                                     % (key, res["decode_launches"]))
            diffs.append(diff)
        report[key] = diffs
        log("  float32 %s decode of %d items on a (1, 2) mesh vs one "
            "process: %s" % (key, CAPTION_ITEMS, "tokens equal" if
                             diffs == [None, None] else "first difference "
                             "%s, within a tie" % diffs))
    results["mesh_caption"] = report
    del params
    torch.cuda.empty_cache()


def mesh_export_arrays(folder, work):
    """A float32 twin of phase 9's val config (``val12f.json``: in bf16
    the mesh's half batches would meet other cuDNN algorithms than the
    whole one, whose rounding is not the mesh's), its single-process
    export (phase 10's buckets, EMA weights) called on RUN_VAL_ITEMS
    items of seeded frames; the arrays are saved for the ranks.  Returns
    (the config, the arrays' path, the logits)."""
    with open(os.path.join(folder, "val9.json")) as f:
        doc = json.load(f)
    doc["run"]["compute_dtype"] = "float32"
    cfg = os.path.join(folder, "val12f.json")
    with open(cfg, "w") as f:
        json.dump(doc, f)
    one = os.path.join(work, "export12_one.zip")
    export_mod.export(cfg, one, "latest", batch_items=EXPORT_BUCKETS,
                      use_ema=True, workdir=os.path.join(work, "x12one"))
    module = serving.load(one)
    rs = np.random.RandomState(12)
    dset = module.model.settings.feeder.datasets[0]
    arrays = {}
    for spec in module.meta["inputs"]:
        rows = spec["shape"][0]
        if spec["dtype"] == "uint8":
            arrays[spec["name"]] = rs.randint(0, 256, spec["shape"],
                                              np.uint8)
        else:
            arrays[spec["name"]] = dset.processor.draw_params(
                rows, random.Random(12)).astype(spec["dtype"])
    logits = module(*[arrays[i["name"]] for i in module.meta["inputs"]])
    path = os.path.join(work, "arrays12.npz")
    np.savez(path, **{k.replace("/", "_"): v for k, v in arrays.items()})
    del module
    torch.cuda.empty_cache()
    return cfg, path, logits


def _torchrun(folder, cfg, logdir, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="4",
               PYTHONPATH=os.pathsep.join(
                   [p for p in (os.path.dirname(os.path.abspath(
                       __file__)), os.environ.get("PYTHONPATH")) if p]))
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", logdir, "--redirects", "3",
         "-m", "video_learning_tpu_torch.run_task", cfg, "--device",
         MESH_DEVICE, "--backend", "gloo"],
        cwd=folder, env=env, capture_output=True, text=True,
        timeout=timeout)
    wall = time.monotonic() - t0
    logs = {}
    for path in glob.glob(os.path.join(logdir, "**", "stderr.log"),
                          recursive=True):
        rank = int(os.path.basename(os.path.dirname(path)))
        with open(path) as f:
            logs[rank] = f.read()
    if res.returncode != 0:
        raise AssertionError("torch.distributed.run of %s failed (%d):\n%s"
                             "\n%s" % (cfg, res.returncode,
                                       res.stderr[-4000:],
                                       "\n".join(v[-4000:] for v in
                                                 logs.values())))
    losses = {r: [float(x) for x in re.findall(
        r"batch loss/nats : ([0-9.eE+-]+) /", text)]
        for r, text in logs.items()}
    return wall, losses


def mesh_run_task(results, folder, train_path, val_path):
    """``run_task`` as 2 ranks (``torch.distributed.run``, gloo on
    cuda:0) on phase 8's packed set: a train epoch with an inline eval,
    each artifact written once and equal loss streams; a val phase; a
    resume that continues at the right global step."""
    rf = os.path.join(folder, "run12")
    over = dict(run_folder=rf, run_id="phase12", mesh_shape={"data": 2},
                logging={"save_freq_per_epoch": 1, "level": "logging.INFO"})
    got = {}
    for what, name, phase, extra in (
            ("train", "train12.json", "train", {}),
            ("val", "val12.json", "val", {}),
            ("resume", "resume12.json", "train",
             {"resume_file": "latest"})):
        cfg = run_config(folder, name, phase, train_path, val_path,
                         **dict(over, **extra))
        if what == "resume":
            with open(cfg) as f:
                doc = json.load(f)
            doc["run"]["train"]["epochs"] = 2
            with open(cfg, "w") as f:
                json.dump(doc, f)
        wall, losses = _torchrun(folder, cfg, os.path.join(folder,
                                                           "logs_" + what))
        got[what] = {"wall_s": wall, "losses": losses}
        if phase == "train":
            if sorted(losses) != [0, 1] or losses[0] != losses[1] or \
                    not losses[0]:
                raise AssertionError("%s: the ranks' loss streams %s"
                                     % (what, losses))
        log("  run_task %s on 2 ranks: %.1f s, losses %s"
            % (what, wall, losses.get(0)))
    ckpts = sorted(glob.glob(os.path.join(rf, "checkpoints", "*_gs_*.ckpt")))
    progress = [os.path.basename(c).split("_", 2)[2] for c in ckpts]
    files = sorted(glob.glob(os.path.join(rf, "tensorboard", "train",
                                          "metrics_*.jsonl")),
                   key=os.path.getmtime)
    steps = [[json.loads(line)["step"] for line in open(f)
              if "loss" in json.loads(line)] for f in files]
    totals = glob.glob(os.path.join(rf, "validation_logits_*.total"))
    accs = glob.glob(os.path.join(rf, "accuracy_*phase12*"))
    n_train = len(got["train"]["losses"][0])
    checks = {
        "checkpoints_once": 0 < len(set(progress)) == len(progress),
        "snaps": all(os.path.exists(c + ".snap") for c in ckpts),
        "eval_state": os.path.exists(os.path.join(rf, "checkpoints",
                                                  "eval_state.json")),
        "one_metrics_file_per_run": len(files) == 2,
        "resume_steps": steps == [list(range(1, n_train + 1)),
                                  list(range(n_train + 1,
                                             2 * n_train + 1))],
        "one_total": len(totals) == 1 and
        len(pickle_rows(totals[0])) == RUN_VAL_VIDEOS,
        "accuracy_files": len(accs) == 2,
        "no_tmp": not glob.glob(os.path.join(rf, "**", "*.tmp"),
                                recursive=True)}
    got["checks"] = checks
    results["mesh_run_task"] = got
    log("  run_task artifacts: %s; metrics steps %s" % (checks, steps))
    if not all(checks.values()):
        raise AssertionError("run_task on 2 ranks: %s" % checks)


def pickle_rows(path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def phase_mesh(results, folder, train_path):
    """Phase 12: the (data x model) mesh as ranks sharing the card."""
    log("phase 12: a mesh of gloo ranks sharing %s (this measures the "
        "code, not multi-GPU scaling)" % torch.cuda.get_device_name(0))
    work = os.path.join(folder, "mesh12")
    os.makedirs(work)
    t0 = time.monotonic()
    settings, model, feed = mesh_references(work)
    torch.cuda.empty_cache()
    results["mesh_reference_s"] = time.monotonic() - t0
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    ranks = launch.run(4, "chip_smoke:mesh_rank", {"folder": work},
                       device=MESH_DEVICE, backend="gloo", timeout=900,
                       threads=2, path=here)
    results["mesh_ranks_s"] = time.monotonic() - t0
    failures = []
    steps = {}
    for name in MESH_CONFIGS:
        rel = ranks[0]["steps"][name]["metrics_rel"]
        state = ranks[0]["steps"][name]["state"]
        losses = [[m["loss"] for m in r["steps"][name]["metrics"]]
                  for r in ranks]
        if any(l != losses[0] for l in losses):
            raise AssertionError("%s: the ranks' losses differ: %s"
                                 % (name, losses))
        worst = max(rel.values())
        steps[name] = {"metrics_rel": rel, "state": state,
                       "launches": ranks[0]["steps"][name]["launches"]}
        log("  float32 %s steps on (2, 2) vs one process: metrics worst "
            "relative %.3g (%s), state worst %.3g of an update, %d of %d "
            "elements beyond phase 11's rule; launches per step %s"
            % (name, worst, max(rel, key=rel.get),
               state["worst_share_of_update"],
               state["elements_beyond_phase11_rule"], state["elements"],
               ranks[0]["steps"][name]["launches"]))
        if state["failed"]:
            failures.append("%s mesh state vs one process: %s"
                            % (name, state["failed"]))
        first = max(v for k, v in rel.items() if k.startswith("0/"))
        if (worst if name == "sgd" else first) > 1e-5:
            failures.append("%s mesh metrics vs one process beyond 1e-5 "
                            "relative: %s" % (name, rel))
    results["mesh_steps"] = steps
    mesh_forwards_vs_one(results, ranks, settings, model, feed, work)
    timing = []
    for r in ranks:
        rows = r["bf16_steps"]
        n = len(rows)
        timing.append({
            "rank": r["rank"], "peak_gb": r["peak_bytes"] / 1e9,
            "wall_ms": sum(x["wall_ms"] for x in rows) / n,
            "collective_ms": sum(x["collective_ms"] for x in rows) / n,
            "collective_mb": rows[0]["collective_bytes"] / 1e6,
            "collective_calls": rows[0]["collective_calls"]})
        t = timing[-1]
        log("  bf16 step of %d clips a data rank, rank %d: %.1f ms wall, "
            "%.1f ms in %d collectives of %.1f MB (%.2f GB/s), peak "
            "%.1f GB" % (MESH_CLIPS // MESH_SHAPE["data"], t["rank"],
                         t["wall_ms"], t["collective_ms"],
                         t["collective_calls"], t["collective_mb"],
                         t["collective_mb"] / max(t["collective_ms"], 1e-9),
                         t["peak_gb"]))
    results["mesh_bf16_steps"] = timing
    del settings, model, feed
    torch.cuda.empty_cache()

    cfg, arrays, single = mesh_export_arrays(folder, work)
    t0 = time.monotonic()
    pair = launch.run(2, "chip_smoke:mesh_rank_pair", {
        "folder": work, "cfg": cfg,
        "arrays_path": arrays}, device=MESH_DEVICE, backend="gloo",
        timeout=600, threads=4, path=here)
    results["mesh_pair_s"] = time.monotonic() - t0
    mesh_caption_vs_one(results, pair)
    scale = max(1.0, float(np.abs(single).max()))
    err = max(float(np.abs(np.asarray(p["logits"]) - single).max())
              for p in pair)
    for p in pair:
        if p["meta_mesh"] != {"data": 2, "model": 1} or \
                p["loaded_mesh"] != {"data": 2, "model": 1}:
            raise AssertionError("mesh export meta %s" % p)
        if p["artifact_launches"] != VAL_WANT:
            raise AssertionError("mesh artifact launched %s"
                                 % p["artifact_launches"])
    results["mesh_export"] = {"max_abs": err, "export_s": pair[0]["export_s"],
                              "bucket": pair[0]["bucket"]}
    log("  --mesh data=2 float32 export (%.1f s), loaded in a 2-rank group: "
        "logits vs the single-process artifact's max abs %.3g (tolerance "
        "%.3g)"
        % (pair[0]["export_s"], err, 1e-3 * scale))
    if not err <= 1e-3 * scale:
        failures.append("mesh artifact vs single: %g" % err)
    torch.backends.cudnn.deterministic = False
    mesh_run_task(results, folder, train_path,
                  os.path.join(folder, "videos.val"))
    if failures:
        raise AssertionError("phase 12: %s" % failures)


# ------------------------------------------------------------ phase 13
# the tools' run: tens of videos (the cut of phases 8-9's sets), 2 epochs
# of 2 steps saving each epoch, so that there are 2 checkpoints
TOOLS_TRAIN_VIDEOS, TOOLS_BATCH = 32, 16
TOOLS_VAL_VIDEOS, TOOLS_VAL_CPV, TOOLS_VAL_ITEMS = 8, 2, 4
TOOLS_DECAY = ["defs.decay.exp", "defs.periodicity.drops", 2, 0.5]
TOOLS_SEED = 13
AUDIO_SHAPE, AUDIO_CLASSES = (64, 48, 3), 7


def ablation_want():
    """(row, launches per call) of profile_ablation's stage rows in the
    JAX tool's order, and of its --per-layer rows, at phase 5's width."""
    n = TRAIN_CLIPS * FPC
    rows = [("preprocess (crop+mean+mir)", {}),
            ("alexnet fwd (fc7)", {"lrn": 2}),
            ("alexnet fwd+bwd", {"lrn": 2, "lrn_bwd": 2,
                                 "conv1_dw_shifted": 1}),
            ("alexnet fwd+bwd, LRN=id", {"conv1_dw_shifted": 1}),
            ("lrn (%d, 57, 57, 96)" % n, {"lrn": 1}),
            ("lrn (%d, 28, 28, 256)" % n, {"lrn": 1}),
            ("lstm 2x256 fwd+bwd", {"lstm_step": FPC * LAYERS})]
    # conv1's weight gradient in every stack, then one LRN from lrn1 on
    # and two from lrn2 on, forward and backward
    per_layer = [(name, dict({"conv1_dw_shifted": 1}, **(
        {"lrn": 1, "lrn_bwd": 1} if 1 <= i <= 3 else
        {"lrn": 2, "lrn_bwd": 2} if i > 3 else {})))
        for i, name in enumerate(profile_ablation.LAYER_NAMES)]
    return rows, per_layer


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tools_pretrained(results, folder):
    """validate_pretrained on a synthesized 1000-class bvlc file: the
    manifest recorded (0), then matched (0), a modified file against it
    (1); each fixture forward launches its 2 LRN kernels; the card's fc6
    and fc7 against the CPU's in float32."""
    work = os.path.join(folder, "bvlc13")
    os.makedirs(work)
    weights = os.path.join(work, "bvlc_alexnet.npy")
    rng = np.random.default_rng(TOOLS_SEED)
    net = {layer: [rng.standard_normal(w, np.float32) * np.float32(0.01),
                   rng.standard_normal(b, np.float32) * np.float32(0.1)]
           for layer, (w, b) in validate_pretrained.BVLC_SHAPES.items()}
    np.save(weights, np.asarray(net, dtype=object), allow_pickle=True)
    del net
    modified = os.path.join(work, "modified.npy")
    shutil.copyfile(weights, modified)
    with open(modified, "r+b") as f:
        f.seek(os.path.getsize(modified) // 2)        # inside fc6's weights
        f.write(b"\x01" * 8)
    cpu = validate_pretrained.features(weights, "cpu")
    codes, launched = [], []
    t0 = time.monotonic()
    with _PlainLockedOut():
        reset_counts()
        card = validate_pretrained.features(weights, "cuda")
        launched.append(counts(("lrn",)))
        for argv in ([weights], [weights],
                     [modified, "--manifest", weights + ".manifest.json",
                      "--no-sidecar"]):
            reset_counts()
            codes.append(validate_pretrained.main(argv))
            launched.append(counts(("lrn",)))
    wall = time.monotonic() - t0
    errs = {layer: _normwise(card[layer], cpu[layer]) for layer in card}
    results["tools_pretrained"] = {"codes": codes, "launches": launched,
                                   "card_vs_cpu": errs, "wall_s": wall}
    log("  validate_pretrained: exit codes %s (recorded, matched, a "
        "modified file); lrn launched %s (features, then each run: 2 "
        "fixture forwards of 2 LRN); card vs CPU fc6 %.3g, fc7 %.3g "
        "normwise; %.1f s" % (codes, [c["lrn"] for c in launched],
                               errs["fc6"], errs["fc7"], wall))
    if codes != [0, 0, 1]:
        raise AssertionError("validate_pretrained exit codes %s" % codes)
    if launched != [{"lrn": 4}] * 4:
        raise AssertionError("validate_pretrained launched %s" % launched)
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError("fc6 / fc7 card vs CPU %s" % errs)


def tools_ablation(results):
    """profile_ablation at full width, both modes, with the plain
    versions locked out: every row finite and above 0, each row's
    launches per call as listed, every LRN backward the vector design."""
    log("  profile_ablation on %s: %d clips x %d frames of 240x320 uint8, "
        "crop 227, bf16" % (gpu_line(), TRAIN_CLIPS, FPC))
    width = ["--batch-clips", str(TRAIN_CLIPS), "--fpc", str(FPC)]
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut():
        rows = profile_ablation.main(width)
        layers_ = profile_ablation.main(width + ["--per-layer"])
    wall = time.monotonic() - t0
    want_rows, want_layers = ablation_want()
    designs = dict(lrn_mod.lrn_backward.variant_launches)
    bwd = lrn_mod.lrn_backward.launches
    approx = (rows[0][1] + rows[2][1] + rows[-1][1]) * 1e3
    results["tools_ablation"] = {
        "rows": [list(r) for r in rows], "per_layer": [list(r)
                                                       for r in layers_],
        "approx_step_ms": approx, "wall_s": wall, "lrn_bwd": designs}
    log("  approx step (pre + alexnet-grad + lstm-grad) %.2f ms against "
        "phase 5's measured step %.2f ms (recorded, not held); both modes "
        "in %.1f s; LRN backward designs %s"
        % (approx, results["train_step_ms"], wall, designs))
    for name, sec, launched in rows:
        log("    %-28s %8.3f ms  %s" % (name, sec * 1e3, launched))
    for name, cum, delta, launched in layers_:
        log("    %-6s cum %8.3f ms  delta %8.3f ms  %s"
            % (name, cum * 1e3, delta * 1e3, launched))
    got = [(r[0], r[-1]) for r in rows]
    got_layers = [(r[0], r[-1]) for r in layers_]
    if got != want_rows or got_layers != want_layers:
        raise AssertionError("profile_ablation rows and launches %s %s, "
                             "expected %s %s" % (got, got_layers,
                                                 want_rows, want_layers))
    if not all(math.isfinite(r[1]) and r[1] > 0 for r in rows + layers_):
        raise AssertionError("profile_ablation times %s" % rows)
    if designs != {"staged": 0, "vector": bwd} or not bwd:
        raise AssertionError("LRN backward designs %s of %d" % (designs, bwd))


def _accuracy(run_folder, run_id):
    """The top-1 accuracy file a val run of ``run_id`` wrote."""
    (path,) = glob.glob(os.path.join(run_folder, "accuracy_%s_*" % run_id))
    with open(path) as f:
        return float(f.read())


def tools_evaluate(results, folder):
    """A short run_task run writes 2 checkpoints; each one's val phase
    run directly, then evaluate_multiple_checkpoints in process, with
    --only / --omit and once with --subprocess, and validate_checkpoints
    once, in float32 with TF32 off and cuDNN deterministic, give the same
    accuracies.  Returns (val config, checkpoints, val paths file, the
    first checkpoint's logits pickle, accuracies)."""
    work = os.path.join(folder, "data13")
    os.makedirs(work)
    train_path = pack_split(work, "videos.train", TOOLS_TRAIN_VIDEOS, 1,
                            TOOLS_SEED, "vid")
    val_path = pack_split(work, "videos.val", TOOLS_VAL_VIDEOS,
                          TOOLS_VAL_CPV, TOOLS_SEED + 1, "val")
    rf = os.path.join(folder, "run13")
    train = {"batch_size": TOOLS_BATCH, "epochs": 2,
             "optimizer": "defs.optim.sgd", "base_lr": 0.001,
             "lr_mult": "None", "clip_norm": 10, "dropout_keep_prob": 0.5,
             "ema_decay": 0.99, "eval_every_epochs": 1,
             "lr_decay": TOOLS_DECAY}
    reset_counts()
    t0 = time.monotonic()
    with _PlainLockedOut():
        run_task.main(run_config(folder, "train13.json", "train",
                                 train_path, val_path, TOOLS_VAL_ITEMS,
                                 run_folder=rf, run_id="phase13",
                                 train=train))
    train_s = time.monotonic() - t0
    ckpts = evaluate_multiple_checkpoints.filter_checkpoints(
        sorted(glob.glob(os.path.join(rf, "checkpoints", "*_gs_*.ckpt"))))
    epochs = [evaluate_multiple_checkpoints.checkpoint_epoch(c)
              for c in ckpts]
    if epochs != [1, 2]:
        raise AssertionError("checkpoints %s" % ckpts)
    names = [os.path.basename(c) for c in ckpts]

    def val_cfg(name, **over):
        return run_config(folder, name, "val", train_path, val_path,
                          TOOLS_VAL_ITEMS, run_folder=rf,
                          compute_dtype="float32", **over)

    def logits(run_id):
        """The logits a val run of ``run_id`` wrote (its .total)."""
        (path,) = glob.glob(os.path.join(
            rf, "validation_logits_%s_*.total" % run_id))
        return pickle_rows(path)

    def clear_logits():
        for path in glob.glob(os.path.join(rf, "validation_logits_phase13_"
                                               "*")):
            os.remove(path)

    torch.backends.cudnn.deterministic = True
    direct, direct_logits, runs, rows = {}, {}, [], {}
    t0 = time.monotonic()
    try:
        with _PlainLockedOut():
            for i, ck in enumerate(ckpts):
                reset_counts()
                run_task.main(val_cfg("val13d%d.json" % i, resume_file=ck,
                                      run_id="phase13d%d" % i))
                direct[names[i]] = _accuracy(rf, "phase13d%d" % i)
                direct_logits[names[i]] = logits("phase13d%d" % i)
                runs.append(("direct %d" % (i + 1), counts()))
            cfg = val_cfg("val13.json", run_id="phase13")
            one = os.path.join(folder, "ckpt13one")
            os.makedirs(one)
            for suffix in ("", ".snap"):
                os.link(ckpts[1] + suffix,
                        os.path.join(one, names[1] + suffix))
            evals = {}
            for what, call in (
                    ("in process", lambda: evaluate_multiple_checkpoints.main(
                        [cfg])),
                    ("--only 2", lambda: evaluate_multiple_checkpoints.main(
                        [cfg, "--only", "2"])),
                    ("--omit 2", lambda: evaluate_multiple_checkpoints.main(
                        [cfg, "--omit", "2"])),
                    ("validate_checkpoints", lambda: validate_checkpoints.main(
                        [cfg, one]))):
                reset_counts()
                clear_logits()
                evals[what] = call()
                runs.append((what, counts()))
                if len(evals[what]) == 1:
                    rows[what] = logits("phase13_val_resume")
        # the child takes no TF32 either: the libraries' own switch
        os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
        try:
            clear_logits()
            t1 = time.monotonic()
            what = "--subprocess --only 1"
            evals[what] = evaluate_multiple_checkpoints.main(
                [cfg, "--only", "1", "--subprocess"])
            sub_s = time.monotonic() - t1
            rows[what] = logits("phase13_val_resume")
        finally:
            del os.environ["NVIDIA_TF32_OVERRIDE"]
    finally:
        torch.backends.cudnn.deterministic = False
    wall = time.monotonic() - t0
    want = {"in process": direct, "--only 2": {names[1]: direct[names[1]]},
            "--omit 2": {names[0]: direct[names[0]]},
            "validate_checkpoints": {names[1]: direct[names[1]]},
            "--subprocess --only 1": {names[0]: direct[names[0]]}}
    # each one-checkpoint evaluation's logits against its direct run's:
    # bit for bit in this process, 1e-5 of the logit scale in the child
    diffs = {what: float(np.abs(got - direct_logits[next(iter(
        evals[what]))]).max()) for what, got in rows.items()}
    scale = max(1.0, max(float(np.abs(v).max())
                         for v in direct_logits.values()))
    results["tools_evaluate"] = {
        "checkpoints": names, "direct": direct, "evaluations": evals,
        "launches": runs, "train_s": train_s, "wall_s": wall,
        "subprocess_s": sub_s, "logit_diffs": diffs, "logit_scale": scale}
    log("  run_task trained 2 epochs of %d videos (%d a batch) in %.1f s "
        "and saved %s" % (TOOLS_TRAIN_VIDEOS, TOOLS_BATCH, train_s, names))
    log("  val phase of each checkpoint run directly: %s; "
        "evaluate_multiple_checkpoints: %s; 8 val runs in %.1f s (the "
        "--subprocess one %.1f s); launches per run (eager calls; graph "
        "replays run the rest) %s"
        % (direct, evals, wall, sub_s, runs))
    log("  max |logit - the direct run's| of each one-checkpoint "
        "evaluation %s (logit scale %.3g)" % (diffs, scale))
    if evals != want:
        raise AssertionError("evaluations %s, expected %s" % (evals, want))
    child = "--subprocess --only 1"
    if any(d != 0.0 for what, d in diffs.items() if what != child) or \
            not diffs[child] <= 1e-5 * scale or len(diffs) != 4:
        raise AssertionError("evaluation logits differ: %s" % diffs)
    if not all(c["lrn"] > 0 and c["lstm_step"] > 0 for _, c in runs):
        raise AssertionError("a val run launched no kernel: %s" % runs)
    (total,) = glob.glob(os.path.join(rf, "validation_logits_phase13d0_*"))
    return cfg, ckpts, val_path, total, direct


def _tfrecord_frames(path):
    """The payloads of a TFRecord file, each frame's length and masked
    CRC32C checked."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return out
            (n,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != export_tfrecord._masked_crc(header) or \
                    pcrc != export_tfrecord._masked_crc(payload) or \
                    len(payload) != n:
                raise AssertionError("record %d of %s: bad framing"
                                     % (len(out), path))
            out.append(payload)


def tools_host(results, folder, cfg, ckpts, val_path, logits_path, direct):
    """The host tools on the card's own artifacts: inspect and modify a
    checkpoint the card wrote (the modified one restores in run_task and
    evaluates as the original), combine_logits of a val run's logits with
    themselves (its accuracy at every weight), compute_evaluation_stats
    and view_logits_info on them, export_tfrecord of phase 10's caption
    image records, lr_calc against the schedule Train ran."""
    names = checkpoint.get_checkpoint_tensor_names(ckpts[0])
    inspect_checkpoint.main(["inspect_checkpoint", ckpts[0],
                             "params/frames/dcnn/conv1/w"])
    work = os.path.join(folder, "mod13")
    os.makedirs(work)
    modified = os.path.join(work, "modified.ckpt")
    flat = modify_checkpoint.modify(
        ckpts[0], modified,
        renames=[("params/clf/output_fc/b", "tmp/b")],
        regex_renames=[(r"^tmp/", "params/clf/output_fc/")],
        creates=[("extra/probe", "4,4")])
    if sorted(flat) != sorted(names + ["extra/probe"]) or \
            not os.path.exists(modified + ".snap"):
        raise AssertionError("modified checkpoint holds %s" % sorted(flat))
    torch.backends.cudnn.deterministic = True
    try:
        with _PlainLockedOut():
            run_task.main(run_config(
                folder, "val13m.json", "val", None, val_path,
                TOOLS_VAL_ITEMS, run_folder=os.path.join(folder, "run13"),
                compute_dtype="float32", resume_file=modified,
                run_id="phase13m"))
    finally:
        torch.backends.cudnn.deterministic = False
    restored = _accuracy(os.path.join(folder, "run13"), "phase13m")
    acc = direct[os.path.basename(ckpts[0])]
    (total,) = glob.glob(os.path.join(folder, "run13",
                                      "validation_logits_phase13m_*"))
    same_logits = bool(np.array_equal(pickle_rows(total),
                                      pickle_rows(logits_path)))

    sweep = combine_logits.combine([logits_path] * 2, [val_path] * 2)
    stats = compute_evaluation_stats.main(
        ["compute_evaluation_stats", logits_path, val_path, str(CLASSES)])
    seen = view_logits_info.main(["view_logits_info", logits_path])

    (record,) = glob.glob(os.path.join(folder, "capt10", "*.tfrecord"))
    tf_absent = importlib.util.find_spec("tensorflow") is None
    t0 = time.monotonic()
    out, n = export_tfrecord.convert(record, os.path.join(
        work, "captions.tf.tfrecord"))
    export_s = time.monotonic() - t0
    frames = _tfrecord_frames(out)
    size = records.read_size_file(record + ".size")

    sched = glob.glob(os.path.join(folder, "run13",
                                   "phase13_*_lr_decay_schedule.txt"))
    with open(sched[0]) as f:
        ran = [line.rsplit(" ", 1)[1] for line in f.read().splitlines()]
    decay = [defs.check(TOOLS_DECAY[0], defs.decay),
             defs.check(TOOLS_DECAY[1], defs.periodicity)] + TOOLS_DECAY[2:]
    projected = lr_calc.project(0.001, TOOLS_TRAIN_VIDEOS // TOOLS_BATCH, 2,
                                decay)
    results["tools_host"] = {
        "tensors": len(names), "restored_accuracy": restored,
        "restored_logits_equal": same_logits,
        "sweep": sweep, "stats_accuracy": stats["accuracy"],
        "logits_rows": sum(seen["histogram"].values()),
        "export": {"records": n, "size_items": size["items"],
                   "tensorflow_absent": tf_absent, "s": export_s},
        "lr": projected}
    log("  inspect_checkpoint: %d tensors; modify_checkpoint (rename, "
        "regex-rename, create) restores in run_task: accuracy %.4f "
        "(original %.4f), logits equal %s; combine_logits of a val "
        "run's logits with themselves: %s at every weight (the run: "
        "%.4f); "
        "compute_evaluation_stats %.4f; view_logits_info %d rows; "
        "export_tfrecord of phase 10's caption records: %d records "
        "(.size: %d), pure-Python framing (no tensorflow: %s), %.2f s; "
        "lr_calc %s = the schedule Train ran"
        % (len(names), restored, acc, same_logits,
           sorted({r[-1] for r in sweep}), acc,
           stats["accuracy"], sum(seen["histogram"].values()), n,
           size["items"], tf_absent, export_s,
           ["%.8f" % lr for lr in projected]))
    if restored != acc or not same_logits:
        raise AssertionError("the modified checkpoint evaluates %s (logits "
                             "equal: %s), the original %s"
                             % (restored, same_logits, acc))
    if {r[-1] for r in sweep} != {acc} or len(sweep) != 11 or \
            stats["accuracy"] != acc:
        raise AssertionError("combine_logits %s, stats %s, accuracy %s"
                             % (sweep, stats["accuracy"], acc))
    if sum(seen["histogram"].values()) != TOOLS_VAL_VIDEOS:
        raise AssertionError("view_logits_info %s" % seen)
    if not tf_absent or n != len(frames) or n != size["items"]:
        raise AssertionError("export_tfrecord: %d records, %d frames, "
                             ".size %s, tensorflow absent %s"
                             % (n, len(frames), size, tf_absent))
    if len(sched) != 1 or ran != ["%2.8f" % lr for lr in projected]:
        raise AssertionError("lr_calc %s, Train ran %s" % (projected, ran))


def tools_audionet(results):
    """audionet's forward on the card against the CPU, float32."""
    x = np.random.RandomState(TOOLS_SEED).randn(4, *AUDIO_SHAPE)
    x = torch.from_numpy(x.astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        params = audionet.init(torch.Generator().manual_seed(TOOLS_SEED),
                               AUDIO_SHAPE, AUDIO_CLASSES, device=device)
        with torch.no_grad():
            out[device] = audionet.apply(params, x.to(device)).cpu()
    err = _normwise(out["cuda"], out["cpu"])
    results["tools_audionet"] = {"card_vs_cpu": err}
    log("  audionet: logits of (4, %d, %d, %d) card vs CPU %.3g normwise "
        "(float32)" % (AUDIO_SHAPE + (err,)))
    if out["cuda"].shape != (4, AUDIO_CLASSES) or not err <= 1e-4:
        raise AssertionError("audionet card vs CPU %s" % err)


def phase_tools(results, folder):
    """Phase 13: the remaining tools and audionet on the card, in phase
    8's folder, without the profiler: graph replays run unmetered here
    (captures still with the plain versions locked out)."""
    log("phase 13: validate_pretrained, profile_ablation, "
        "evaluate_multiple_checkpoints, the host tools, audionet")
    graphs_mod.Program.replay = _REPLAY
    try:
        for what, step in (
                ("validate_pretrained", lambda: tools_pretrained(results,
                                                                 folder)),
                ("profile_ablation", lambda: tools_ablation(results))):
            t0 = time.monotonic()
            step()
            log("  %s took %.1f s" % (what, time.monotonic() - t0))
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        args = tools_evaluate(results, folder)
        tools_host(results, folder, *args)
        log("  the evaluation and the host tools took %.1f s"
            % (time.monotonic() - t0))
        tools_audionet(results)
    finally:
        graphs_mod.Program.replay = _metered_replay


# ------------------------------------------------------------ phase 14
# the resumed runs: Adam, an EMA and two tiers (lr_mult 2) on phase 5's
# training configuration; the uninterrupted run takes RESUME_STEPS steps,
# the resumed one is saved after RESUME_STEPS - 1 and takes the last
RESUME_STEPS = 3
RESUME_OPTS = {"optimizer": "adam", "lr_mult": 2.0, "base_lr": 1e-4}
RESUME_EMA = 0.99
RESUME_WANT = {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
               "conv1_dw": 0, "conv1_dw_shifted": 1}
# the served mesh artifact: phase 12's checkpoint in float32 on a (2, 2)
# mesh; one request from each of SERVE_CLIENTS clients (its items),
# started together (the 1-item ones coalesce in the batcher's window);
# the selftest SERVE_SELFTEST_S a size of SERVE_ITEMS
SERVE_MESH = {"data": 2, "model": 2}
SERVE_BUCKETS = [2, 8, 32]
SERVE_ITEMS = (1, 8, 32)
SERVE_CLIENTS = (1, 1, 1, 8, 32)
SERVE_WINDOW_MS = 50.0
SERVE_SELFTEST_S = 1.0
SERVE_SELFTEST_CONCURRENCY = 2


def resume_engine(clips, compute_dtype, graphs=None):
    """Phase 5's training configuration at ``clips`` clips with Adam, an
    EMA and two tiers, from seed 0."""
    settings, model = training_flagship(clips, compute_dtype, **RESUME_OPTS)
    settings.train.ema_decay = RESUME_EMA
    return Train(settings, settings.feeder, model, seed=0, device="cuda",
                 graphs=graphs)


def resume_run(what, clips, compute_dtype, folder, resumed_from_capture):
    """RESUME_STEPS steps of one engine (the uninterrupted run), its state
    saved by ``save_checkpoint`` before the last; a second engine
    restored from the file (``strict``) by ``load_state_dict`` takes the
    last step.  ``resumed_from_capture``: the second engine has captured
    its step on other feeds before the restore, so the resumed step is a
    replay into the restored tensors; else it is a fresh engine, whose
    resumed step runs eagerly and is counted by the wrappers with the
    plain versions locked out.  Returns the uninterrupted and the resumed
    engine's last metrics and states, the file's leaf names, the restored
    tiers' lr and the resumed step's launches."""
    a = resume_engine(clips, compute_dtype)
    processor = a.settings.feeder.datasets[0].processor
    feeds = [training_feed(processor, clips, 70 + s, "cuda")
             for s in range(RESUME_STEPS)]
    path = os.path.join(folder, "resume14_%s.ckpt" % what)
    for f in feeds[:-1]:
        a.run_step(dict(f))
    start = a.state_dict()
    t0 = time.monotonic()
    checkpoint.save_checkpoint(path, start)
    save_s = time.monotonic() - t0
    ref = a.run_step(dict(feeds[-1]))
    torch.cuda.synchronize()
    want = a.state_dict()
    leaves = len(a._opt_leaves)
    del a
    gc.collect()
    torch.cuda.empty_cache()

    b = resume_engine(clips, compute_dtype)
    if resumed_from_capture:
        for s in range(WARMUP_STEPS + 1):
            b.run_step(training_feed(processor, clips, 90 + s, "cuda"))
        if len(b.graph_cache) != 1:
            raise AssertionError("%s: no step was captured" % what)
    t0 = time.monotonic()
    loaded = []
    state = checkpoint.restore_checkpoint(path, b.state_dict(), strict=True,
                                          loaded_out=loaded)
    b.load_state_dict(state, restored_names=loaded)
    restore_s = time.monotonic() - t0
    lr = {tier: (float(t.lr(b.opt_state[tier]["count"])),
                 float(t.lr_array[RESUME_STEPS - 1]))
          for tier, t in b.tx.tiers.items()}
    if resumed_from_capture:
        got = b.run_step(dict(feeds[-1]))
        launched = None
    else:
        got, launched = locked_step(b, feeds[-1])
    names = checkpoint.get_checkpoint_tensor_names(path)
    os.remove(path)
    return {"ref": ref, "got": got, "start": start, "want": want,
            "have": b.state_dict(), "names": names, "leaves": leaves,
            "lr": lr, "launched": launched, "save_s": save_s,
            "restore_s": restore_s, "global_step": b.global_step,
            "labels": sorted(set(b.tx.labels.values()))}


def check_resume(what, run, bitwise_wanted):
    """The resumed step against the uninterrupted one: the file's
    optimizer names, the restored lr, the step's launches, the metrics
    and every state tensor (phase 11's rule; bitwise where wanted)."""
    opt = [n for n in run["names"] if n.startswith("opt_state_leaves/")]
    want_names = ["opt_state_leaves/%d" % i for i in range(run["leaves"])]
    # per tier: Adam's two counts, then mu and nu of each parameter
    n_params = sum(1 for n in run["names"] if n.startswith("params/"))
    n_expected = 2 * len(run["labels"]) + 2 * n_params
    if sorted(opt) != sorted(want_names) or run["leaves"] != n_expected \
            or any(n.startswith("opt_state/") for n in run["names"]):
        raise AssertionError("%s: the file's optimizer names %s, expected "
                             "%d optax leaves" % (what, opt[:4], n_expected))
    for tier, (lr, table) in run["lr"].items():
        if lr != table:
            raise AssertionError("%s: tier %s resumed at lr %r, the "
                                 "schedule's step %d is %r"
                                 % (what, tier, lr, RESUME_STEPS - 1, table))
    if run["global_step"] != RESUME_STEPS:
        raise AssertionError("%s: resumed run at step %d"
                             % (what, run["global_step"]))
    if run["launched"] is not None and run["launched"] != RESUME_WANT:
        raise AssertionError("%s: the resumed step launched %s, expected "
                             "%s" % (what, run["launched"], RESUME_WANT))
    equal = metrics_agree(what, run["ref"], run["got"])
    bitwise, worst = states_agree(what, run["want"], run["have"],
                                  run["start"])
    if bitwise_wanted and not (bitwise and equal):
        raise AssertionError("%s: the resumed step is not bitwise the "
                             "uninterrupted one (metrics %s, state %s, "
                             "worst %.3g of an update)"
                             % (what, equal, bitwise, worst))
    log("  %s: %d optax leaves in the file (%d parameters, tiers %s), "
        "restored lr %s; save %.1f s, restore %.1f s; step %d resumed vs "
        "uninterrupted: metrics bitwise %s, state bitwise %s (worst %.3g "
        "of an update)%s"
        % (what, run["leaves"], n_params, run["labels"],
           {t: v[0] for t, v in run["lr"].items()}, run["save_s"],
           run["restore_s"], RESUME_STEPS, equal, bitwise, worst,
           "" if run["launched"] is None else
           "; launched %s" % run["launched"]))
    return {"leaves": run["leaves"], "lr": run["lr"],
            "launches": run["launched"], "metrics_bitwise": bool(equal),
            "state_bitwise": bool(bitwise), "worst_share_of_update": worst,
            "save_s": run["save_s"], "restore_s": run["restore_s"]}


def serve_requests(module, n, seed):
    """A request of ``n`` items for ``module``: uint8 frames and the
    crop/mirror parameters, from ``seed``."""
    rs = np.random.RandomState(seed)
    dset = module.model.settings.feeder.datasets[0]
    per = [s["shape"][0] // module.meta["batch_items"]
           for s in module.meta["inputs"]]
    arrays = []
    for p, spec in zip(per, module.meta["inputs"]):
        shape = [p * n] + spec["shape"][1:]
        if spec["dtype"] == "uint8":
            arrays.append(rs.randint(0, 256, shape, np.uint8))
        else:
            arrays.append(dset.processor.draw_params(
                p * n, random.Random(seed)).astype(spec["dtype"]))
    return arrays


class _CountedCalls:
    """A serving module whose every call runs with the plain versions
    locked out and its launches counted (``per_call``); its other
    attributes are the module's."""

    def __init__(self, module):
        self.module = module
        self.per_call = []

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __call__(self, *arrays):
        reset_counts()
        with _PlainLockedOut():
            out = self.module(*arrays)
        self.per_call.append(counts())
        return out


def _word(folder, timeout=600):
    """The main process's word to the serving ranks (``go`` or ``stop``),
    waited for."""
    path = os.path.join(folder, "word")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise AssertionError("no word from the main process")
        time.sleep(0.05)
    with open(path) as f:
        return f.read()


def _say(folder, word):
    tmp = os.path.join(folder, "word.tmp")
    with open(tmp, "w") as f:
        f.write(word)
    os.replace(tmp, os.path.join(folder, "word"))


def serve_mesh_rank(device, folder, cfg, consts=None):
    """One of phase 14's 4 ranks: a (2, 2) export of phase 12's
    checkpoint through ``cfg`` and ``serving.load`` of it while the main
    process checks the resumed runs; then, at its word, ``tools.serve``
    over it: rank 0 serves while SERVE_CLIENTS post a request each, then
    runs the selftest; the other ranks follow.  Every call on every rank
    is counted.  Rank 0 saves the rows."""
    import torch.distributed as dist
    globals().update(consts or {})
    _float32_exact()
    path = os.path.join(folder, "serve14_mesh.zip")
    t0 = time.monotonic()
    meta = export_mod.export(cfg, path, "latest", batch_items=SERVE_BUCKETS,
                             use_ema=True, mesh_shape=SERVE_MESH,
                             device=device,
                             workdir=os.path.join(folder, "x14"))
    export_s = time.monotonic() - t0
    t0 = time.monotonic()
    module = _CountedCalls(serving.load(path, device=device))
    out = {"rank": dist.get_rank(), "export_s": export_s,
           "load_s": time.monotonic() - t0, "meta_mesh": meta.get("mesh"),
           "loaded_mesh": module.meta.get("mesh")}
    torch.cuda.empty_cache()        # the card is the main process's now
    t0 = time.monotonic()
    if _word(folder) != "go":
        return out
    out["waited_s"] = time.monotonic() - t0
    if dist.get_rank() != 0:
        out["followed"] = serve_mod.serve(module)
        out["selftest"] = serve_mod.selftest(module)
        out["per_call"] = module.per_call
        return out
    t0 = time.monotonic()
    started = threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(module,),
                              kwargs=dict(port=0, started=started,
                                          window_ms=SERVE_WINDOW_MS))
    server.start()
    if not started.wait(600):
        raise AssertionError("the mesh server did not start")
    rows, status, lat = {}, {}, []
    names = [spec["name"] for spec in module.meta["inputs"]]

    def client(c, n):
        key = "%d_%d" % (c, n)
        try:
            rows[key], dt = post_predict(started.addr, dict(zip(
                names, serve_requests(module, n, 1400 + c))))
        except AssertionError as e:     # the answer, checked below
            status[key] = str(e)
            return
        status[key] = 200
        lat.append({"items": n, "ms": dt * 1e3})

    clients = [threading.Thread(target=client, args=(c, n))
               for c, n in enumerate(SERVE_CLIENTS)]
    t0 = time.monotonic()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    out["clients_s"] = time.monotonic() - t0
    stats = started.batcher.stats
    out["device_calls"] = dict(stats.device_calls)
    out["coalesced"] = stats.coalesced
    started.httpd.shutdown()
    server.join(300)
    if server.is_alive():
        raise AssertionError("the mesh server did not stop")
    out["status"], out["latencies"] = status, lat
    np.savez(os.path.join(folder, "serve14_rows.npz"), **rows)
    out["selftest"] = serve_mod.selftest(
        module, item_counts=SERVE_ITEMS, duration_s=SERVE_SELFTEST_S,
        concurrency=SERVE_SELFTEST_CONCURRENCY)
    out["per_call"] = module.per_call
    out["serve_s"] = time.monotonic() - t0
    return out


def single_module(path):
    """The single-process module of a mesh artifact's parameters and
    buckets (the artifact is also a checkpoint), on the card, eager as
    the mesh runs."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json").decode("utf-8"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            flat = {k: npz[k] for k in npz.files}
    model = Model(serving.settings_from_spec(meta["model"]))
    return serving.ServingModule(
        model, checkpoint.unflatten_tree(checkpoint.from_jax_flat(flat)),
        batch_items=meta["buckets"], device="cuda", graphs=False,
        ema=meta["ema"], run_id=meta["run_id"])


class _ServingRanks(threading.Thread):
    """The 4 serving ranks of phase 14, started by ``parallel.launch`` in
    a thread: they export and load the artifact while the main process
    checks the resumed runs, then wait for its word (``_say``)."""

    def __init__(self, folder):
        super().__init__(name="phase14-ranks")
        self.launch = launch
        with open(os.path.join(folder, "val12.json")) as f:
            doc = json.load(f)
        doc["run"]["compute_dtype"] = "float32"
        self.cfg = os.path.join(folder, "val14f.json")
        with open(self.cfg, "w") as f:
            json.dump(doc, f)
        self.work = os.path.join(folder, "serve14")
        os.makedirs(self.work)
        self.ranks, self.error = None, None

    def run(self):
        t0 = time.monotonic()
        try:
            self.ranks = self.launch.run(
                4, "chip_smoke:serve_mesh_rank", {
                    "folder": self.work, "cfg": self.cfg},
                device=MESH_DEVICE, backend="gloo", timeout=600, threads=2,
                path=os.path.dirname(os.path.abspath(__file__)))
        except BaseException as e:  # noqa: BLE001 - raised by ``result``
            self.error = e
        self.seconds = time.monotonic() - t0

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.ranks, self.seconds


def serve_over_mesh(results, serving_ranks):
    """4 gloo ranks on the card serve phase 12's checkpoint as a (2, 2)
    artifact through ``tools.serve``; their rows against the
    single-process module's, each call's launches on each rank, the
    selftest beside the single-process one (both eager: a mesh runs
    eager)."""
    _say(serving_ranks.work, "go")
    ranks, ranks_s = serving_ranks.result()
    work = serving_ranks.work
    failures = []
    for r in ranks:
        if r["meta_mesh"] != SERVE_MESH or r["loaded_mesh"] != SERVE_MESH:
            failures.append("rank %d meta mesh %s, loaded %s"
                            % (r["rank"], r["meta_mesh"], r["loaded_mesh"]))
        bad = [c for c in r["per_call"] if c != VAL_WANT]
        if bad or not r["per_call"]:
            failures.append("rank %d: %d of %d calls launched other than "
                            "%s: %s" % (r["rank"], len(bad),
                                        len(r["per_call"]), VAL_WANT,
                                        bad[:2]))
    calls = [len(r["per_call"]) for r in ranks]
    if len(set(calls)) != 1:
        failures.append("the ranks made %s calls" % calls)
    head = ranks[0]
    if sorted(head["status"].values()) != [200] * len(SERVE_CLIENTS):
        failures.append("request status %s" % head["status"])
    if head["coalesced"] < 1:
        failures.append("no device call coalesced requests: %s"
                        % head["device_calls"])

    _float32_exact()
    single = single_module(os.path.join(work, "serve14_mesh.zip"))
    worst = 0.0
    with np.load(os.path.join(work, "serve14_rows.npz")) as z:
        got = {k: z[k] for k in z.files}
    for key, rows in sorted(got.items()):
        c, n = (int(x) for x in key.split("_"))
        want = single(*serve_requests(single, n, 1400 + c))
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(rows - want).max())
        worst = max(worst, err / scale)
        if rows.shape != want.shape or not err <= 1e-3 * scale:
            failures.append("rows of %s: shape %s vs %s, max abs %.3g of "
                            "scale %.3g" % (key, rows.shape, want.shape, err,
                                            scale))
    one = serve_mod.selftest(single, item_counts=SERVE_ITEMS,
                             duration_s=SERVE_SELFTEST_S,
                             concurrency=SERVE_SELFTEST_CONCURRENCY)
    del single
    torch.cuda.empty_cache()
    results["serve_mesh"] = {
        "ranks_s": ranks_s, "export_s": head["export_s"],
        "waited_s": head["waited_s"], "serve_s": head["serve_s"],
        "load_s": head["load_s"], "clients_s": head["clients_s"],
        "calls_per_rank": calls[0], "device_calls": head["device_calls"],
        "coalesced": head["coalesced"], "latencies": head["latencies"],
        "rows_worst_share_of_scale": worst, "selftest_mesh": head["selftest"],
        "selftest_single": one}
    log("  4 gloo ranks on %s, (2, 2) float32 artifact of phase 12's "
        "checkpoint: export %.1f s, load %.1f s (beside the resumed runs), "
        "then serving %.1f s; all ranks %.1f s; %d "
        "requests of %s items in %.1f s, device calls by bucket %s, %d "
        "coalesced; rows vs the single-process module: worst %.3g of "
        "max(1, max|logit|); every call on every rank launched %s (%d "
        "calls a rank)"
        % (MESH_DEVICE, head["export_s"], head["load_s"], head["serve_s"],
           ranks_s,
           len(head["status"]), list(SERVE_CLIENTS), head["clients_s"],
           head["device_calls"], head["coalesced"], worst, VAL_WANT,
           calls[0]))
    for who, rows in (("4 ranks", head["selftest"]), ("1 process", one)):
        for row in rows:
            log("  selftest, %s: %d items a request, %.2f requests/s, p50 "
                "%s ms, p99 %s ms, %d errors"
                % (who, row["items_per_request"], row["rps"], row["p50_ms"],
                   row["p99_ms"], row["errors"]))
    if failures:
        raise AssertionError("phase 14 serving over a mesh: %s" % failures)


def phase_resume_serve(results, folder):
    """Phase 14: resuming through optax's leaves, and tools.serve over a
    mesh artifact."""
    log("phase 14: resume through the optimizer's optax leaves; "
        "tools.serve over a (2, 2) mesh artifact")
    graphs_mod.Program.replay = _REPLAY
    serving_ranks = _ServingRanks(folder)
    serving_ranks.start()
    word = "stop"
    try:
        _float32_exact()
        t0 = time.monotonic()
        out = {}
        run = resume_run("full_width_bf16", TRAIN_CLIPS, "bfloat16", folder,
                         resumed_from_capture=False)
        out["full_width_bf16"] = check_resume(
            "%d-clip bf16 step" % TRAIN_CLIPS, run, False)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        run = resume_run("graphed_f32", GRAPH_CLIPS, "float32", folder,
                         resumed_from_capture=True)
        out["graphed_f32"] = check_resume(
            "%d-clip float32 step, restored into a captured engine"
            % GRAPH_CLIPS, run, True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        out["resume_s"] = time.monotonic() - t0
        results["resume"] = out
        word = "go"
        t0 = time.monotonic()
        serve_over_mesh(results, serving_ranks)
        results["serve_mesh"]["after_resume_s"] = time.monotonic() - t0
    finally:
        if word == "stop":
            _say(serving_ranks.work, word)
        serving_ranks.join()
        torch.backends.cudnn.deterministic = False
        graphs_mod.Program.replay = _metered_replay


# ------------------------------------------------------------- phase 15
# conv1's lowerings, the frozen conv1 and remat, each a Train option of
# the 128-clip bf16 step; the launches of a step of each (eager, and a
# replay), with the plain versions locked out
STEP_VARIANTS = {"default": {}, "s2d": {"conv1_fwd": "s2d"},
                 "im2col": {"conv1_dw": "im2col"},
                 "freeze": {"freeze_conv1": True}, "remat": {}}
VARIANT_WANT = {
    "default": {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
                "conv1_dw": 0, "conv1_dw_shifted": 1},
    # the recompute runs the encoder's forward again: 2 more LRNs
    "remat": {"lrn": 4, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
              "conv1_dw": 0, "conv1_dw_shifted": 1},
    "s2d": {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
            "conv1_dw": 0, "conv1_dw_shifted": 1},
    # im2col's weight gradient is torch ops
    "im2col": {"lrn": 2, "lrn_bwd": 2, "lstm_step": FPC * LAYERS,
               "conv1_dw": 0, "conv1_dw_shifted": 0},
    # with conv1 frozen nothing below conv2 needs a gradient: no weight
    # gradient, and no backward of the first LRN (or of pool1)
    "freeze": {"lrn": 2, "lrn_bwd": 1, "lstm_step": FPC * LAYERS,
               "conv1_dw": 0, "conv1_dw_shifted": 0}}
CONV1_FRAMES = TRAIN_CLIPS * FPC        # conv1's frames a training step


def conv1_lowerings(results):
    """conv1's forward, direct and s2d, and its weight gradient, the
    shifted kernel and im2col, at a training step's 2048 frames in bf16:
    CUDA-graph replays in turns, the largest difference of each pair,
    and the bound of each (bytes: the frames and the output or the
    gradient read or written once; operations: the direct conv's
    products at the bf16 tensor-core rate)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    n, oh = CONV1_FRAMES, -(-IMAGE // 4)
    x = torch.randn((n, IMAGE, IMAGE, 3), generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = layers.hwio_to_oihw(torch.randn(
        (11, 11, 3, 96), generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    b = torch.full((96,), 0.1, device="cuda")
    g = torch.randn((n, oh, oh, 96), generator=gen, device="cuda").to(
        torch.bfloat16)
    fwd = {"direct": lambda: layers.conv_apply({"w": w, "b": b}, x, (4, 4),
                                               "SAME"),
           "s2d": lambda: alexnet.conv1_space_to_depth(x, w, b)}
    dw = {"shifted": lambda: conv1_mod.conv1_dw_shifted(x, g),
          "im2col": lambda: conv1_mod.conv1_dw_im2col(x, g)}
    ops = 2.0 * n * oh * oh * 96 * 11 * 11 * 3
    x_bytes = x.numel() * 2
    out = {}
    # the forward's outputs are bf16, each rounded twice (the conv, the
    # bias): two orders of summation part by a few bf16 steps at most;
    # the weight gradients are float32 sums of exact products (phase 2
    # holds the shifted kernel to 1e-5 of the scale)
    for what, fns, nbytes, tol in (
            ("forward", fwd, x_bytes + n * oh * oh * 96 * 2 + w.numel() * 2,
             2 ** -6),
            ("weight_gradient", dw, x_bytes + g.numel() * 2 +
             w.numel() * 4, 1e-4)):
        a, c = list(fns)
        times = {a: [], c: []}
        for k in (a, c, c, a):
            times[k].append(cuda_ms(fns[k]))
        err, _ = errors(fns[c](), fns[a]())
        scale = float(fns[a]().double().abs().max())
        bound, by = bound_ms(nbytes, ops, PEAK_BF16_OPS_PER_S)
        row = {k: v for k, v in times.items()}
        row.update(max_abs_diff=err, scale=scale, tolerance=tol * scale,
                   bound_ms=bound, bound_by=by)
        log("  conv1 %s at %d frames, bf16 (graph replays, in turns): %s "
            "%s ms, %s %s ms; max |%s - %s| %.3g of %.3g; bound %.3f ms "
            "(%s)" % (what.replace("_", " "), n, a,
                      " / ".join("%.3f" % t for t in times[a]), c,
                      " / ".join("%.3f" % t for t in times[c]), c, a, err,
                      scale, bound, by))
        if not (math.isfinite(err) and err <= tol * scale):
            raise AssertionError("conv1 %s: %s and %s differ by %.3g of %.3g"
                                 % (what, c, a, err, scale))
        out[what] = row
    results["conv1_lowerings"] = out
    del x, g, fwd, dw
    torch.cuda.empty_cache()


def variant_engine(name, mesh=None):
    """The 128-clip bf16 training engine of phase 5 with ``name``'s
    option (``STEP_VARIANTS``; remat: ``settings.remat``), on ``mesh``
    if given."""
    settings, model = training_flagship(TRAIN_CLIPS, "bfloat16")
    settings.remat = name == "remat"
    return Train(settings, settings.feeder, model, seed=0, device="cuda",
                 mesh=mesh, **STEP_VARIANTS[name])


def variant_steps(name, feeds, mesh=None):
    """Phase 5's three steps (eager; eager, then the capture; a replay)
    of ``name``'s engine (on ``mesh`` if given) with the plain versions
    locked out, each launching ``VARIANT_WANT[name]`` (every LRN launch
    the vector design), every metric finite; the eager step's peak
    memory above what was allocated before the engine was built, and the
    graph pool's bytes.  Returns (engine, record)."""
    want = VARIANT_WANT[name]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = variant_engine(name, mesh)
    rec = {"launches": []}
    for i, feed in enumerate((feeds[0], feeds[1], feeds[0])):
        metrics, launched = locked_step(engine, feed)
        if i == 0:
            rec["eager_peak_gb"] = (torch.cuda.max_memory_allocated()
                                    - before) / 1e9
        lrn_want = {"staged": 0, "vector": want["lrn"]}
        bwd_want = {"staged": 0, "vector": want["lrn_bwd"]}
        if launched != want or fwd_variants() != lrn_want or \
                variants() != bwd_want or \
                _METER.replays != (1 if i == 2 else 0) or \
                not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(
                "%s step %d launched %s (LRN %s / %s) in %d replays with "
                "metrics %s; expected %s" % (name, i + 1, launched,
                                             fwd_variants(), variants(),
                                             _METER.replays, metrics, want))
        rec["launches"].append(launched)
    program, _ = train_program(engine, ("step",))
    rec["pool_gb"] = program.pool_bytes / 1e9
    rec["capture_s"] = program.capture_s
    log("  %s step: launched %s eager, eager then the capture, and in a "
        "replay; eager step peak +%.2f GB, graph pool %.2f GB"
        % (name, want, rec["eager_peak_gb"], rec["pool_gb"]))
    return engine, rec


def variant_steps_timed(results):
    """The graphed 128-clip bf16 step of each option beside the default
    step, in turns (default, option, option, default)."""
    settings, _ = training_flagship(TRAIN_CLIPS, "bfloat16")
    processor = settings.feeder.datasets[0].processor
    feeds = [training_feed(processor, TRAIN_CLIPS, s, "cuda")
             for s in (1, 2)]
    default, out = None, {}
    for name in STEP_VARIANTS:
        engine, rec = variant_steps(name, feeds)
        if default is None:
            default, out[name] = engine, rec
            continue
        turn = [0]

        def run(eng):
            eng.run_step(dict(feeds[turn[0] % 2]))
            turn[0] += 1

        ms = {"default": [], name: []}
        for k, eng in (("default", default), (name, engine),
                       (name, engine), ("default", default)):
            ms[k].append(timed_s(lambda: run(eng), 3) * 1e3)
        rec["graphed_ms"] = ms[name]
        rec["default_graphed_ms"] = ms["default"]
        log("  graphed %d-clip bf16 step, %s: %s ms beside the default's "
            "%s ms (%s)" % (TRAIN_CLIPS, name,
                            " / ".join("%.2f" % t for t in ms[name]),
                            " / ".join("%.2f" % t for t in ms["default"]),
                            gpu_line()))
        out[name] = rec
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del default
    gc.collect()
    torch.cuda.empty_cache()
    results["conv1_remat_steps"] = out


def remat_graphed_vs_eager(results):
    """In float32 (TF32 off, cuDNN deterministic), GRAPH_CLIPS clips,
    dropout 0.5: GRAPH_STEPS steps with remat, eager and graphed (after
    a restore), against the eager steps without remat from the same
    seed; the remat replay's kernels."""
    _float32_exact()
    try:
        eager, graphed, processor = graph_engines({"remat": True})
        plain, _, _ = graph_engines({}, with_graphed=False)
        start = eager.state_dict()
        feeds = [training_feed(processor, GRAPH_CLIPS, 50 + s, "cuda")
                 for s in range(GRAPH_STEPS)]
        equal = {"eager": True, "graphed": True}
        for i, feed in enumerate(feeds):
            mp = plain.run_step(dict(feed))
            me = eager.run_step(dict(feed))
            mg = graphed.run_step(dict(feed))
            equal["eager"] &= metrics_agree("remat eager step %d" % i, mp,
                                            me)
            equal["graphed"] &= metrics_agree("remat graphed step %d" % i,
                                              mp, mg)
        out = {}
        for what, eng in (("eager", eager), ("graphed", graphed)):
            bitwise, worst = states_agree("remat %s" % what, plain, eng,
                                          start)
            diff = max(float((a - b).detach().abs().max()) for a, b in zip(
                checkpoint.flatten_tree(eng.params).values(),
                checkpoint.flatten_tree(plain.params).values()))
            out[what] = {"metrics_bitwise": bool(equal[what]),
                         "state_bitwise": bitwise,
                         "worst_share_of_update": worst,
                         "max_param_diff": diff}
            log("  float32 %d-clip step with remat, %s, against the eager "
                "step without: %d steps, metrics bitwise %s, state bitwise "
                "%s (worst %.3g of an update; largest parameter difference "
                "%.3g)" % (GRAPH_CLIPS, what, GRAPH_STEPS, equal[what],
                           bitwise, worst, diff))
        program, _ = train_program(graphed, ("step",))
        out["launches"] = replay_counts(
            "remat training step", lambda: eager.run_step(dict(feeds[0])),
            lambda: graphed.run_step(dict(feeds[0])),
            VARIANT_WANT["remat"], program)
        results["remat_graphed_vs_eager"] = out
        del eager, graphed, plain
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False


def conv1_card_vs_cpu(results):
    """One float32 step at 1 clip with the s2d forward and one with the
    im2col weight gradient, on the card and on the CPU (phase 5's
    rule)."""
    out = {}
    for name in ("s2d", "im2col"):
        settings, model = training_flagship(1, "float32", base_lr=1.0,
                                            clip_norm=None)
        processor = settings.feeder.datasets[0].processor
        loss_err, worst = step_card_vs_cpu(
            settings, model, model.init_params(seed=3, device="cpu"),
            training_feed(processor, 1, 5, "cpu"),
            "%s step at 1 clip" % name, **STEP_VARIANTS[name])
        out[name] = {"loss_rel": loss_err, "grad_rel_norm_max": worst}
    results["conv1_card_vs_cpu"] = out


def phase_conv1_remat(results):
    """Phase 15: conv1's other lowerings, the frozen conv1 and remat."""
    log("phase 15: conv1's s2d forward, im2col and frozen weight "
        "gradients, remat (%s)" % gpu_line())
    t0 = time.monotonic()
    conv1_lowerings(results)
    variant_steps_timed(results)
    remat_graphed_vs_eager(results)
    conv1_card_vs_cpu(results)
    results["conv1_remat_phase_s"] = time.monotonic() - t0


def phase15_child(out_path):
    """Phase 15 in a process of its own (``run_child_phase``): the kernels
    loaded, TF32 off as phase 2 leaves it, replays metered; writes its
    results to ``out_path`` as JSON."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    install_meter()
    results = {}
    phase_conv1_remat(results)
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


def run_child_phase(results, folder, n):
    """Phase ``n`` (15 or 16) in a child process, ``phase<n>_child``:
    phases 12 and 14 ran other processes on the card, after which this
    process's profiler loses kernel records of the replays that the
    phase counts; phase 16's NCCL group ends with its process."""
    out_path = os.path.join(folder, "phase%d.json" % n)
    here = os.path.dirname(os.path.abspath(__file__))
    rc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke as cs; "
         "sys.exit(cs.phase%d_child(sys.argv[1]))" % n, out_path],
        cwd=here, timeout=900).returncode
    if rc != 0:
        raise AssertionError("phase %d exited with %d" % (n, rc))
    with open(out_path) as f:
        results.update(json.load(f))


# ------------------------------------------------------------- phase 16
# CUDA graphs over an NCCL group.  The card holds one rank (NCCL refuses
# two ranks on one device), so the mesh below issues every collective of
# the port's programs on a one-rank NCCL group.
NCCL_SERVE_MODES = (None, "int8", "int8_static")


class OneRankNcclMesh(Mesh):
    """The mesh of a one-rank NCCL group with every collective run.  On
    a world of one the port skips its collectives (``Mesh``'s methods,
    ``use``, ``Model.apply``, the entry points' gates); this mesh reports
    two ranks so that those shortcuts pass, keeps its data and model
    axes at 1 (a rank's rows and slices are the whole), and issues each
    collective on the world group whatever the axis size.  ``calls``
    counts them: "eager" those that ran at once, "captured" those that a
    CUDA graph capture recorded (they run at every replay)."""

    def __init__(self):
        super().__init__({"data": 1, "model": 1})
        self.size = 2
        self.calls = {"eager": collections.Counter(),
                      "captured": collections.Counter()}

    def _count(self, name):
        kind = ("captured" if torch.cuda.is_current_stream_capturing()
                else "eager")
        self.calls[kind][name] += 1

    def _reduce(self, name, t, op):
        self._count(name)
        dist.all_reduce(t, op=op)
        return t

    def data_sum(self, t):
        return self._reduce("data_sum", t, dist.ReduceOp.SUM)

    def data_max(self, t):
        return self._reduce("data_max", t, dist.ReduceOp.MAX)

    def model_sum(self, t):
        return self._reduce("model_sum", t, dist.ReduceOp.SUM)

    def world_max(self, t):
        return self._reduce("world_max", t, dist.ReduceOp.MAX)

    def model_gather(self, t, dim=-1):
        self._count("model_gather")
        return self._gather(t, dim, None, 1)

    def data_gather(self, t, dim=0):
        self._count("data_gather")
        return self._gather(t, dim, None, 1)


def captured_by(mesh, fn):
    """``fn()`` and the collectives that the captures during it recorded,
    {name: calls}."""
    before = collections.Counter(mesh.calls["captured"])
    out = fn()
    return out, dict(mesh.calls["captured"] - before)


def _holds(what, captured, want):
    """Fails unless ``what``'s capture recorded each collective of
    ``want`` at least as often as ``want`` says."""
    log("  %s: its capture recorded the collectives %s" % (what, captured))
    if any(captured.get(k, 0) < n for k, n in want.items()):
        raise AssertionError("%s: the capture recorded %s, expected at "
                             "least %s" % (what, captured, want))


def _bitwise(what, equal):
    if not equal:
        raise AssertionError("%s: the replay is not bitwise equal to the "
                             "eager program on the same mesh" % what)


def nccl_gathers(mesh):
    """The list form of all_gather (``Mesh._gather``) inside a capture:
    its parts are allocated on the capture's stream, from the program's
    pool, and a replay gathers the new input."""
    cache = graphs_mod.ProgramCache("the mesh's gathers")
    x = torch.arange(4096, dtype=torch.float32, device="cuda")

    def gathers(inputs):
        y = inputs["x"] * 2
        return mesh.model_gather(y, -1) + mesh.data_gather(y, 0)

    _, captured = captured_by(mesh, lambda: cache.run("gathers", gathers,
                                                      {"x": x}))
    _holds("model_gather + data_gather", captured,
           {"model_gather": 1, "data_gather": 1})
    got = cache.run("gathers", gathers, {"x": x + 1})
    if not torch.equal(got, (x + 1) * 4):
        raise AssertionError("a replay of the gathers gave other values")
    (program, _), = cache.programs().values()
    return {"captured": captured, "pool_bytes": program.pool_bytes}


def nccl_steps(mesh):
    """Phase 11's float32 8-clip steps (dropout 0.5) in its two
    configurations on the mesh: 3 replays after a restore bitwise equal
    to 3 eager steps on the mesh, and against the eager steps without a
    mesh bitwise or within phase 11's rule; then compile_scan_steps(3)
    held the same way (the Adam configuration)."""
    out = {}
    for name, opts in GRAPH_CONFIGS.items():
        plain, _, processor = graph_engines(opts, with_graphed=False)
        (eager, graphed, _), captured = captured_by(
            mesh, lambda: graph_engines(opts, mesh=mesh))
        _holds("float32 step (%s)" % name, captured, {"data_sum": 1})
        start = eager.state_dict()
        feeds = [training_feed(processor, GRAPH_CLIPS, 50 + s, "cuda")
                 for s in range(GRAPH_STEPS)]
        plain_equal = True
        for i, feed in enumerate(feeds):
            mp = plain.run_step(dict(feed))
            me = eager.run_step(dict(feed))
            mg = graphed.run_step(dict(feed))
            _bitwise("%s step %d metrics" % (name, i),
                     metrics_agree("%s step %d" % (name, i), me, mg))
            plain_equal &= metrics_agree("%s step %d, no mesh" % (name, i),
                                         mp, mg)
        _bitwise("%s state" % name,
                 states_agree(name, eager, graphed, start)[0])
        bitwise, worst = states_agree(name + ", no mesh", plain, graphed,
                                      start)
        log("  float32 %d-clip step, %s, on the NCCL mesh: %d replays after "
            "a restore bitwise equal to the eager steps on the mesh; against "
            "the eager steps without a mesh: metrics bitwise %s, state "
            "bitwise %s (worst %.3g of an update)"
            % (GRAPH_CLIPS, name, GRAPH_STEPS, plain_equal, bitwise, worst))
        row = {"captured": captured, "vs_no_mesh_metrics_bitwise":
               bool(plain_equal), "vs_no_mesh_state_bitwise": bitwise,
               "vs_no_mesh_worst_share_of_update": worst}
        if name == "adam_ema_watch":
            row["scan"] = nccl_scan(mesh, plain, eager, graphed, feeds[0])
        out[name] = row
        del plain, eager, graphed
        torch.cuda.empty_cache()
    return out


def nccl_scan(mesh, plain, eager, graphed, feed):
    """compile_scan_steps(GRAPH_STEPS) as one graph on the mesh against
    the eager loop on the mesh (bitwise) and without one (phase 11's
    rule), from one state."""
    _, captured = captured_by(mesh, lambda: graphed.compile_scan_steps(
        GRAPH_STEPS)(dict(feed)))                  # eager, then the capture
    _holds("compile_scan_steps(%d)" % GRAPH_STEPS, captured,
           {"data_sum": GRAPH_STEPS})
    start = eager.state_dict()
    graphed.load_state_dict(start)
    plain.load_state_dict(start)
    mp = plain.compile_scan_steps(GRAPH_STEPS)(dict(feed))
    me = eager.compile_scan_steps(GRAPH_STEPS)(dict(feed))
    mg = graphed.compile_scan_steps(GRAPH_STEPS)(dict(feed))
    program, _ = train_program(graphed, ("scan", GRAPH_STEPS))
    if program.replays != 1:
        raise AssertionError("the scan ran %d replays" % program.replays)
    _bitwise("compile_scan_steps metrics",
             metrics_agree("compile_scan_steps", me, mg))
    _bitwise("compile_scan_steps state",
             states_agree("compile_scan_steps", eager, graphed, start)[0])
    plain_equal = metrics_agree("compile_scan_steps, no mesh", mp, mg)
    bitwise, worst = states_agree("compile_scan_steps, no mesh", plain,
                                  graphed, start)
    log("  compile_scan_steps(%d) as one graph on the NCCL mesh: bitwise "
        "equal to the eager loop on the mesh; against the loop without a "
        "mesh: metrics bitwise %s, state bitwise %s (worst %.3g of an "
        "update)" % (GRAPH_STEPS, plain_equal, bitwise, worst))
    return {"captured": captured, "vs_no_mesh_metrics_bitwise":
            bool(plain_equal), "vs_no_mesh_state_bitwise": bitwise,
            "vs_no_mesh_worst_share_of_update": worst}


def nccl_train_step(mesh):
    """Phase 5's 128-clip bf16 step, graphed, on the mesh and without
    one (phase 15's ``variant_steps``: eager; eager, then the capture; a
    replay counted by the profiler), then the two graphed steps timed in
    turns (no mesh, mesh, mesh, no mesh)."""
    settings, _ = training_flagship(TRAIN_CLIPS, "bfloat16")
    processor = settings.feeder.datasets[0].processor
    feeds = [training_feed(processor, TRAIN_CLIPS, s, "cuda")
             for s in (1, 2)]
    log("  the %d-clip bf16 step without a mesh:" % TRAIN_CLIPS)
    plain, _ = variant_steps("default", feeds)
    log("  the %d-clip bf16 step on the NCCL mesh:" % TRAIN_CLIPS)
    (engine, rec), captured = captured_by(
        mesh, lambda: variant_steps("default", feeds, mesh=mesh))
    _holds("the %d-clip bf16 step" % TRAIN_CLIPS, captured, {"data_sum": 1})
    turn = [0]

    def run(eng):
        eng.run_step(dict(feeds[turn[0] % 2]))
        turn[0] += 1

    ms = {"no_mesh": [], "mesh": []}
    for k, eng in (("no_mesh", plain), ("mesh", engine), ("mesh", engine),
                   ("no_mesh", plain)):
        ms[k].append(timed_s(lambda: run(eng), 3) * 1e3)
    log("  graphed %d-clip bf16 step on the NCCL mesh: %s ms beside %s ms "
        "without a mesh; a replay ran %s (profiler) (%s)"
        % (TRAIN_CLIPS, " / ".join("%.2f" % t for t in ms["mesh"]),
           " / ".join("%.2f" % t for t in ms["no_mesh"]), rec["launches"][2],
           gpu_line()))
    del plain, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rec, captured=captured, graphed_ms=ms["mesh"],
                no_mesh_graphed_ms=ms["no_mesh"])


def _logits_rule(what, got, want):
    """Bitwise, or within phase 11's 1e-5 x max(1, max|logit|) with the
    difference printed; returns (bitwise, share of the scale)."""
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    bitwise = bool(np.array_equal(got, want))
    if not bitwise:
        log("  %s: not bitwise equal; the replay differs from the eager "
            "call by %.3g of the logit scale" % (what, err))
    if not err <= 1e-5:
        raise AssertionError("%s: graphed logits differ by %.3g of the "
                             "scale" % (what, err))
    return bitwise, err


def nccl_serving(mesh):
    """The classifier's serving module at buckets 1, 8 and 32 in float32,
    int8 and int8_static on the mesh: each bucket's first call (eager,
    then the capture) and a replay against the eager module on the same
    mesh; the int8 capture holds the amax's data_max."""
    settings, model = flagship(num_classes=CLASSES, fpc=FPC, image=IMAGE,
                               lstm=(HIDDEN, LAYERS), raw_hw=RAW_HW,
                               mean_scalars=SERVING_MEAN,
                               imgproc=SERVING_IMGPROC,
                               compute_dtype="float32")
    processor = settings.feeder.datasets[0].processor
    params = model.init_params(seed=0, device="cuda")
    calib = device_frames(processor, INT8_CALIB_CLIPS * FPC, 70, "cuda")
    frames, prm = device_frames(processor, max(GRAPH_BUCKETS) * FPC, 72,
                                "cuda")
    out = {}
    for mode in NCCL_SERVE_MODES:
        kw = {"calib_feed": calib} if mode == "int8_static" else {}
        graphed = serving.ServingModule(model, params,
                                        batch_items=GRAPH_BUCKETS,
                                        device="cuda", quantize=mode,
                                        mesh=mesh, **kw)
        if mode == "int8_static":
            kw = {"act_ranges": graphed.meta["act_ranges"]}
        eager = serving.ServingModule(model, params,
                                      batch_items=GRAPH_BUCKETS,
                                      device="cuda", quantize=mode,
                                      graphs=False, mesh=mesh, **kw)
        if graphed.graphs is None or graphed.mesh is not mesh:
            raise AssertionError("the module on the NCCL mesh is not graphed")
        rows = {}
        for clips in GRAPH_BUCKETS:
            n = clips * FPC
            what = "%s bucket %d" % (mode or "float32", clips)
            _, captured = captured_by(
                mesh, lambda: graphed(frames[:n], prm[:n]))
            _holds(what, captured,
                   {"data_max": 1} if mode == "int8" else {})
            bitwise, err = _logits_rule(what, graphed(frames[:n], prm[:n]),
                                        eager(frames[:n], prm[:n]))
            rows[clips] = {"captured": captured, "bitwise": bitwise,
                           "rel_err": err}
        log("  %s serving on the NCCL mesh, buckets %s: replays bitwise "
            "equal to the eager calls %s" % (
                mode or "float32", GRAPH_BUCKETS,
                {c: r["bitwise"] for c, r in rows.items()}))
        out[mode or "float32"] = rows
        del graphed, eager
    torch.cuda.empty_cache()
    return out


def nccl_validation(mesh):
    """``Validation.run_forward`` on the mesh, graphed against eager: the
    float32 classifier forward of one GRAPH_CLIPS-clip batch (phase 11's
    rule), and the greedy and beam-4 decodes of CAPTION_ITEMS items at
    phase 6's width (tokens equal, or from a step within 1e-4 of a tie:
    phase 6's rule)."""
    settings, model = training_flagship(GRAPH_CLIPS, "float32")
    processor = settings.feeder.datasets[0].processor
    params = model.init_params(seed=0, device="cuda")
    frames, prm = device_frames(processor, GRAPH_CLIPS * FPC, 74, "cuda")
    feed = {"frames_main_input": frames,
            "frames_main_input/proc_params": prm}
    graphed = val_mod.Validation(settings, model, device="cuda", mesh=mesh)
    eager = val_mod.Validation(settings, model, device="cuda", graphs=False,
                               mesh=mesh)
    _, captured = captured_by(mesh, lambda: graphed.run_forward(
        params, dict(feed)))
    _holds("the Validation forward", captured, {})
    bitwise, err = _logits_rule(
        "the Validation forward", graphed.run_forward(params, dict(feed)),
        eager.run_forward(params, dict(feed)))
    out = {"forward": {"captured": captured, "bitwise": bitwise,
                       "rel_err": err}}
    del params, graphed, eager
    s32, m32 = caption_flagship(batch_size=CAPTION_ITEMS,
                                compute_dtype="float32")
    params = m32.init_params(seed=0, device="cuda")
    dset = m32.caption_dataset
    frames, prm = device_frames(dset.processor, CAPTION_ITEMS, 60, "cuda")
    feed = {"frames_main_input": frames,
            "frames_main_input/proc_params": prm}
    pre = make_preprocessor(dset.processor, out_dtype=torch.float32,
                            device="cuda")
    ref = decode_margins(m32, params, {"frames_main_input": pre(frames, prm)},
                         dset.vocabulary.index("EOS"))
    graphed = val_mod.Validation(s32, m32, device="cuda", mesh=mesh)
    eager = val_mod.Validation(s32, m32, device="cuda", graphs=False,
                               mesh=mesh)
    s32.captioning.beam_width = BEAM
    for search, key in (("max", "greedy"), ("beam", "beam")):
        s32.captioning.caption_search = search
        _, captured = captured_by(mesh, lambda: graphed.run_forward(
            params, dict(feed), decode=True))
        _holds("the %s decode" % key, captured, {})
        ids = graphed.run_forward(params, dict(feed), decode=True)
        diff = first_difference(ids, eager.run_forward(params, dict(feed),
                                                       decode=True))
        if diff is not None and not ref["tie_" + key](*diff):
            raise AssertionError("graphed %s tokens on the mesh differ at "
                                 "a decided step %s" % (key, diff))
        log("  float32 %s decode of %d items on the NCCL mesh, graphed vs "
            "eager: tokens %s" % (key, CAPTION_ITEMS, "equal" if diff is None
                                  else "differ first at item %d step %d, "
                                  "within a tie" % diff))
        out[key] = {"captured": captured, "first_difference": diff}
    s32.captioning.caption_search = "max"
    del params, graphed, eager
    torch.cuda.empty_cache()
    return out


def phase_nccl_graphs(results):
    """Phase 16: CUDA graphs over a one-rank NCCL group, in float32 with
    TF32 off and cuDNN deterministic where it compares."""
    log("phase 16: CUDA graphs over a one-rank NCCL group (%s; NCCL %s)"
        % (gpu_line(), ".".join(map(str, torch.cuda.nccl.version()))))
    t0 = time.monotonic()
    mesh = OneRankNcclMesh()
    out = {"backend": dist.get_backend(),
           "nccl": list(torch.cuda.nccl.version())}
    if mesh_mod.graphs_on_mesh(mesh, None, "phase 16") is not None:
        raise AssertionError("an NCCL mesh does not keep graphs' default")
    out["gathers"] = nccl_gathers(mesh)
    _float32_exact()
    try:
        out["steps"] = nccl_steps(mesh)
        out["serving"] = nccl_serving(mesh)
        out["validation"] = nccl_validation(mesh)
    finally:
        torch.backends.cudnn.deterministic = False
    out["train_step"] = nccl_train_step(mesh)
    log("  not shown with one rank: the model axis's column split "
        "(Model.apply's sharding.mark, the clip norm's model_sum, "
        "model_gather of split leaves) needs a model axis of 2 or more, "
        "and so two cards")
    out["collectives"] = {k: dict(v) for k, v in mesh.calls.items()}
    log("  collectives: %s" % out["collectives"])
    out["phase_s"] = time.monotonic() - t0
    log("  phase 16's checks took %.1f s" % out["phase_s"])
    results["nccl_graphs"] = out


def phase16_child(out_path):
    """Phase 16 in a process of its own (``run_child_phase``), which
    joins a one-rank NCCL group bound to the card and leaves it at the
    end."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    install_meter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % launch.free_port(), world_size=1, rank=0,
                            device_id=device)
    try:
        results = {}
        phase_nccl_graphs(results)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(results, f)
    return 0


def kernel_entry(name, source, replaces, launches, cases, main_cases):
    """One kernel's line entry.  Times and bounds are for the launches of
    the main path's run (the sum over its launch sites); errors are the
    worst over every case run."""
    lib = [c["library_ms"] for c in main_cases]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": sum(c["ms"] for c in main_cases),
        "plain_ms": sum(c["plain_ms"] for c in main_cases),
        "bound_ms": sum(c["bound_ms"] for c in main_cases),
        "bound_by": main_cases[0]["bound_by"],
        "library_ms": None if None in lib else sum(lib),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the detailed results "
                                      "here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU\n")
        return 2
    t_start = time.monotonic()
    install_meter()
    card = gpu_line()
    log("gpu: %s" % card)
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                          torch.version.cuda,
                                          sys.version.split()[0]))
    log("phase 1: build")
    t0 = time.monotonic()
    _build.library()
    log("  kernels built and loaded in %.1f s (nvcc %.1f s)"
        % (time.monotonic() - t0, _build.build_seconds))

    results = {"gpu": card, "torch": torch.__version__,
               "build_s": _build.build_seconds}
    kernels = phase_kernels(SERVE_CLIPS)
    results["kernel_cases"] = {k: v[0] for k, v in kernels.items()}
    model, params, processor = phase_forward(results)
    phase_serve(model, params, processor, results)
    del model, params, processor
    torch.cuda.empty_cache()
    phase_train(results)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    phase_caption(results)
    results["caption_phase_s"] = time.monotonic() - t0
    log("  phase 6 took %.1f s" % results["caption_phase_s"])
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    phase_int8(results)
    results["int8_phase_s"] = time.monotonic() - t0
    log("  phase 7 took %.1f s" % results["int8_phase_s"])
    torch.cuda.empty_cache()
    folder = tempfile.mkdtemp(prefix="vlt_phase8_")
    try:
        t0 = time.monotonic()
        train_path = phase_fed(results, folder)
        results["fed_phase_s"] = time.monotonic() - t0
        log("  phase 8 took %.1f s" % results["fed_phase_s"])
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_run(results, folder, train_path)
        results["run_phase_s"] = time.monotonic() - t0
        log("  phase 9 took %.1f s" % results["run_phase_s"])
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_media(results, folder, train_path)
        results["media_phase_s"] = time.monotonic() - t0
        log("  phase 10 took %.1f s" % results["media_phase_s"])
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_graphs(results)
        results["graphs_phase_s"] = time.monotonic() - t0
        log("  phase 11 took %.1f s" % results["graphs_phase_s"])
        # phase 12 runs last: once other processes have used the card,
        # the profiler loses one kernel record of every profiled replay
        # of this process (a probe on one H100), and phase 11
        # counts replays' kernels from those records
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_mesh(results, folder, train_path)
        results["mesh_phase_s"] = time.monotonic() - t0
        log("  phase 12 took %.1f s" % results["mesh_phase_s"])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_tools(results, folder)
        results["tools_phase_s"] = time.monotonic() - t0
        log("  phase 13 took %.1f s" % results["tools_phase_s"])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        phase_resume_serve(results, folder)
        results["resume_serve_phase_s"] = time.monotonic() - t0
        log("  phase 14 took %.1f s" % results["resume_serve_phase_s"])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        run_child_phase(results, folder, 15)
        log("  phase 15 took %.1f s (%.1f s in its process's phase)"
            % (time.monotonic() - t0, results["conv1_remat_phase_s"]))
        t0 = time.monotonic()
        run_child_phase(results, folder, 16)
        log("  phase 16 took %.1f s (%.1f s in its process's phase)"
            % (time.monotonic() - t0, results["nccl_graphs"]["phase_s"]))
    finally:
        shutil.rmtree(folder, ignore_errors=True)

    launches = dict(results["main_path_launches"],
                    lrn_bwd=results["train_launches"]["lrn_bwd"],
                    conv1_dw=results["train_launches_blocked"]["conv1_dw"],
                    conv1_dw_shifted=results["train_launches"][
                        "conv1_dw_shifted"])
    csrc = "video_learning_tpu_torch/csrc/"
    tpu = "video_learning_tpu/ops/pallas_kernels.py:"
    line = {"kernels": [
        kernel_entry(name, csrc + source, tpu + str(at), launches[name],
                     *kernels[name])
        for name, source, at in (
            ("lrn", "lrn.cu", 149), ("lrn_bwd", "lrn_bwd.cu", 169),
            ("lstm_step", "lstm_step.cu", 201),
            ("conv1_dw", "conv1_dw.cu", 263),
            ("conv1_dw_shifted", "conv1_dw.cu", 373))]}
    results["kernels"] = line["kernels"]
    results["metered_replays"] = _METER.total_replays
    results["meter_overhead_s"] = _METER.overhead_s
    log("replays measured under the profiler: %d; the profiler's own host "
        "time around them %.2f s (%.1f ms a replay)"
        % (_METER.total_replays, _METER.overhead_s,
           1e3 * _METER.overhead_s / max(_METER.total_replays, 1)))
    results["total_s"] = time.monotonic() - t_start
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    for k in line["kernels"]:
        if not all(math.isfinite(k[key]) for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError("non-finite number in %s" % k)
    log("total %.1f s" % results["total_s"])
    log("gpu: %s" % card)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
