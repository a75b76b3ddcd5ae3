"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``). Phases, each printing JSON lines:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port (``ops/csrc``), one ``nvcc`` each,
   all started together, with the compile seconds and ``ptxas`` registers
   and spills of every kernel (``ptxas_summary``), the main paths'
   tensor-core kernels named apart (none of them may spill: checked at the
   end);
3. the fused head (kernel 1) against its plain PyTorch version, at the main
   paths' shapes (D = 128 for the MLP detector, D = 256 for LogBERT) and at
   edge shapes, fp32 ones (the CUDA-core variant) with bf16 twins (the
   tensor-core variants, split over C or not), each with its variant and
   split count (TF32 off, so the plain version is exact fp32);
4. the fused head's timings: kernel, plain version, one library call that
   computes the same function (over row chunks of 65,536 where its bf16
   [N, C] product would not fit), and the card's bound for the same work;
5. the flash kernels (forward, dQ, dK/dV) against their plain versions at
   the LogBERT scoring and training shapes and at ragged, tiny, fp16,
   fully-masked and D = 128 edge shapes, in fp32 (the CUDA-core variants)
   and in bf16 (the wgmma variants), and with q, k and v as strided views
   of one qkv tensor as the model passes them;
6. the flash kernels' timings beside their plain versions,
   ``F.scaled_dot_product_attention`` (forward, and its backward through
   autograd) as the library yardstick, and the bound, with each kernel's
   variant and share of the bound;
7. the MLP detector end to end at the full bench width (vocab 32768,
   seq_len 32, dim 128, hidden 256, max_batch 16384, bf16, ``head_impl:
   pallas``): fit on 2048 messages, then 65,536 messages in
   ``process_batch`` calls of 4096; the same stream through the einsum head
   on the same weights must give the same alert decisions;
7b. the wire-frame path (``bench_torch.py``): the native featurizer's build
   seconds (the host compiler, at phase 7's ``setup_io``), its rows held
   bit-equal to the port's Python rows on phase 7's 65,536 messages as a
   batch and packed into frames of 512, the featurize pass timed natively
   and in Python, then
   a fresh MLP detector through ``bench_torch.drive`` (fit, warm-up,
   ``process_frames`` over those frames in calls of 32, the p50 of 64 lone
   messages): its lines/s and p50, exact kernel 1 launches and variants,
   recall >= 0.9 and no row featurized in Python;
8. the LogBERT detector end to end at ``examples/seqparallel_config.yaml``'s
   widths on one card (vocab 32768, dim 256, depth 4, heads 4, seq_len 2048,
   score_topk 8, max_batch 256, bf16) with ``attn_impl: flash`` and
   ``head_impl: pallas``: fit on 512 messages (112 train steps through the
   flash forward, dQ and dK/dV kernels), then 4096 messages in calls of 256;
   the same stream through the einsum attention and head on the same fitted
   weights must give the same alert decisions;
9. the GRU detector at ``examples/gru_config.yaml``'s widths (vocab 32768,
   dim 128, depth 1, seq_len 32, ``score_norm: position``, threshold_sigma
   5, max_batch 4096, bf16) with ``head_impl: pallas``: fit on 512
   messages (108 train steps, then 4 calibration chunks of N = 1,024 head
   rows), then 65,536 messages in calls of 4096 (16 device batches of
   N = 131,072 head rows); the same stream through the einsum head on the
   same fitted weights and norm statistics must give the same decisions;
10. phase 7's MLP detector with ``dtype: int8w``: the parity gate must
   install the int8 path (``activated``, 0 flips); its lines/s beside phase
   7's, the ``quant_stats`` bytes, its resident weight bytes (the allocated
   bytes an install adds, beside those of a float serving copy), one batch
   of 4096 through the int8 path and the float weights in turns, and its
   decisions against the bf16 detector on the same fitted weights;
11. checkpoints on the card: the fitted GRU and int8w detectors saved and
   restored into fresh detectors, which must score one batch of 4096
   bit-equal with an equal threshold (the int8w one re-activating
   ungated);
12. the service host (phase ``service``): the port's ``Service`` in this
   process, ``run()`` on a thread, hosting phase 7's configuration on the
   card behind zmq ipc sockets, with ``engine_batch_size`` 16,384 (the
   engine's fused-frame mode). The 2,048 fit messages and then 65,536
   messages go in packed into frames of 512 with blocking sends, and the
   alerts are collected until the stream goes quiet: every line sent must
   be read (``/metrics``), every alert received once and counted written,
   recall >= 0.9, and the alert set must equal what the hosted detector's
   own ``score_tokens`` decides at its threshold outside the 1e-2 band.
   Then the p50 and p99 of 64 lone anomalous messages, send to alert, the
   admin plane (health 200, stop and start, shutdown with its checkpoint,
   a fresh Service restoring it bit-equal), and the CLI as a subprocess
   (fit, 4,096 messages, alerts, ``POST /admin/shutdown``, exit 0);
13. the scorer example's adaptive batching (phase ``coalesce``):
   ``examples/scorer_settings.yaml`` and ``examples/scorer_config.yaml``
   with ``head_impl: pallas``, the addresses under a temp directory, a free
   HTTP port and the port's component type, and nothing else changed
   (vocab 32768, dim 128, seq_len 32, max_batch 1024, ``score_norm:
   position``, ``batch_deadline_ms`` 8, ``engine_batch_size`` 32). (a) The
   port's ``Service`` in this process: the 512 fit messages and 65,536
   messages sent one by one over zmq ipc, then 64 lone anomalous messages:
   socket lines/s, lone p50/p99, releases by reason, mean occupancy and the
   largest release wait (at most 8 ms + one drain tick + 2 ms), every line
   read, each alert received once, recall >= 0.9, no decision farther than
   1e-2 from the threshold apart from the plain (einsum-head) path on the
   same weights, the warm set on ``GET /admin/xla``, no unexpected
   recompile, deep health healthy after warm-up, and
   ``detector_deadline_releases_total`` equal to ``batching_stats()``. (b)
   The same configuration with ``bucket_retire_interval_s: 1`` in process,
   traffic in two sizes: a bucket retires (its graph dropped), its rows pad
   up, and persistent pressure brings it back with one expected capture;
   ``device_hbm_bytes`` before and after. (c) The (a) stream in process
   through ``process_batch`` with ``upload_workers: 1``: alerts identical
   to inline dispatch (the wall-clock timestamps aside);
14. the model lifecycle (phase ``lifecycle``): the scorer example with
   ``rollout_enabled``, ``drift_enabled`` and ``capacity_enabled``, hosted by
   the port's ``Service`` with a fresh capture ledger, every other
   ``rollout_*``/``drift_*``/``capacity_*`` setting at its default but the
   run-time cuts of ``LIFECYCLE_SETTINGS``, fed by a sender process. (e)
   After the fit, 1 s idle: the probed capacity (``source: probe``). (a)
   65,536 single messages; once the reservoir holds 1,024 rows, ``POST
   /admin/model {"action": "cycle", "block": true}`` while they flow: its
   verdict under the default gate, fine-tune steps and seconds, the shadow
   mean delta and flip ratio; every line read, alerts once each, recall >=
   0.9; 64 lone messages, then lone messages during a second cycle; the
   largest release wait and the lone p50 inside and outside the cycles
   (every manager verb's span is a cycle), the 12 ms bound held outside;
   ``GET /admin/slo``'s modeled capacity beside the socket rate. (b) A
   stored version promoted over HTTP, then a rollback (a version promoted
   first when none was live): after each swap no capture at all, every
   warm bucket's replay bit-equal to eager, the installed version's stored
   weights scored as a candidate bit-equal to the live graph on 1,024
   rows, the copy and CPU-mirror seconds; the swap series exported. (c) A
   broken candidate (the embedding times 10) through ``inject_candidate``:
   held back, its ``model_canary_holdback`` event and metric. (d) 65,536
   messages of another template mix: ``drift_detected``, a drift-started
   cycle in ``/admin/model?history=1``, ``model_drift_score`` over its
   threshold in ``/admin/drift``; no failed capacity probe;
15. the observability plane (phase ``trace``): a ``relay`` stage (core) and
   a ``sink`` stage (core, the telemetry collector) as port CLI processes
   around the scorer example's detector in this process, all three with
   ``engine_trace`` (the detector with ``trace_terminal``, relay and
   detector exporting spans); 32,768 single messages from a sender
   process, a 1 s ``POST /admin/profile`` on the detector during the
   stream (a second request answers 409), 64 lone messages, two more
   captures (pruned to ``profile_max_captures`` = 2). Every line read,
   alerts once each, recall >= 0.9, no unexpected capture, the largest
   release wait outside the capture within 12 ms; ``/admin/trace``
   completed = frames the relay sent, hops relay → detector in time order;
   the ``pipeline_*`` counts one per frame; ``/admin/slo`` windows filled
   and both stages in the dwell attribution; two-hop traces in
   ``/admin/traces`` and an e2e exemplar naming one; the capture's zip
   holds CUDA kernel events, ``lse_wgmma_kernel`` at least once per replay
   in its window. Printed: socket lines/s, lone and e2e p50/p99, trace
   events and bytes, the device's busy share and 3 longest idle gaps over
   the window, kernel 1's time in the trace beside its CUDA-event time;
16. the chip plane (phase ``mesh``, ``parallel/``): one process drives a
   mesh that repeats ``cuda:0`` eight times, so the phase proves the
   sharding, the ring and the reductions, not copies between GPUs. (a)
   Ring attention at ``examples/seqparallel_config.yaml``'s widths (B 8,
   H 4, S 2048, D 64, a PAD tail of 600 keys across the last seq shard's
   boundary) over {seq: 4} and {data: 2, seq: 4}, fp32 and bf16, output
   and gradients, against the one-device blockwise attention (fp32 within
   1e-4, bf16 within 2e-2). (b) BASELINE config #5,
   ``examples/mesh_scorer_config.yaml`` with the port's class name and
   ``head_impl: pallas``: fit on 512 messages, 65,536 through
   ``process_batch`` in calls of 8,192; kernel 1 launched once per data row
   in every calibration chunk and device batch, all from graph replays;
   scores against the one-device detector on the same weights (max
   |delta|, no flip 1e-2 or farther from the threshold); lines/s. (c)
   ``examples/seqparallel_config.yaml`` as written but the class name and
   the head (``attn_impl: ring``, {data: 2, seq: 4}, dim 256, depth 4,
   seq_len 2048): its fit (the loss must fall), then 1,024 messages;
   scores within 2e-2 of the one-device detector with ``attn_impl:
   flash`` on the same weights, no flip 1e-2 or farther. (d) A mesh of
   one ({data: 1}): scores bit-equal to the one-device detector fitted on
   the same messages. (e) A process group of one over NCCL and a localhost
   coordinator in a subprocess: one ``all_reduce``, ``process_info``,
   exit 0 within 120 s;
17. the container demo stack (phase ``pipeline``): ``container/config/``'s
   reader, parser, detector and output settings and configs with only the
   detector's class (the port's scorer, ``head_impl: pallas``), the
   addresses, the HTTP ports and the paths changed, as four port CLI
   processes over ipc sockets (the detector's counting its kernel
   launches, ``serve_counted``). 2,048 raw audit lines of this script's
   own generator (``make_audit_log``) to fit on, then 65,536 with 1 %
   anomalies, go into the reader in frames of 512; a 1 s ``/admin/profile``
   capture of the detector's process runs during the stream. Every stage
   must read every line its upstream wrote, every parser output (a tap
   beside the detector) equal the port's plain parse of its line but the
   drawn ids and timestamps, recall >= 0.9 from the output files, no alert
   flip against the einsum head on the stage's shutdown checkpoint 1e-2 or
   farther from the threshold, kernel 1 hold against its plain version at
   every shape the detector gave it (2e-3), and every process exit 0 after
   ``POST /admin/shutdown``, the captured one too; lines/s per stage and
   end to end;
18. last, a 1 s capture over phase 7b's ``process_frames`` loop on a fresh
   detector of its configuration, with its busy share (``frames_profile``);

The LogBERT check (in phase 8, before its detector is freed):
``rollout_fine_tune`` on 256 sampled rows (8 steps through the flash
forward, dQ and dK/dV), ``rollout_scores`` of live and candidate, then
``install_candidate``: no capture, the 256 bucket's replay bit-equal to
eager, the candidate's scores bit-equal to the live ones, exact launch
counts. The int8w check (after phase 11, on phase 10's detector): one
fine-tune and one install under ``dtype: int8w``: the gate judged again
(rows, flips), every warm bucket re-captured as an expected capture, none
unexpected, replays bit-equal to eager, the int8 state's bytes equal to
``quant_stats``.

Every device batch on a CUDA device is the replay of a CUDA graph of the
detector's warm set (``library/detectors/graphs.py``). A capture's kernel
launches are not counted; each replay adds the launches its capture
recorded, so the counts below are the kernels run for scored batches, and
every scored batch's fused-head launches must have come from replays. For
the MLP (1024 and 32 rows), GRU (4096) and LogBERT (256) buckets, and again
after norm calibration, int8 activation and a checkpoint restore, a replay
is held bit-equal to the eager call on the same batch and both are timed
(``replay_vs_eager`` lines).

Phases 13–15, the three that hold the 12 ms release-wait bound, each run
in a fresh interpreter of their own (``run_isolated``; the kernels load from
the build cache of phase 2): the service a phase hosts shares its process
with nothing of the phases before it, as a deployed detector shares its
CLI process with nothing else.

Each detector run resets every kernel's launch count just before and reads
them just after (the lifecycle paths too: ``lifecycle``, ``int8w_lifecycle``
and ``logbert_lifecycle``, where a candidate's shadow chunks run op by op
and checks beside the path run ``uncounted``); the counts must be exactly
what the path launches, and
every bf16 flash and fused-head launch on every path must have taken its
tensor-core (wgmma) variant. Then
the kernel summary line, and last ``{"ok": true, "device": ...}``. Any
failed phase raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA device. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import bench_torch
from detectmateservice_tpu_torch.core import Service
from detectmateservice_tpu_torch.engine import device_obs
from detectmateservice_tpu_torch.engine.engine import count_lines
from detectmateservice_tpu_torch.engine.framing import pack_batch, unpack_batch
from detectmateservice_tpu_torch.engine.socket import TransportTimeout, ZmqPairSocketFactory
from detectmateservice_tpu_torch.library.detectors import TorchScorerDetector
from detectmateservice_tpu_torch.models import quant
from detectmateservice_tpu_torch.models.mlp import MLPScorer
from detectmateservice_tpu_torch.ops import cuda_build, flash, scorehead
from detectmateservice_tpu_torch.schemas import DetectorSchema, ParserSchema
from detectmateservice_tpu_torch.settings import ServiceSettings
from detectmateservice_tpu_torch.utils import matchkern, profiling

# published dense peaks of one H100 SXM (operations/s) and its HBM rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# the bench configuration (bench.py BENCH_SCORER_CONFIG) on the port, as
# bench_torch.py runs it
SCORER_CONFIG = dict(bench_torch.BENCH_SCORER_CONFIG, dtype="auto")
N_DETECT = 65536
CALL_SIZE = 4096

# examples/seqparallel_config.yaml on one card: attn_impl flash in place of
# ring over a mesh, and the fused head
LOGBERT_CONFIG = {
    "method_type": "torch_scorer", "auto_config": False, "model": "logbert",
    "attn_impl": "flash", "head_impl": "pallas", "vocab_size": 32768,
    "dim": 256, "depth": 4, "heads": 4, "seq_len": 2048, "score_topk": 8,
    "data_use_training": 512, "train_epochs": 4, "threshold_sigma": 5.0,
    "max_batch": 256, "host_score_max_batch": 0, "dtype": "auto",
    "async_fit": False,
}
LOGBERT_DETECT = 4096
LOGBERT_CALL = 256
LOGBERT_PLAIN_CALL = 64  # einsum attention: [64, 4, 2048, 2048] fp32 logits

# examples/gru_config.yaml on the port, with the fused head; the fit runs
# synchronously so that its seconds are measured
GRU_CONFIG = {
    "method_type": "torch_scorer", "auto_config": False, "model": "gru",
    "vocab_size": 32768, "dim": 128, "depth": 1, "seq_len": 32,
    "score_norm": "position", "data_use_training": 512, "train_epochs": 4,
    "threshold_sigma": 5.0, "max_batch": 4096, "head_impl": "pallas",
    "dtype": "auto", "async_fit": False,
}
GRU_DETECT = 65536
GRU_CALL = 4096

# phase 7's configuration under weight-only int8
INT8_CONFIG = dict(SCORER_CONFIG, dtype="int8w")

# the service phase: phase 7's configuration hosted by the port's Service
TORCH_SCORER = "detectmateservice_tpu_torch.library.detectors.torch_scorer.TorchScorerDetector"
SERVICE_DETECT = 65536
SERVICE_FRAME = 512
SERVICE_LONE = 64
SERVICE_CLI_DETECT = 4096

# the coalesce phase: the scorer example (BASELINE config #3)
COALESCE_DETECT = 65536
COALESCE_LONE = 64
COALESCE_RETIRE_S = 1.0
# one round of (b)'s traffic: a small release's rows (natural bucket 256)
# and a large call's (a full release of the largest bucket)
RETIRE_SMALL = 200
RETIRE_LARGE = 1024
# off the card (a CPU rehearsal) the example is narrowed to these values
COALESCE_CPU_CHANGES = {"vocab_size": 1024, "dtype": "float32"}

# the pipeline phase: container/config/'s demo stack, its detector the port's
# scorer; raw audit lines go into the reader in frames of PIPELINE_FRAME
PIPELINE_STAGES = ("reader", "parser", "detector", "output")
# a stage that stops answering: the signal each stage process dumps every
# thread's stack on (faulthandler, from its signal handler, so a thread
# holding the interpreter does not stop it), and how long the phase waits
# for the dumps
PIPELINE_DUMP_SIGNAL = signal.SIGUSR1
PIPELINE_DUMP_WAIT_S = 2.0
# the stage processes: the port's CLI with that dump armed
PIPELINE_STAGE_CODE = (
    "import faulthandler, sys; "
    f"faulthandler.register({int(PIPELINE_DUMP_SIGNAL)}, all_threads=True); "
    "from detectmateservice_tpu_torch import cli; "
    "sys.exit(cli.main(['--settings', sys.argv[1]]))")
PIPELINE_FIT = 2048
PIPELINE_DETECT = 65536
PIPELINE_FRAME = 512
AUDIT_NORMAL = (("cron", "/usr/sbin/cron", 0), ("sshd", "/usr/sbin/sshd", 0),
                ("systemd", "/lib/systemd/systemd", 0), ("bash", "/bin/bash", 1000),
                ("python3", "/usr/bin/python3", 1000))
AUDIT_ANOMALOUS = (("nc", "/tmp/.hidden/nc", 1000), ("xmrig", "/dev/shm/xmrig", 33),
                   ("sh", "/var/www/uploads/sh", 33))
# off the card (a CPU rehearsal) the detector is narrowed to these values
PIPELINE_CPU_CHANGES = {"vocab_size": 1024, "dim": 32, "max_batch": 1024,
                        "dtype": "float32"}

# the lifecycle phase: the scorer example with rollout, drift and capacity
# on, every other rollout_*/drift_*/capacity_* setting at its default but
# these cuts for run time: cycles are sent over HTTP (no interval cycle),
# drift and capacity tick every 0.5 s, drift starts a cycle at once, and
# the idle probe runs after 1 s
LIFECYCLE_SETTINGS = {"rollout_enabled": True, "drift_enabled": True, "capacity_enabled": True,
                      "rollout_interval_s": 3600.0, "drift_interval_s": 0.5,
                      "drift_min_cycle_interval_s": 0.0, "capacity_interval_s": 0.5,
                      "capacity_probe_idle_s": 1.0}
LIFECYCLE_DETECT = 65536
LIFECYCLE_LONE = 64
# (a)'s cycle is sent once the reservoir holds this many rows (about 20,000
# messages into the stream at the default ratio of 0.05)
LIFECYCLE_CYCLE_AT = 1024
# (d)'s shifted stream: as many messages as the stream the baseline came from
LIFECYCLE_SHIFTED = 65536
# the LogBERT check: 256 sampled rows, 8 train steps of 32
LOGBERT_LIFECYCLE_ROWS = 256

# phase 15 (trace): half the coalesce stream through a traced three-stage
# pipeline, a 1 s profiler capture during it (and one over phase 7b), three
# captures against a bound of 2
TRACE_DETECT = 32768
TRACE_LONE = 64
TRACE_PROFILE_S = 1.0
TRACE_PRUNE_S = 0.2
TRACE_MAX_CAPTURES = 2
TRACE_RELAY_BATCH = 64

# phase mesh: the chip plane on one card, whose mesh repeats cuda:0
MESH_DEVICES = 8
# (a) ring attention at examples/seqparallel_config.yaml's widths: B, H, S,
# D, and a PAD tail across the last seq shard's boundary
RING_SHAPE = (8, 4, 2048, 64)
RING_PAD_TAIL = 600
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # max |delta|, outputs and grads
# (b) examples/mesh_scorer_config.yaml: 512 fit messages, then 65,536 in
# process_batch calls of max_batch
MESH_DETECT = 65536
MESH_CALL = 8192
# max |delta score| against one device: bf16 operands and fp32 sums on both
# sides; only the rows' GEMM shapes and the head's split differ
MESH_TOL = 1e-3
# (c) examples/seqparallel_config.yaml: a fit, then 1,024 messages; its
# depth cut from 4 to 2 to make room for (f) and (g) in the script's time
# (the ring's arithmetic is the same in every layer)
MESH_SEQ_CUTS = {"depth": 2}
MESH_SEQ_DETECT = 1024
MESH_SEQ_CALL = 256
MESH_SEQ_TOL = 2e-2        # the JAX package's sharded bound (tests/test_parallel.py)
# (d) a mesh of one, bit-equal to one device
MESH_ONE_DETECT = 4096
# narrowed widths for a CPU rehearsal (tests/test_torch_chip_smoke.py)
MESH_CPU_CHANGES = {"vocab_size": 1024, "dtype": "float32"}
MESH_SEQ_CPU_CHANGES = {"vocab_size": 1024, "dtype": "float32"}
# (f) and (g): the model axis computing (LogBERT's Megatron split): (f)
# examples/mesh_scorer_config.yaml's widths on {data: 4, model: 2} (kernel
# 1), the fit, then 8,192 messages in one call of max_batch; (g)
# examples/seqparallel_config.yaml's widths with attn_impl flash (the three
# flash kernels at H / 2 = 2 heads per shard) on {data: 2, model: 2}, the
# fit, then 1,024 messages in calls of max_batch
MESH_MODEL_SHAPE = {"data": 4, "model": 2}
MESH_MODEL_DETECT = 8192
MESH_MODEL_CALL = 8192
MESH_MODEL_FLASH_SHAPE = {"data": 2, "model": 2}
MESH_MODEL_FLASH_DETECT = 1024
MESH_MODEL_FLASH_CALL = 256
MESH_MODEL_CPU_CHANGES = {"vocab_size": 1024, "dtype": "float32"}
MESH_MODEL_FLASH_CPU_CHANGES = {"vocab_size": 1024, "dtype": "float32"}
MESH_MODEL_REPS = 5
# the bound on (f)'s bf16 positional z-scores (sigma floored at 0.05)
# against one device. Any change of a sum's order flips a few bf16
# roundings that the blocks carry on, so MESH_TOL holds only in fp32
# (mesh_split_controls). The bound lies above one device's gap to itself
# with its row-parallel sums reordered (the "reordered" control, which
# must pass it) and below a swap of proj's two head halves (the "swapped"
# control, which must fail it)
MESH_MODEL_TOL = 0.5

# (N, C, D, dtype) of the fused-head checks: the MLP path's detect, warm-up
# and calibration buckets, the LogBERT path's detect batch and calibration
# chunk (N = B * 2048 rows), the GRU path's (N = B * 32 rows), then edge
# shapes
LSE_CASES = [
    (16384, 32768, 128, torch.bfloat16),
    (4096, 32768, 128, torch.bfloat16),
    (32, 32768, 128, torch.bfloat16),
    (1, 32768, 128, torch.bfloat16),
    (524288, 32768, 256, torch.bfloat16),
    (65536, 32768, 256, torch.bfloat16),
    (1, 32768, 256, torch.bfloat16),
    (131072, 32768, 128, torch.bfloat16),   # the GRU path's detect batch
    (1024, 32768, 128, torch.bfloat16),     # and calibration chunk
    (1000, 2048, 128, torch.float32),
    (100, 613, 16, torch.float32),
    (16, 16, 32, torch.float32),   # the extreme values of test_scorehead.py
    (37, 64, 256, torch.float16),
    (32, 1031, 256, torch.float16),
    (1, 1031, 256, torch.float16),
    # bf16 twins for the tensor-core variants: ragged C (not a whole number
    # of 128-column stages; 1031 splits in two at N = 100) at every D the
    # main paths and the plan take, D = 16, and the extreme values
    (100, 613, 64, torch.bfloat16),
    (100, 1031, 64, torch.bfloat16),
    (100, 613, 128, torch.bfloat16),
    (100, 1031, 128, torch.bfloat16),
    (100, 613, 256, torch.bfloat16),
    (100, 1031, 256, torch.bfloat16),
    (100, 613, 16, torch.bfloat16),
    (16, 16, 32, torch.bfloat16),
]
# (N, D) of the fused-head timings; the plain version runs in row chunks
LSE_TIMED = ((16384, 128), (4096, 128), (256, 128), (32, 128), (65536, 256),
             (524288, 256), (131072, 128), (1024, 128))
LSE_PLAIN_ROWS = 16384
# the library call's bf16 [N, C] product (4 GiB at 65,536 rows) fits at
# N <= 65536; beyond, it runs once per row chunk of this size
LSE_LIBRARY_ROWS = 65536

# (B, H, S, T, D, dtype, mask, backward, layout) of the flash checks: the
# LogBERT scoring and training shapes with real-row key masks (10-40 valid
# keys), then ragged, tiny, fp16 maskless, fully masked and D = 128 edge
# shapes, fp32 ones (CUDA-core variants) with bf16 twins (wgmma variants),
# and q, k, v as strided views of one [B, S, 3 H D] tensor ("qkv", as
# models/logbert.py makes them) beside separate contiguous tensors
FLASH_CASES = [
    (256, 4, 2048, 2048, 64, torch.bfloat16, "rows", False, "contiguous"),
    (32, 4, 2048, 2048, 64, torch.bfloat16, "rows", True, "contiguous"),
    (2, 3, 200, 384, 64, torch.float32, "random", True, "contiguous"),
    (2, 3, 200, 384, 64, torch.bfloat16, "random", True, "contiguous"),
    (2, 2, 100, 60, 32, torch.float32, "random", True, "contiguous"),
    (1, 1, 1, 1, 64, torch.float32, None, True, "contiguous"),
    (1, 1, 1, 1, 64, torch.bfloat16, None, True, "contiguous"),
    (2, 2, 64, 64, 128, torch.float16, None, True, "contiguous"),
    (2, 2, 70, 90, 64, torch.float32, "one_row_masked", True, "contiguous"),
    (2, 2, 70, 90, 64, torch.bfloat16, "one_row_masked", True, "contiguous"),
    (3, 2, 300, 300, 128, torch.bfloat16, "rows", True, "contiguous"),
    (4, 4, 520, 520, 64, torch.bfloat16, "rows", True, "qkv"),
]
FLASH_SCORING = (256, 4, 2048, 2048, 64)
FLASH_TRAINING = (32, 4, 2048, 2048, 64)
FLASH_REPS = 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def make_messages(n: int, anomaly_rate: float = 0.01, seed: int = 0):
    """bench.py's ``make_messages`` on the port's schemas; also returns the
    logIDs of the injected segfault anomalies."""
    rng = np.random.default_rng(seed)
    msgs, anomalies = [], set()
    for i in range(n):
        if rng.random() < anomaly_rate:
            template, variables = "segfault at <*> ip <*> sp <*>", [
                hex(rng.integers(2**30)), hex(rng.integers(2**30)), hex(rng.integers(2**30))]
            anomalies.add(str(i))
        else:
            template, variables = "type=<*> msg=audit(<*>): pid=<*> uid=<*> comm=<*>", [
                "SYSCALL", f"17000{i % 100}.{i % 997}", str(int(rng.integers(300, 500))),
                str(int(rng.integers(0, 4))), ["cron", "sshd", "systemd", "bash"][i % 4]]
        msgs.append(ParserSchema(
            EventID=1, template=template, variables=variables,
            logID=str(i), logFormatVariables={"Time": str(1_700_000_000 + i)},
        ).serialize())
    return msgs, anomalies


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


KERNEL_WRAPPERS = (scorehead.candidate_lse, flash.flash_forward, flash.flash_dq,
                   flash.flash_dkv)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.variants.clear()


def read_variants() -> dict:
    """Each wrapper's launches by kernel variant."""
    return {fn.__name__: dict(fn.variants) for fn in KERNEL_WRAPPERS}


def read_launches() -> dict:
    return {"candidate_lse": scorehead.candidate_lse.launches,
            "flash_forward": flash.flash_forward.launches,
            "flash_dq": flash.flash_dq.launches,
            "flash_dkv": flash.flash_dkv.launches}


def replayed(det) -> dict:
    """The kernel launches the detector's graph replays have added, by
    wrapper."""
    return {fn.__name__: det._warm.replay_launches.get(fn.__name__, 0)
            for fn in KERNEL_WRAPPERS}


def replay_delta(det, before: dict) -> dict:
    """The launches the detector's graph replays added since ``before``."""
    return {name: n - before.get(name, 0) for name, n in replayed(det).items()}


def check_replays(got: dict, want: dict, path: str) -> dict:
    """On a CUDA device every scored batch of a path runs as a replay: the
    launches its replays added (``got``) must be ``want`` (wrappers not
    named: 0)."""
    if got != {name: want.get(name, 0) for name in got}:
        raise AssertionError(f"the {path} path's graph replays launched {got}, "
                             f"expected {want}")
    return got


def replay_vs_eager(det, label: str, stage: str, buckets, msgs) -> list:
    """For each warm bucket: one batch of ``msgs`` through the bucket's
    graph (``_score_dev``) and op by op (``_score_eager``), which must agree
    bit for bit, and both timed with CUDA events (median of 10, the pinned
    upload included). Launches made here are outside every path's count."""
    rows = []
    for bucket in buckets:
        tokens, ok = det._featurize_raw_batch(msgs[:bucket])
        if not ok.all() or len(tokens) != bucket:
            raise AssertionError(f"{label}: {len(tokens)} featurized rows for bucket {bucket}")
        if not det._warm.has(det._serve_kind(), bucket):
            raise AssertionError(f"{label} ({stage}): bucket {bucket} has no valid graph")
        replay = det._score_dev(tokens).cpu().numpy()
        eager = det._score_eager(tokens).cpu().numpy()
        row = dict(label=label, stage=stage, bucket=bucket, kind=det._serve_kind(),
                   bit_equal=bool(np.array_equal(replay, eager)),
                   max_abs_diff=float(np.abs(replay - eager).max()),
                   replay_ms=time_ms(lambda: det._score_dev(tokens), reps=10),
                   eager_ms=time_ms(lambda: det._score_eager(tokens), reps=10))
        emit("replay_vs_eager", **row)
        if not row["bit_equal"]:
            raise AssertionError(f"{label} ({stage}): the bucket-{bucket} replay differs from "
                                 f"the eager call by up to {row['max_abs_diff']}")
        rows.append(row)
    return rows


# -- phase 1 -----------------------------------------------------------------
def phase_card() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    # what the machine offers beyond what the port uses (found, not imported)
    present = {mod: importlib.util.find_spec(mod) is not None
               for mod in ("pydantic", "yaml", "jax", "triton", "zmq",
                           "prometheus_client")}
    present["protobuf"] = (importlib.util.find_spec("google") is not None
                           and importlib.util.find_spec("google.protobuf") is not None)
    present["ninja"] = shutil.which("ninja") is not None
    emit("card", nvidia_smi=line, torch_name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)), present=present)
    return name, line


# -- phase 2 -----------------------------------------------------------------
_KERNEL_NAME = re.compile(
    r"([a-z_]+_kernel)I(?:Li(\d+)E)?(13__nv_bfloat16|6__half|f)E")
_PLAIN_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernel)E")
_TYPE_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
# the tensor-core kernels the main paths run, all bf16: the flash kernels of
# the LogBERT path (D = 64), the fused head at the MLP path's D = 128 and
# LogBERT's D = 256, and the merge of a split head launch
MAIN_PATH_WGMMA = {"forward": "flash_fwd_wgmma_kernel<64, bf16>",
                   "dq": "flash_dq_wgmma_kernel<64, bf16>",
                   "dkv": "flash_dkv_wgmma_kernel<64, bf16>",
                   "lse_d128": "lse_wgmma_kernel<128, bf16>",
                   "lse_d256": "lse_wgmma_kernel<256, bf16>",
                   "lse_combine": "lse_combine_kernel"}
# kernels whose ptxas report must show no spill
NO_SPILL = (*MAIN_PATH_WGMMA.values(), "flash_dq_wgmma_kernel<128, bf16>")


def ptxas_summary(report: str) -> dict:
    """Registers, stack and spill bytes of each kernel in an ``nvcc -Xptxas
    -v`` report, keyed ``name<D, type>`` (``name<type>`` without a D)."""
    out, entry = {}, None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = _KERNEL_NAME.search(found.group(1))
            plain = _PLAIN_KERNEL_NAME.search(found.group(1))
            if name is not None:
                entry = (f"{name.group(1)}<"
                         f"{name.group(2) + ', ' if name.group(2) else ''}"
                         f"{_TYPE_NAMES[name.group(3)]}>")
            else:
                entry = found.group(1) if plain is None else plain.group(1)
            out[entry] = {}
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame and entry is not None:
            out[entry].update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                              spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used and entry is not None:
            out[entry]["registers"] = int(used.group(1))
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    reports = cuda_build.build_all([scorehead.SOURCE, flash.SOURCE])
    wall = time.perf_counter() - t0
    scorehead.build_kernel()  # loads and types the libraries
    flash.build_kernel()
    ptxas = {src: ptxas_summary(rep) for src, rep in reports.items()}
    kernels = {name: row for rows in ptxas.values() for name, row in rows.items()}
    main_path = {name: kernels.get(name) for name in NO_SPILL}
    emit("build", seconds=wall, compile_seconds=cuda_build.build_seconds, ptxas=ptxas,
         main_path_wgmma=main_path,
         lse_max_dim=scorehead._library().dm_candidate_lse_max_dim(),
         flash_max_dim=flash._library().dm_flash_max_dim())
    return main_path


# -- phase 3 -----------------------------------------------------------------
def _lse_inputs(n, c, d, dtype, gen, device: str = "cuda"):
    if (n, c, d) == (16, 16, 32):
        h = torch.full((n, d), 50.0, device=device)
        e = torch.cat([torch.full((8, d), 2.0), torch.full((8, d), -2.0)]).to(device)
    else:
        h = torch.randn(n, d, device=device, generator=gen)
        e = torch.randn(c, d, device=device, generator=gen)
    return h.to(dtype), e.to(dtype)


def row_chunks(n: int, size: int) -> list:
    """Slices of [0, n) of at most ``size`` rows each, in order."""
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


def lse_plain(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The plain version over row chunks, so the fp32 [rows, C] logits stay
    at 2 GiB at C = 32768."""
    return torch.cat([scorehead.candidate_lse_reference(h[sl], e)
                      for sl in row_chunks(h.shape[0], LSE_PLAIN_ROWS)])


def lse_library(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The library yardstick: one ``torch.logsumexp(torch.matmul(h,
    e.T).float(), -1)`` per chunk of at most 65,536 rows (one call up to
    there)."""
    return torch.cat([torch.logsumexp(torch.matmul(h[sl], e.T).float(), -1)
                      for sl in row_chunks(h.shape[0], LSE_LIBRARY_ROWS)])


def check_lse(n, c, d, dtype, gen, device: str = "cuda") -> dict:
    """Kernel 1's wrapper at [N, D] x [C, D] in ``dtype`` against its plain
    version on the same seeded inputs: the check's row (``ok`` False past
    the tolerance)."""
    h, e = _lse_inputs(n, c, d, dtype, gen, device)
    got = scorehead.candidate_lse(h, e)
    if device == "cuda":
        torch.cuda.synchronize()
    want = lse_plain(h, e)
    finite = bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        tol = "rtol 1e-5, atol 1e-4"
        ok = finite and torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        # the same low-precision operands on both sides; products are
        # exact in fp32, only the order of summation differs
        tol = "atol 2e-3"
        ok = finite and err <= 2e-3
    on_card = device == "cuda"
    return dict(kernel="candidate_lse", shape=[n, c, d], dtype=_dtype_name(dtype),
                variant=scorehead.variant(n, c, d, dtype) if on_card else None,
                splits=(scorehead._library().dm_candidate_lse_splits(
                    n, c, d, scorehead._DTYPE_CODES[dtype]) if on_card else None),
                max_abs_err=err, tol=tol, finite=finite, ok=bool(ok))


def phase_kernel_checks() -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for n, c, d, dtype in LSE_CASES:
        row = check_lse(n, c, d, dtype, gen)
        emit("kernel_check", **row)
        if not row["ok"]:
            raise AssertionError(f"candidate_lse disagrees at {(n, c, d, dtype)}: "
                                 f"{row['max_abs_err']}")
        worst = max(worst, row["max_abs_err"])
    return worst


# -- phase 4 -----------------------------------------------------------------
def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _bound(ops: float, nbytes: float, dtype: torch.dtype) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of the inputs' type and the bytes over the HBM rate."""
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def lse_bound(n: int, c: int, d: int, dtype: torch.dtype) -> tuple:
    """Each input read once, the fp32 output written once; 2·N·C·D
    multiply-adds."""
    size = torch.tensor([], dtype=dtype).element_size()
    return _bound(2.0 * n * c * d, (n + c) * d * size + n * 4, dtype)


def phase_timings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for n, d in LSE_TIMED:
        c, dtype = 32768, torch.bfloat16
        h, e = _lse_inputs(n, c, d, dtype, gen)
        chunks = len(row_chunks(n, LSE_LIBRARY_ROWS))
        reps = 5 if chunks > 1 else 25
        kernel_ms = time_ms(lambda: scorehead.candidate_lse(h, e), reps=reps)
        plain_ms = time_ms(lambda: lse_plain(h, e), reps=reps, warmup=1)
        library_ms = time_ms(lambda: lse_library(h, e), reps=reps, warmup=1)
        bound_ms, bound_by = lse_bound(n, c, d, dtype)
        taken = scorehead.variant(n, c, d, dtype)
        rows[(n, d)] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, variant=taken,
                            bound_share=bound_ms / kernel_ms)
        emit("timing", kernel="candidate_lse", shape=[n, c, d], dtype="bfloat16",
             variant=taken, bound_share=bound_ms / kernel_ms, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, reps=reps,
             library_call=("torch.logsumexp(torch.matmul(h, e.T).float(), -1): "
                           "bf16 matmul with a bf16 [N, C] result, then fp32"
                           + (f"; {chunks} chunked calls of {LSE_LIBRARY_ROWS} rows "
                              "in one timed call" if chunks > 1 else "")),
             plain_call="candidate_lse_reference over 16384-row chunks: fp32 "
                        "matmul (TF32 off), logsumexp",
             bound_ms=bound_ms, bound_by=bound_by, flops=2.0 * n * c * d,
             tflops=2.0 * n * c * d / kernel_ms / 1e9)
    return rows


# -- phase 5 -----------------------------------------------------------------
def _flash_inputs(b, h, s, t, d, dtype, mask_kind, gen, layout="contiguous"):
    if layout == "qkv":
        # one [B, S, 3 H D] tensor cut into q, k, v heads, as the model does
        assert s == t
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen).to(dtype)
        q, k, v = (x.reshape(b, s, h, d).transpose(1, 2)
                   for x in qkv.split(h * d, dim=-1))
    elif layout == "shard":
        # the second of two model shards' heads, cut from the gathered
        # [B, S, 3 (2 H) D] qkv (models/logbert.py LogBERTOverShards)
        assert s == t
        qkv = torch.randn(b, s, 6 * h * d, device="cuda", generator=gen).to(dtype)
        q, k, v = (x[..., h * d:].reshape(b, s, h, d).transpose(1, 2)
                   for x in qkv.split(2 * h * d, dim=-1))
    else:
        q = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, h, t, d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
    if mask_kind is None:
        mask = None
    elif mask_kind == "rows":
        # a tokenized log line: its first 10-40 positions are real tokens
        valid = torch.randint(10, 41, (b, 1), device="cuda", generator=gen)
        mask = torch.arange(t, device="cuda")[None, :] < valid
    else:
        mask = torch.rand(b, t, device="cuda", generator=gen) > 0.2
        if mask_kind == "one_row_masked":
            # as for an all-PAD row in the model: no key, and no gradient
            # flowing back into it
            mask[1] = False
            g[1] = 0
    return q, k, v, g, mask


def _close(got, want, dtype, grad: bool) -> tuple:
    """(ok, max_abs_err, tolerance) of a kernel result against its plain
    version on the same operands."""
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        return finite and err <= 1e-4, err, "atol 1e-4"
    if not grad:
        return finite and err <= 2e-2, err, "atol 2e-2"
    # gradients in 16-bit: 5e-2, plus one ulp of the type (a sum taken in
    # another order may round to the neighbouring value)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    ok = finite and bool(torch.allclose(got.float(), want.float(), rtol=ulp, atol=5e-2))
    return ok, err, f"atol 5e-2 + rtol {ulp}"


# the kernel each result held against its plain version comes from
_FLASH_RESULT_KERNEL = {"out": "flash_forward", "dq": "flash_dq", "dk": "flash_dkv",
                        "dv": "flash_dkv"}


def flash_case_results(case: tuple, gen: torch.Generator) -> dict:
    """Every result of one ``FLASH_CASES`` entry held against its plain
    version: name -> (ok, max_abs_err, tolerance)."""
    b, h, s, t, d, dtype, mask_kind, backward, layout = case
    q, k, v, g, mask = _flash_inputs(b, h, s, t, d, dtype, mask_kind, gen, layout)
    out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
    torch.cuda.synchronize()
    want_out, want_lse = flash.flash_forward_reference(q, k, v, mask)
    results = {"out": _close(out, want_out, dtype, grad=False)}
    lse_err = (lse - want_lse).abs().max().item()
    results["lse"] = (bool(torch.isfinite(lse).all())
                      and bool(torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-3)),
                      lse_err, "rtol 1e-5, atol 1e-3")
    scoring_out, _ = flash.flash_forward(q, k, v, mask, want_lse=False)
    results["out_without_lse"] = (bool(torch.equal(scoring_out, out)), 0.0, "equal")
    if backward:
        delta = flash.flash_delta(g, out)
        dq = flash.flash_dq(q, k, v, mask, g, lse, delta)
        dk, dv = flash.flash_dkv(q, k, v, mask, g, lse, delta)
        torch.cuda.synchronize()
        want_dq = flash.flash_dq_reference(q, k, v, mask, g, lse, delta)
        want_dk, want_dv = flash.flash_dkv_reference(q, k, v, mask, g, lse, delta)
        for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                                ("dv", dv, want_dv)):
            results[name] = _close(got, want, dtype, grad=True)
        if dtype == torch.float32:
            # an independent formulation too: autograd through the einsum
            # reference, the gradients of sum(out * g)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            ref_out = flash.reference_attention(*leaves, mask)
            for name, got, want in zip(
                    ("dq_autograd", "dk_autograd", "dv_autograd"), (dq, dk, dv),
                    torch.autograd.grad(ref_out, leaves, g)):
                results[name] = _close(got, want, dtype, grad=True)
        # dV is never all zero (with one key, dQ and dK are)
        grad_max = max(x.abs().max().item() for x in (dq, dk, dv))
        results["grad_max_abs"] = (dv.abs().max().item() > 0, grad_max, "dV nonzero")
    return results


def phase_flash_checks() -> dict:
    """Each flash kernel's largest |kernel - plain| over the cases."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"flash_forward": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for case in FLASH_CASES:
        b, h, s, t, d, dtype, mask_kind, backward, layout = case
        results = flash_case_results(case, gen)
        # every 16-bit kind runs its wgmma kernel, every fp32 one CUDA cores
        variants = {kind: flash.variant(kind, dtype, d) for kind in ("forward", "dq", "dkv")}
        route = "cuda_core" if dtype == torch.float32 else "wgmma_tma"
        ok = (all(r[0] for r in results.values())
              and all(v.startswith(route) for v in variants.values()))
        emit("flash_check", shape=[b, h, s, t, d], dtype=_dtype_name(dtype),
             mask=mask_kind, backward=backward, layout=layout, ok=ok,
             variants=variants,
             **{name: {"max_abs_err": r[1], "tol": r[2], "ok": r[0]}
                for name, r in results.items()})
        if not ok:
            raise AssertionError(f"flash kernels disagree at {(b, h, s, t, d, dtype)} "
                                 f"({variants}): {results}")
        for name, r in results.items():
            if name in _FLASH_RESULT_KERNEL:
                kernel = _FLASH_RESULT_KERNEL[name]
                worst[kernel] = max(worst[kernel], r[1])
        torch.cuda.empty_cache()
    return worst


# -- phase 6 -----------------------------------------------------------------
def flash_bound(kind: str, b, h, s, t, d, dtype, with_lse: bool = False) -> tuple:
    """Operations 4 (forward), 6 (dQ) or 8 (dK/dV) · BH·S·T·D; bytes: every
    input read once (q, k, v, the fp32 [B, T] bias, and dO, lse, delta for
    the backward), every output written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    bh = b * h
    q_bytes, kv_bytes, rows = bh * s * d * size, bh * t * d * size, bh * s * 4
    bias = b * t * 4
    if kind == "forward":
        ops = 4.0 * bh * s * t * d
        nbytes = 2 * q_bytes + 2 * kv_bytes + bias + (rows if with_lse else 0)
    elif kind == "dq":
        ops = 6.0 * bh * s * t * d
        nbytes = 3 * q_bytes + 2 * kv_bytes + bias + 2 * rows
    else:
        ops = 8.0 * bh * s * t * d
        nbytes = 2 * q_bytes + 4 * kv_bytes + bias + 2 * rows
    return _bound(ops, nbytes, dtype) + (ops,)


def phase_flash_timings() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for label, shape in (("scoring", FLASH_SCORING), ("training", FLASH_TRAINING)):
        b, h, s, t, d = shape
        dtype = torch.bfloat16
        q, k, v, g, mask = _flash_inputs(b, h, s, t, d, dtype, "rows", gen)
        bias = flash.key_bias(mask)[:, None, None, :].to(dtype).expand(b, h, s, t)
        want_lse = label == "training"
        kinds = {"forward": (
            lambda: flash.flash_forward(q, k, v, mask, want_lse=want_lse),
            lambda: flash.flash_forward_reference(q, k, v, mask),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))}
        if label == "training":
            out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
            delta = flash.flash_delta(g, out)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)

            def sdpa_backward():
                torch.autograd.grad(sdpa_out, (qg, kg, vg), g, retain_graph=True)

            kinds["dq"] = (lambda: flash.flash_dq(q, k, v, mask, g, lse, delta),
                           lambda: flash.flash_dq_reference(q, k, v, mask, g, lse, delta),
                           sdpa_backward)
            kinds["dkv"] = (lambda: flash.flash_dkv(q, k, v, mask, g, lse, delta),
                            lambda: flash.flash_dkv_reference(q, k, v, mask, g, lse, delta),
                            sdpa_backward)
        for kind, (kernel, plain, library) in kinds.items():
            kernel_ms = time_ms(kernel, reps=FLASH_REPS)
            plain_ms = time_ms(plain, reps=FLASH_REPS, warmup=1)
            library_ms = time_ms(library, reps=FLASH_REPS)
            bound_ms, bound_by, ops = flash_bound(kind, b, h, s, t, d, dtype,
                                                  with_lse=want_lse)
            rows[(kind, label)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, shape=list(shape),
                                       variant=flash.variant(kind, dtype, d),
                                       bound_share=bound_ms / kernel_ms)
            emit("flash_timing", kernel=kind, label=label, shape=list(shape),
                 dtype="bfloat16", with_lse=want_lse if kind == "forward" else None,
                 variant=rows[(kind, label)]["variant"],
                 bound_share=rows[(kind, label)]["bound_share"],
                 ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                 library_call=("F.scaled_dot_product_attention with the additive "
                               "[B, T] bias" if kind == "forward" else
                               "torch.autograd.grad of that call's output: the whole "
                               "backward (dQ, dK and dV in one)"),
                 bound_ms=bound_ms, bound_by=bound_by, flops=ops,
                 tflops=ops / kernel_ms / 1e9, reps=FLASH_REPS)
        del q, k, v, g, mask, bias, kinds
        torch.cuda.empty_cache()
    return rows


# -- phases 7 and 8 ----------------------------------------------------------
def _alerts_by_id(alerts, threshold, detector_name="TorchScorerDetector"):
    """Alerts by logID, each checked for the fields every alert carries."""
    out = {}
    for raw in alerts:
        alert = DetectorSchema.from_bytes(raw)
        log_id = alert["logIDs"][0]
        want_ts = 1_700_000_000 + int(log_id)
        if (alert["detectorID"] != detector_name
                or alert["detectorType"] != "torch_scorer"
                or not alert["alertID"] or alert["detectionTimestamp"] <= 0
                or alert["receivedTimestamp"] <= 0
                or alert["extractedTimestamps"] != [want_ts]
                or alert["description"] != TorchScorerDetector.description
                or not alert["score"] > threshold
                or list(alert["alertsObtain"]) != [f"{detector_name} - score"]):
            raise AssertionError(f"malformed alert {alert!r}")
        out[log_id] = alert
    return out


def _flips(det_by_id, plain_by_id, plain_det, msgs, threshold, call: int) -> tuple:
    """Decisions that differ between two runs, and each one's distance from
    the threshold under the plain run's scores (scored in calls of at most
    ``call`` rows); fails beyond 1e-2."""
    flips = sorted(set(det_by_id) ^ set(plain_by_id), key=int)
    near = []
    if flips:
        tokens, ok = plain_det._featurize_raw_batch([msgs[int(i)] for i in flips])
        assert ok.all()
        scores = np.concatenate([plain_det.score_tokens(tokens[i:i + call])
                                 for i in range(0, len(tokens), call)])
        near = [float(abs(s - threshold)) for s in scores]
        if max(near) >= 1e-2:
            raise AssertionError(f"kernel and plain paths disagree beyond 1e-2 of "
                                 f"the threshold: {list(zip(flips, near))}")
    return flips, near


def _stream(det, msgs, call: int) -> tuple:
    """``process_batch`` over ``msgs`` in calls of ``call``, then
    ``flush_final``: (alerts, seconds)."""
    alerts = []
    t0 = time.perf_counter()
    for start in range(0, len(msgs), call):
        alerts.extend(det.process_batch(msgs[start:start + call]))
    alerts.extend(det.flush_final())
    return alerts, time.perf_counter() - t0


def phase_detector(device: str = "cuda") -> dict:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": SCORER_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    train_msgs, _ = make_messages(SCORER_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    fit_s = time.perf_counter() - t0
    alerts, detect_s = _stream(det, detect_msgs, CALL_SIZE)
    counts = read_launches()
    launches = counts["candidate_lse"]
    graph = replay_delta(det, replays0)
    if device == "cuda":
        check_replays(graph, {"candidate_lse": launches}, "MLP")

    threshold = det._threshold
    calib_chunks = -(-SCORER_CONFIG["data_use_training"] // 32)
    if det.path_counts["device"] != N_DETECT // CALL_SIZE or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    if launches != calib_chunks + det.path_counts["device"]:
        raise AssertionError(f"kernel launched {launches} times on the main path, "
                             f"expected {calib_chunks} calibration chunks + "
                             f"{det.path_counts['device']} device batches")
    if counts["flash_forward"] or counts["flash_dq"] or counts["flash_dkv"]:
        raise AssertionError(f"the MLP path launched flash kernels: {counts}")
    variants = read_variants()["candidate_lse"]
    check_head_variants(variants, "wgmma_tma_d128_", launches, "MLP")
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")

    by_id = _alerts_by_id(alerts, threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))
    # host share: the same featurize pass alone, off the device
    t0 = time.perf_counter()
    det._featurize_raw_batch(detect_msgs)
    featurize_s = time.perf_counter() - t0

    # the same stream through the einsum head on the same fitted weights
    ein = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        SCORER_CONFIG, head_impl="einsum", data_use_training=0,
        score_threshold=threshold)}})
    ein.load_params(det._model.state_dict())
    ein_alerts, _ = _stream(ein, detect_msgs, CALL_SIZE)
    if scorehead.candidate_lse.launches != launches:
        raise AssertionError("the einsum head launched the fused kernel")
    ein_by_id = _alerts_by_id(ein_alerts, threshold)
    flips, near = _flips(by_id, ein_by_id, ein, detect_msgs, threshold, CALL_SIZE)

    # a small fp32 input held against the plain head on the host
    scorer = MLPScorer(dataclasses.replace(det._scorer.config, dtype=torch.float32))
    model_dev = scorer.clone_model(det._model, torch.device(device))
    model_cpu = scorer.clone_model(det._model, torch.device("cpu"))
    tokens, _ = det._featurize_raw_batch(detect_msgs[:256])
    got = scorer.score(model_dev, torch.from_numpy(tokens).to(device)).cpu()
    want = scorer.score(model_cpu, torch.from_numpy(tokens))
    small_err = (got - want).abs().max().item()
    if got.shape != (256,) or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"fp32 scores on the card disagree with the host: {small_err}")

    result = dict(
        setup_s=setup_s, fit_s=fit_s, detect_s=detect_s, featurize_s=featurize_s,
        lines_per_s=N_DETECT / detect_s, n_detect=N_DETECT, call_size=CALL_SIZE,
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies),
        recall=recall, precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        launches=launches, launch_counts=counts, variants=variants,
        replayed_launches=graph, calibration_launches=calib_chunks,
        device_batches=det.path_counts["device"],
        einsum_alerts=len(ein_by_id), decision_flips=len(flips),
        flip_distances=near, small_fp32_max_abs_err=small_err,
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if device == "cuda" else None))
    emit("detector", **result)
    if recall < 0.9:
        raise AssertionError(f"recall on the injected anomalies is {recall}")
    return result


def frames_expected_launches(device_batches: int) -> dict:
    """What the wire-frame path launches: the fused head in every
    calibration chunk of the fit (N = 32) and in every device batch
    (N = 16,384: the warm-up batch and the timed frames, 32 frames of 512 a
    call); the lone messages score on the host copy, through no kernel."""
    calib = -(-SCORER_CONFIG["data_use_training"] // 32)
    return {"candidate_lse": calib + device_batches, "calibration_chunks": calib,
            "device_batches": device_batches}


def phase_frames(smi: str, device: str = "cuda") -> dict:
    """The native featurizer against the Python rows, then the MLP detector
    on bench_torch.py's wire-frame path (phase 7b). The featurizer was
    built by the first detector's ``setup_io`` (phase 7) unless it was
    already there; ``build_seconds`` says which."""
    matchkern.load()
    det = bench_torch.build_detector("cuda:0" if device == "cuda" else device, SCORER_CONFIG)
    seq_len, vocab = det.config.seq_len, det.config.vocab_size
    msgs, anomalies = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)

    # row parity on phase 7's stream, as a batch and packed into frames,
    # and the featurize pass timed both ways
    t0 = time.perf_counter()
    native, ok = matchkern.featurize_batch(msgs, seq_len, vocab)
    native_s = time.perf_counter() - t0
    python_det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        SCORER_CONFIG, native_featurize=False)}})
    t0 = time.perf_counter()
    python, python_ok = python_det._featurize_raw_batch(msgs)
    python_s = time.perf_counter() - t0
    frames = [pack_batch(msgs[i:i + bench_torch.FRAME_N])
              for i in range(0, N_DETECT, bench_torch.FRAME_N)]
    t0 = time.perf_counter()
    fb = matchkern.featurize_frames(frames, seq_len, vocab)
    frames_s = time.perf_counter() - t0
    # the engine's newline rule over the raw message bytes
    lines = sum(max(1, m.count(b"\n") + (0 if m.endswith(b"\n") else 1)) for m in msgs)
    batch_equal = bool(ok.all() and python_ok.all() and np.array_equal(native, python))
    frames_equal = bool(len(fb) == N_DETECT and fb.ok.all() and fb.n_corrupt_frames == 0
                        and fb.n_lines == lines and np.array_equal(fb.tokens, python))
    if not (batch_equal and frames_equal):
        raise AssertionError(f"native rows differ from the Python rows (batch equal "
                             f"{batch_equal}, frames equal {frames_equal})")

    # the main path: launch counts 0 just before, read just after
    det.setup_io()
    reset_launches()
    replays0 = replayed(det)
    run = bench_torch.drive(det, N_DETECT)
    counts = read_launches()
    launches = counts["candidate_lse"]
    graph = replay_delta(det, replays0)
    if device == "cuda":
        check_replays(graph, {"candidate_lse": launches}, "wire-frame")
    device_batches = det.path_counts["device"]
    if det.path_counts != {"device": 1 + N_DETECT // SCORER_CONFIG["max_batch"],
                           "host": bench_torch.N_SINGLE}:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    expected = frames_expected_launches(device_batches)
    if counts != {"candidate_lse": expected["candidate_lse"], "flash_forward": 0,
                  "flash_dq": 0, "flash_dkv": 0}:
        raise AssertionError(f"the wire-frame path launched {counts}, expected {expected}")
    variants = read_variants()["candidate_lse"]
    check_head_variants(variants, "wgmma_tma_d128_", launches, "wire-frame")
    if det.featurize_rows["fallback"] or det.featurize_rows["native"] == 0:
        raise AssertionError(f"rows featurized in Python: {det.featurize_rows}")
    threshold = det._threshold
    by_id = _alerts_by_id(run["alerts"], threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))
    result = dict(
        card=smi, native_build_s=matchkern.build_seconds,
        rows_bit_equal={"batch": batch_equal, "frames": frames_equal},
        featurize_s={"native_batch": native_s, "native_frames": frames_s,
                     "python": python_s},
        featurize_threads=matchkern.featurize_threads(),
        lines_per_s=run["lines_per_s"], detect_s=run["elapsed_s"], n_detect=N_DETECT,
        frames_per_call=det.config.max_batch // bench_torch.FRAME_N, p50_ms=run["p50_ms"], p50_paths=run["p50_paths"],
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        featurize_rows=det.featurize_rows, path_counts=det.path_counts,
        launches=launches, launch_counts=counts, expected_launches=expected,
        variants=variants, replayed_launches=graph)
    emit("frames", **result)
    if recall < 0.9:
        raise AssertionError(f"recall on the wire-frame path is {recall}")
    return result


def check_head_variants(variants: dict, prefix: str, launches: int, path: str) -> None:
    """Every fused-head launch of a path took a tensor-core variant at the
    path's D (``prefix``); fails otherwise."""
    if sum(variants.values()) != launches or \
            not all(name.startswith(prefix) for name in variants):
        raise AssertionError(f"the {path} path's {launches} fused-head launches took "
                             f"the variants {variants}, not all {prefix}*")


def logbert_expected_launches(device_batches: int) -> dict:
    """What the LogBERT path launches: the flash forward in every layer of
    every train step, calibration chunk and device batch; dQ and dK/dV in
    every layer of every train step; the fused head in every calibration
    chunk and device batch."""
    cfg = LOGBERT_CONFIG
    bs = 32  # train_batch_size
    steps_per_epoch = cfg["data_use_training"] // bs
    epochs = max(cfg["train_epochs"], -(-100 // steps_per_epoch))  # min_train_steps
    train_steps = epochs * steps_per_epoch
    calib = -(-cfg["data_use_training"] // bs)
    depth = cfg["depth"]
    return {"candidate_lse": calib + device_batches,
            "flash_forward": (train_steps + calib + device_batches) * depth,
            "flash_dq": train_steps * depth, "flash_dkv": train_steps * depth,
            "train_steps": train_steps, "calibration_chunks": calib}


def phase_logbert_detector() -> dict:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": LOGBERT_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    if det._host_model is not None or det._host_scorer is not None:
        raise AssertionError("a flash-configured logbert built a host copy")
    train_msgs, _ = make_messages(LOGBERT_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(LOGBERT_DETECT, anomaly_rate=0.01, seed=1)
    torch.cuda.reset_peak_memory_stats()

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    alerts, detect_s = _stream(det, detect_msgs, LOGBERT_CALL)
    counts = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    device_batches = det.path_counts["device"]
    if device_batches != LOGBERT_DETECT // LOGBERT_CALL or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    expected = logbert_expected_launches(device_batches)
    if expected["train_steps"] != 112:
        raise AssertionError(f"the fit takes {expected['train_steps']} steps, not 112")
    # scoring (calibration chunks and detect batches) replays graphs; the
    # train steps run eagerly
    graph = check_replays(replay_delta(det, replays0), {
        "candidate_lse": expected["candidate_lse"],
        "flash_forward": expected["flash_forward"]
        - expected["train_steps"] * LOGBERT_CONFIG["depth"]}, "LogBERT")
    for name in ("candidate_lse", "flash_forward", "flash_dq", "flash_dkv"):
        if counts[name] != expected[name]:
            raise AssertionError(f"{name} launched {counts[name]} times on the LogBERT "
                                 f"path, expected {expected[name]} ({expected})")
    # bf16 at head_dim 64: every flash launch took its wgmma variant, every
    # fused-head launch (D = 256) its tensor-core one
    variants = read_variants()
    want_variants = {name: {"wgmma_tma_d64": expected[name]}
                     for name in ("flash_forward", "flash_dq", "flash_dkv")}
    flash_variants = {name: variants[name] for name in want_variants}
    if flash_variants != want_variants:
        raise AssertionError(f"the LogBERT path took the flash variants "
                             f"{flash_variants}, expected {want_variants}")
    check_head_variants(variants["candidate_lse"], "wgmma_tma_d256_",
                        expected["candidate_lse"], "LogBERT")
    threshold = det._threshold
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")
    by_id = _alerts_by_id(alerts, threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))

    # the same stream through einsum attention and the einsum head on the
    # same fitted weights, in calls of 64
    plain = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        LOGBERT_CONFIG, attn_impl="einsum", head_impl="einsum", data_use_training=0,
        score_threshold=threshold)}})
    plain.load_params(det._model.state_dict())
    plain_alerts, plain_s = _stream(plain, detect_msgs, LOGBERT_PLAIN_CALL)
    if read_launches() != counts:
        raise AssertionError("the einsum paths launched a kernel")
    plain_by_id = _alerts_by_id(plain_alerts, threshold)
    flips, near = _flips(by_id, plain_by_id, plain, detect_msgs, threshold,
                         LOGBERT_PLAIN_CALL)

    # a small fp32 input: the kernels on the card against the plain versions
    # on the host, same weights
    cfg32 = dataclasses.replace(det._scorer.config, dtype=torch.float32)
    scorer = type(det._scorer)(cfg32)
    model_dev = scorer.clone_model(det._model, torch.device("cuda"))
    model_cpu = scorer.clone_model(det._model, torch.device("cpu"))
    tokens, _ = det._featurize_raw_batch(detect_msgs[:4])
    before = read_launches()
    got = scorer.score(model_dev, torch.from_numpy(tokens).cuda()).cpu()
    if read_launches()["flash_forward"] == before["flash_forward"]:
        raise AssertionError("the fp32 check did not run the flash kernel")
    want = scorer.score(model_cpu, torch.from_numpy(tokens))
    small_err = (got - want).abs().max().item()
    if got.shape != (4,) or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"fp32 LogBERT scores on the card disagree with the "
                             f"host: {got} vs {want}")

    result = dict(
        setup_s=setup_s, fit_s=fit_s, detect_s=detect_s, plain_detect_s=plain_s,
        lines_per_s=LOGBERT_DETECT / detect_s, n_detect=LOGBERT_DETECT,
        call_size=LOGBERT_CALL, threshold=threshold, alerts=len(by_id),
        anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        launch_counts=counts, expected_launches=expected, variants=variants,
        device_batches=device_batches, plain_alerts=len(plain_by_id),
        decision_flips=len(flips), flip_distances=near,
        small_fp32_max_abs_err=small_err, peak_mem_gib=peak_gib, replayed_launches=graph,
        replay_vs_eager=replay_vs_eager(det, "logbert", "fitted", [LOGBERT_CALL],
                                        detect_msgs))
    emit("logbert_detector", **result)
    # the LogBERT check of the lifecycle, before the detector is freed
    result["lifecycle"] = logbert_lifecycle(det, detect_msgs)
    return result


# -- phases 9 to 11 ----------------------------------------------------------
def gru_expected_launches(device_batches: int) -> dict:
    """What the GRU path launches: the fused head in every calibration chunk
    of the held-out split (N = 32 * seq_len rows) and every device batch;
    the train steps run the einsum logits, no kernel."""
    cfg = GRU_CONFIG
    bs = 32  # train_batch_size
    n_cal = max(16, cfg["data_use_training"] // 5)
    steps_per_epoch = (cfg["data_use_training"] - n_cal) // bs
    epochs = max(cfg["train_epochs"], -(-100 // steps_per_epoch))  # min_train_steps
    calib = -(-n_cal // bs)
    return {"candidate_lse": calib + device_batches, "train_steps": epochs * steps_per_epoch,
            "calibration_chunks": calib, "calibration_rows": bs * cfg["seq_len"],
            "detect_rows": GRU_CALL * cfg["seq_len"]}


def phase_gru_detector(device: str = "cuda") -> tuple:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": GRU_CONFIG}})
    t0 = time.perf_counter()
    det.setup_io()
    setup_s = time.perf_counter() - t0
    train_msgs, _ = make_messages(GRU_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(GRU_DETECT, anomaly_rate=0.01, seed=1)
    torch.cuda.reset_peak_memory_stats()

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit at the boundary
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_variants = Counter(scorehead.candidate_lse.variants)
    alerts, detect_s = _stream(det, detect_msgs, GRU_CALL)
    counts = read_launches()
    graph = replay_delta(det, replays0)
    if device == "cuda":
        check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "GRU")
    variants = read_variants()["candidate_lse"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    device_batches = det.path_counts["device"]
    if device_batches != GRU_DETECT // GRU_CALL or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    expected = gru_expected_launches(device_batches)
    if expected["train_steps"] != 108 or expected["calibration_chunks"] != 4:
        raise AssertionError(f"the GRU fit is not 108 steps and 4 calibration chunks: "
                             f"{expected}")
    if counts != {"candidate_lse": expected["candidate_lse"], "flash_forward": 0,
                  "flash_dq": 0, "flash_dkv": 0}:
        raise AssertionError(f"the GRU path launched {counts}, expected {expected}")
    detect_variants = Counter(variants) - fit_variants
    check_head_variants(fit_variants, "wgmma_tma_d128_", expected["calibration_chunks"],
                        "GRU calibration")
    check_head_variants(detect_variants, "wgmma_tma_d128_", device_batches, "GRU detect")
    threshold = det._threshold
    if not np.isfinite(threshold):
        raise AssertionError(f"threshold {threshold} is not finite")
    by_id = _alerts_by_id(alerts, threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))

    # the same stream through the einsum head on the same fitted weights and
    # position-norm statistics
    ein = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        GRU_CONFIG, head_impl="einsum", data_use_training=0, score_threshold=threshold)}})
    ein.load_params(det._model.state_dict())
    ein._set_norm(det._norm_mu, det._norm_sigma)
    ein_alerts, ein_s = _stream(ein, detect_msgs, GRU_CALL)
    if read_launches() != counts:
        raise AssertionError("the einsum head launched a kernel")
    ein_by_id = _alerts_by_id(ein_alerts, threshold)
    flips, near = _flips(by_id, ein_by_id, ein, detect_msgs, threshold, GRU_CALL)

    # the graph captured at setup_io reads the norm buffers the fit's
    # calibration copied into: held against the eager call
    checks = replay_vs_eager(det, "gru", "norm_calibrated", [GRU_CALL], detect_msgs)
    # device time of one detect batch of real tokens (the graph's replay),
    # and of the recurrence with its embeddings and LayerNorm alone, op by
    # op (CUDA events; the host's launch gaps inside the pair count)
    tokens, _ = det._featurize_raw_batch(detect_msgs[:GRU_CALL])
    batch_ms = time_ms(lambda: det._score_dev(tokens), reps=10)
    wide = torch.from_numpy(tokens).to(device).long()
    with torch.no_grad():
        hidden_ms = time_ms(lambda: det._model.hidden(wide), reps=10)

    # a small fp32 input: the fused head's CUDA-core kernel and the GRU on
    # the card against the plain versions on the host, same weights
    scorer = type(det._scorer)(dataclasses.replace(det._scorer.config, dtype=torch.float32))
    model_dev = scorer.clone_model(det._model, torch.device(device))
    model_cpu = scorer.clone_model(det._model, torch.device("cpu"))
    tokens, _ = det._featurize_raw_batch(detect_msgs[:64])
    got = scorer.score(model_dev, torch.from_numpy(tokens).to(device)).cpu()
    want = scorer.score(model_cpu, torch.from_numpy(tokens))
    small_err = (got - want).abs().max().item()
    if got.shape != (64,) or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"fp32 GRU scores on the card disagree with the host: {small_err}")

    result = dict(
        setup_s=setup_s, fit_s=fit_s, detect_s=detect_s, einsum_detect_s=ein_s,
        lines_per_s=GRU_DETECT / detect_s, n_detect=GRU_DETECT, call_size=GRU_CALL,
        batch_ms=batch_ms, hidden_ms=hidden_ms,
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        launch_counts=counts, expected_launches=expected,
        variants=variants, calibration_variants=dict(fit_variants),
        detect_variants=dict(detect_variants),
        device_batches=device_batches, einsum_alerts=len(ein_by_id),
        decision_flips=len(flips), flip_distances=near, small_fp32_max_abs_err=small_err,
        peak_mem_gib=peak_gib, replayed_launches=graph, replay_vs_eager=checks)
    emit("gru_detector", **result)
    return result, det


def int8_expected_launches(device_batches: int) -> dict:
    """What the int8w MLP path launches: the fused head (N = 32) in every
    calibration chunk, twice over the parity corpus (float path, then int8
    path), and in every device batch (N = 4096)."""
    bs = 32
    calib = -(-INT8_CONFIG["data_use_training"] // bs)
    parity = 2 * -(-min(512, INT8_CONFIG["data_use_training"]) // bs)
    return {"candidate_lse": calib + parity + device_batches, "calibration_chunks": calib,
            "parity_chunks": parity, "device_batches": device_batches}


def phase_int8_detector(bf16_lines_per_s: float) -> tuple:
    det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": INT8_CONFIG}})
    det.setup_io()
    train_msgs, _ = make_messages(INT8_CONFIG["data_use_training"], anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)

    # the main path: launch counts 0 just before, read just after
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    assert det.process_batch(train_msgs) == []   # sync fit, then the gate
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_variants = Counter(scorehead.candidate_lse.variants)
    alerts, detect_s = _stream(det, detect_msgs, CALL_SIZE)
    counts = read_launches()
    # the float and the int8 side of the gate, like every batch, replayed
    graph = check_replays(replay_delta(det, replays0),
                          {"candidate_lse": counts["candidate_lse"]}, "int8w")
    variants = read_variants()["candidate_lse"]

    report = det._int8_report
    emit("int8_gate", **report)
    if not (report["activated"] and report["gated"] and report["flips"] == 0
            and report["rows"] == 512):
        raise AssertionError(f"the int8 gate did not install at zero flips: {report}")
    if det._scorer.config.dtype != torch.bfloat16 or det._qstate is None:
        raise AssertionError("the int8w detector is not serving its bf16 int8 path")
    device_batches = det.path_counts["device"]
    if device_batches != N_DETECT // CALL_SIZE or det.path_counts["host"]:
        raise AssertionError(f"unexpected dispatch paths {det.path_counts}")
    expected = int8_expected_launches(device_batches)
    if counts["candidate_lse"] != expected["candidate_lse"] or \
            counts["flash_forward"] or counts["flash_dq"] or counts["flash_dkv"]:
        raise AssertionError(f"the int8w path launched {counts}, expected {expected}")
    check_head_variants(fit_variants, "wgmma_tma_d128_",
                        expected["calibration_chunks"] + expected["parity_chunks"],
                        "int8w calibration and parity")
    check_head_variants(Counter(variants) - fit_variants, "wgmma_tma_d128_", device_batches,
                        "int8w detect")
    threshold = det._threshold
    by_id = _alerts_by_id(alerts, threshold)
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))

    # the same stream through the bf16 detector on the same fitted weights
    bf16 = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        SCORER_CONFIG, data_use_training=0, score_threshold=threshold)}})
    bf16.load_params(det._model.state_dict())
    bf16_alerts, _ = _stream(bf16, detect_msgs, CALL_SIZE)
    bf16_by_id = _alerts_by_id(bf16_alerts, threshold)
    flips, near = _flips(by_id, bf16_by_id, bf16, detect_msgs, threshold, CALL_SIZE)

    # device time of one detect batch op by op through the int8 path
    # (dequantized in the call) and through the float weights, in turns
    # (int8, float, float, int8), and of the int8 graph's replay
    checks = replay_vs_eager(det, "int8w_mlp", "int8_activate",
                             [32, CALL_SIZE, INT8_CONFIG["max_batch"]], detect_msgs)
    tokens, _ = det._featurize_raw_batch(detect_msgs[:CALL_SIZE])
    qstate = det._qstate
    batch_ms = {"int8": [], "float": []}
    for path in ("int8", "float", "float", "int8"):
        det._qstate = qstate if path == "int8" else None
        batch_ms[path].append(time_ms(lambda: det._score_eager(tokens), reps=10))
    det._qstate = qstate
    batch_ms["int8_replay"] = time_ms(lambda: det._score_dev(tokens), reps=10)
    resident = int8_resident_bytes(det)

    result = dict(
        fit_s=fit_s, detect_s=detect_s, lines_per_s=N_DETECT / detect_s,
        bf16_lines_per_s=bf16_lines_per_s, n_detect=N_DETECT, call_size=CALL_SIZE,
        batch_ms=batch_ms, threshold=threshold, alerts=len(by_id), anomalies=len(anomalies), recall=recall,
        gate=report, quant_bytes=report["bytes"], resident=resident,
        launches=counts["candidate_lse"],
        expected_launches=expected, variants=variants,
        bf16_alerts=len(bf16_by_id), decision_flips=len(flips), flip_distances=near,
        replayed_launches=graph, replay_vs_eager=checks)
    emit("int8_detector", **result)
    if recall < 0.9:
        raise AssertionError(f"int8w recall on the injected anomalies is {recall}")
    return result, det


def int8_resident_bytes(det) -> dict:
    """The device bytes the int8 path keeps: ``memory_allocated`` before
    and after quantizing the detector's weights as an install does (the
    state alone; an install also re-captures the warm set's graphs), beside
    the same delta for the serving copy earlier versions built (an fp32
    clone of the model holding the dequantized weights), and the int8
    state's own tensor bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    qstate = quant.quantize(det._model.state_dict(), quant.linear_weight_keys(det._model))
    torch.cuda.synchronize()
    install = torch.cuda.memory_allocated() - base
    state = sum(t.numel() * t.element_size() for leaf in qstate.values() for t in leaf)
    del qstate
    base = torch.cuda.memory_allocated()
    copy = det._scorer.clone_model(det._model, det._device)
    copy.load_state_dict(quant.dequantize(det._qstate, det._scorer.config.dtype))
    torch.cuda.synchronize()
    copy_bytes = torch.cuda.memory_allocated() - base
    del copy
    return {"install_allocated_delta": install, "int8_state_tensor_bytes": state,
            "float_copy_allocated_delta": copy_bytes}


def phase_checkpoints(detectors: dict) -> dict:
    """Each fitted detector saved, then restored into a fresh detector of
    its configuration: one batch of 4096 must score bit-equal, the
    threshold must be equal, and an int8w restore re-activates ungated."""
    configs = {"gru": GRU_CONFIG, "int8w_mlp": INT8_CONFIG}
    msgs, _ = make_messages(4096, anomaly_rate=0.01, seed=2)
    results = {}
    with tempfile.TemporaryDirectory(prefix="dm_ckpt_") as tmp:
        for label, det in detectors.items():
            path = str(Path(tmp) / label)
            t0 = time.perf_counter()
            det.save_checkpoint(path)
            save_s = time.perf_counter() - t0
            fresh = TorchScorerDetector(config={"detectors": {
                "TorchScorerDetector": configs[label]}})
            t0 = time.perf_counter()
            fresh.load_checkpoint(path)
            load_s = time.perf_counter() - t0
            tokens, ok = det._featurize_raw_batch(msgs)
            assert ok.all()
            want, got = det.score_tokens(tokens), fresh.score_tokens(tokens)
            row = dict(save_s=save_s, load_s=load_s,
                       bytes=sum(f.stat().st_size for f in Path(path).iterdir()),
                       bit_equal=bool(np.array_equal(got, want)),
                       max_abs_diff=float(np.abs(got - want).max()),
                       threshold=fresh._threshold,
                       threshold_equal=fresh._threshold == det._threshold,
                       int8=fresh._int8_report)
            emit("checkpoint", label=label, **row)
            if not (row["bit_equal"] and row["threshold_equal"] and fresh._fitted):
                raise AssertionError(f"the {label} checkpoint did not restore: {row}")
            if label == "int8w_mlp" and not (fresh._int8_report["activated"]
                                             and fresh._int8_report["gated"] is False):
                raise AssertionError(f"the int8w restore reported {fresh._int8_report}")
            row["replay_vs_eager"] = replay_vs_eager(fresh, label, "restore", [4096], msgs)
            results[label] = row
    return results


# -- phase 12 ----------------------------------------------------------------
def _http(method: str, port: int, path: str, timeout: float = 30.0, payload=None):
    body = json.dumps(payload or {}).encode() if method == "POST" else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
        return resp.status, (json.loads(body) if "json" in resp.headers["Content-Type"]
                             else body)


def _http_any(method: str, port: int, path: str, timeout: float = 30.0, payload=None):
    """``_http``, with an error status returned instead of raised."""
    try:
        return _http(method, port, path, timeout, payload)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def metric_value(text: str, name: str, component_id: str) -> float:
    """One sample of the Prometheus exposition ``text``: series ``name``
    with ``component_id``."""
    for line in text.splitlines():
        if line.startswith(name + "{") and f'component_id="{component_id}"' in line:
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} of {component_id} not in /metrics")


def _wait(predicate, timeout: float, what: str, interval: float = 0.02) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(interval)


class _Collector(threading.Thread):
    """Receives alert frames with their arrival times until stopped."""

    def __init__(self, sink):
        super().__init__(name="AlertCollector", daemon=True)
        self.sink, self.frames, self.times = sink, [], []
        self.stop_flag = threading.Event()

    def run(self) -> None:
        self.sink.recv_timeout = 50
        while not self.stop_flag.is_set():
            try:
                frame = self.sink.recv()
            except TransportTimeout:
                continue
            self.frames.append(frame)
            self.times.append(time.perf_counter())


def _messages_of(frames) -> list:
    return [m for f in frames for m in (unpack_batch(f) or [f])]


def service_files(tmp: Path, name: str, config: dict, **settings) -> Path:
    """The component config and the settings YAML of one service under
    ``tmp`` (ipc sockets there); returns the settings file."""
    import yaml

    (tmp / f"{name}_config.yaml").write_text(yaml.safe_dump(
        {"detectors": {"TorchScorerDetector": config}}))
    doc = {"component_type": TORCH_SCORER, "component_id": name,
           "config_file": str(tmp / f"{name}_config.yaml"),
           "engine_addr": f"ipc://{tmp}/{name}_in.ipc",
           "out_addr": [f"ipc://{tmp}/{name}_out.ipc"], "http_port": 0,
           "log_to_file": False, "log_level": "WARNING", "engine_batch_size": 16384,
           "engine_buffer_size": 4096, **settings}
    path = tmp / f"{name}_settings.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def _outputs_connected(engine) -> bool:
    """Whether every output socket of ``engine`` has a connected peer: with
    ``IMMEDIATE`` set, a socket is writable only then."""
    return all(_writable(sock) for sock in engine._out_socks)


def _writable(sock) -> bool:
    """Whether a dialing socket has a live connection (``IMMEDIATE``: it is
    writable only then)."""
    import zmq

    return bool(sock._sock.getsockopt(zmq.EVENTS) & zmq.POLLOUT)


def _lone_latencies(sender, sink, msgs) -> list:
    """Send each message alone and wait for its alert: seconds each."""
    sink.recv_timeout = 10000
    out = []
    for msg in msgs:
        log_id = ParserSchema.from_bytes(msg)["logID"]
        t0 = time.perf_counter()
        sender.send(msg)
        alert = DetectorSchema.from_bytes(sink.recv())
        out.append(time.perf_counter() - t0)
        if alert["logIDs"] != [log_id]:
            raise AssertionError(f"lone message {log_id} got the alert {alert['logIDs']}")
    return out


def phase_service(smi: str, frames_lines_per_s: float, device: str = "cuda") -> dict:
    """The port's Service on the card: stream, decisions against the hosted
    detector's own, latency, admin plane, restore, and the CLI."""
    config = dict(SCORER_CONFIG) if device == "cuda" else dict(SCORER_CONFIG, device=device)
    n_fit = config["data_use_training"]
    fit_msgs, _ = make_messages(n_fit, anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(SERVICE_DETECT, anomaly_rate=0.01, seed=1)
    lone = _lone_anomalies(SERVICE_LONE + 1, "lone")
    tmp = Path(tempfile.mkdtemp(prefix="dmsvc", dir="/tmp"))
    try:
        settings = ServiceSettings.from_yaml(str(service_files(
            tmp, "svc", config, checkpoint_dir=str(tmp / "ckpt"))))
        factory = ZmqPairSocketFactory()
        sink = factory.create(settings.out_addr[0])
        service = Service(settings)
        t0 = time.perf_counter()
        service.setup_io()
        setup_s = time.perf_counter() - t0
        det = service.library_component
        runner = threading.Thread(target=service.run, name="ServiceRun", daemon=True)
        runner.start()
        _wait(lambda: service.engine.running and service.web_server.port, 30, "the service")
        port = service.web_server.port
        sender = factory.create_output(settings.engine_addr, buffer_size=1000)
        collector = _Collector(sink)
        collector.start()

        # the main path: launch counts 0 just before, read just after
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        for i in range(0, n_fit, SERVICE_FRAME):
            sender.send(pack_batch(fit_msgs[i:i + SERVICE_FRAME]))
        _wait(lambda: det._fitted, 300, "the fit at the boundary")
        fit_s = time.perf_counter() - t0
        frames = [pack_batch(detect_msgs[i:i + SERVICE_FRAME])
                  for i in range(0, SERVICE_DETECT, SERVICE_FRAME)]
        lines_sent = sum(map(count_lines, fit_msgs + detect_msgs))
        t_first = time.perf_counter()
        for frame in frames:
            sender.send(frame)

        def settled():
            text = _http("GET", port, "/metrics")[1]
            return (metric_value(text, "data_read_lines_total", "svc") == lines_sent
                    and det.pending_count() == 0
                    and (not collector.times or time.perf_counter() - collector.times[-1] > 1.0))

        _wait(settled, 120, "the stream to go quiet", interval=0.1)
        collector.stop_flag.set()
        collector.join(5)
        t_last = collector.times[-1] if collector.times else float("nan")
        text = _http("GET", port, "/metrics")[1]
        read_lines = metric_value(text, "data_read_lines_total", "svc")
        written_lines = metric_value(text, "data_written_lines_total", "svc")
        alerts = _messages_of(collector.frames)
        ids = [DetectorSchema.from_bytes(a)["logIDs"][0] for a in alerts]
        by_id = _alerts_by_id(alerts, det._threshold)
        received_lines = sum(map(count_lines, collector.frames))

        latencies = _lone_latencies(sender, sink, lone[:SERVICE_LONE])
        counts = read_launches()
        variants = read_variants()["candidate_lse"]
        graph = replay_delta(det, replays0)

        # the hosted detector's own decisions on the same stream, scored on
        # the engine's loop thread (launches made to compare do not count)
        threshold = det._threshold
        tokens, ok = det._featurize_raw_batch(detect_msgs)
        scores = service.engine.call_in_loop(lambda: det.score_tokens(tokens))
        want = {str(i) for i in np.flatnonzero(ok & (scores > threshold))}
        flips = sorted(want ^ set(by_id), key=int)
        near = [float(abs(scores[int(i)] - threshold)) for i in flips]

        # the admin plane. Liveness: a check latched UNHEALTHY while the
        # warm set was captured recovers after the watchdog's recovery
        # intervals (2 of 2 s), which a short stream may not have lasted
        _wait(lambda: _http_any("GET", port, "/admin/health")[0] == 200, 30,
              "liveness after warm-up", interval=0.2)
        health_code = _http("GET", port, "/admin/health")[0]
        _http("POST", port, "/admin/stop")
        stopped = not service.engine.running
        _http("POST", port, "/admin/start")
        _wait(lambda: service.engine.running, 10, "the engine to start again")
        # the restarted engine dials its output in the background, and an
        # alert sent before the dial completes is dropped (drop mode)
        _wait(lambda: _outputs_connected(service.engine), 10, "the output to reconnect")
        # the stopped engine's input socket is gone: a message the old
        # connection takes before it notices is lost with it, so the
        # restarted engine is reached through a connection of its own
        sender.close()
        sender = factory.create_output(settings.engine_addr, buffer_size=1000)
        _wait(lambda: _writable(sender), 10, "a connection to the restarted engine")
        restarted = _lone_latencies(sender, sink, lone[SERVICE_LONE:])[0]
        t0 = time.perf_counter()
        _http("POST", port, "/admin/shutdown")
        runner.join(30)
        shutdown_s = time.perf_counter() - t0
        checkpointed = (tmp / "ckpt" / "meta.json").exists()
        sender.close()
        sink.close()

        # a fresh Service on the same settings restores the checkpoint
        with Service(settings) as fresh:
            restored = fresh.library_component
            batch, _ = det._featurize_raw_batch(detect_msgs[:4096])
            restore = dict(threshold_equal=restored._threshold == threshold,
                           bit_equal=bool(np.array_equal(restored.score_tokens(batch),
                                                         det.score_tokens(batch))))

        cli = phase_service_cli(tmp, config, fit_msgs, detect_msgs[:SERVICE_CLI_DETECT])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))
    result = dict(
        card=smi, setup_s=setup_s, fit_s=fit_s, n_detect=SERVICE_DETECT,
        socket_lines_per_s=SERVICE_DETECT / (t_last - t_first),
        in_process_lines_per_s=frames_lines_per_s,
        lone_p50_ms=float(np.percentile(latencies, 50) * 1e3),
        lone_p99_ms=float(np.percentile(latencies, 99) * 1e3),
        lines_sent=lines_sent, read_lines=read_lines, written_lines=written_lines,
        received_alert_lines=received_lines, alerts=len(ids), unique_alerts=len(set(ids)),
        anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)),
        threshold=threshold, decision_flips=len(flips), flip_distances=near,
        launches=counts["candidate_lse"], launch_counts=counts, variants=variants,
        replayed_launches=graph,
        health=health_code, stop_start={"stopped": stopped, "alert_ms": restarted * 1e3},
        shutdown_s=shutdown_s, checkpointed=checkpointed, restore=restore, cli=cli)
    emit("service", **result)
    failures = []
    if read_lines != lines_sent:
        failures.append(f"read {read_lines} lines of {lines_sent} sent")
    if written_lines != received_lines:
        failures.append(f"wrote {written_lines} alert lines, received {received_lines}")
    if len(set(ids)) != len(ids):
        failures.append("an alert was received twice")
    if recall < 0.9:
        failures.append(f"recall {recall}")
    if near and max(near) >= 1e-2:
        failures.append(f"decisions differ from the detector's beyond 1e-2: {near}")
    if counts["candidate_lse"] < 1 or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"], "service")
            check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "service")
        except AssertionError as exc:
            failures.append(str(exc))
    if health_code != 200 or not stopped or runner.is_alive() or shutdown_s > 30:
        failures.append("the admin plane")
    if not (checkpointed and restore["threshold_equal"] and restore["bit_equal"]):
        failures.append(f"the shutdown checkpoint and its restore: {restore}")
    if cli["returncode"] != 0 or cli["alerts"] < 1:
        failures.append(f"the CLI subprocess: {cli}")
    if failures:
        raise AssertionError(f"the service phase failed: {failures}")
    return result


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_service_cli(tmp: Path, config: dict, fit_msgs, detect_msgs) -> dict:
    """``python -m detectmateservice_tpu_torch.cli`` as a subprocess on the
    same configuration: fit, the detect messages, alerts, shutdown, exit."""
    port = _free_port()
    settings = service_files(tmp, "cli", config, http_port=port)
    factory = ZmqPairSocketFactory()
    sink = factory.create(f"ipc://{tmp}/cli_out.ipc")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    with open(tmp / "cli.out", "wb") as out, open(tmp / "cli.err", "wb") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "detectmateservice_tpu_torch.cli",
                                 "--settings", str(settings)], stdout=out, stderr=err, env=env)
        sender = factory.create_output(f"ipc://{tmp}/cli_in.ipc", buffer_size=1000)
        try:
            def running():
                if proc.poll() is not None:
                    raise AssertionError((tmp / "cli.err").read_text()[-2000:])
                try:
                    return _http("GET", port, "/admin/status", 2)[1]["status"]["running"]
                except OSError:
                    return False

            _wait(running, 300, "the CLI service", interval=0.2)
            start_s = time.perf_counter() - t0
            for msgs in (fit_msgs, detect_msgs):
                for i in range(0, len(msgs), SERVICE_FRAME):
                    sender.send(pack_batch(msgs[i:i + SERVICE_FRAME]))
            alerts, sink.recv_timeout = [], 120000
            while True:
                try:
                    alerts.extend(_messages_of([sink.recv()]))
                except TransportTimeout:
                    break
                sink.recv_timeout = 3000
            t0 = time.perf_counter()
            _http("POST", port, "/admin/shutdown")
            rc = proc.wait(timeout=60)
            exit_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            sender.close()
            sink.close()
    return {"returncode": rc, "start_s": start_s, "alerts": len(alerts), "exit_s": exit_s,
            "stderr_tail": (tmp / "cli.err").read_text()[-500:]}


# -- phase 13 ----------------------------------------------------------------
def coalesce_files(tmp: Path, device: str = "cuda", settings_changes=None,
                   **config_changes) -> Path:
    """``examples/scorer_settings.yaml`` and ``examples/scorer_config.yaml``
    written under ``tmp`` with only these changes: ``head_impl: pallas``;
    the addresses (sockets, logs, the config file) under ``tmp``; a free
    HTTP port; the port's component type (the settings' ``component_type``
    and the config block's name and ``method_type``); and, off the card,
    ``device`` and ``COALESCE_CPU_CHANGES`` (plus ``config_changes``, for (b)
    and (c), and ``settings_changes``, for the lifecycle phase). Returns the
    settings file."""
    import yaml

    examples = Path(__file__).resolve().parent / "examples"
    settings = yaml.safe_load((examples / "scorer_settings.yaml").read_text())
    config = yaml.safe_load((examples / "scorer_config.yaml").read_text())
    block = dict(config["detectors"]["JaxScorerDetector"], method_type="torch_scorer",
                 head_impl="pallas", **config_changes)
    if device != "cuda":
        block.update(COALESCE_CPU_CHANGES, device=device)
    (tmp / "scorer_config.yaml").write_text(yaml.safe_dump(
        {"detectors": {"TorchScorerDetector": block}}))
    settings.update(component_type=TORCH_SCORER, engine_addr=f"ipc://{tmp}/detector.ipc",
                    out_addr=[f"ipc://{tmp}/output.ipc"], http_port=_free_port(),
                    log_dir=str(tmp / "logs"), config_file=str(tmp / "scorer_config.yaml"),
                    **(settings_changes or {}))
    path = tmp / "scorer_settings.yaml"
    path.write_text(yaml.safe_dump(settings))
    return path


def coalesce_detector(tmp: Path, device: str = "cuda", **config_changes):
    """A detector of the example's configuration (``coalesce_files``), in
    process, after ``setup_io``."""
    import yaml

    coalesce_files(tmp, device, **config_changes)
    config = yaml.safe_load((tmp / "scorer_config.yaml").read_text())
    det = TorchScorerDetector(config=config)
    det.setup_io()
    return det


def metric_samples(text: str, name: str, component_id: str) -> dict:
    """Every sample of ``name`` with ``component_id`` in a Prometheus
    exposition, by its label text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") and f'component_id="{component_id}"' in line:
            labels, value = line.rsplit(" ", 1)
            out[labels[len(name):]] = float(value)
    return out


def _lone_anomalies(n: int, tag: str) -> list:
    return [ParserSchema(EventID=1, template="segfault at <*> ip <*> sp <*>",
                         variables=[hex(0xdead0000 + i), hex(0xbeef), hex(i)],
                         logID=f"{tag}-{i}", logFormatVariables={"Time": "1700000000"},
                         ).serialize() for i in range(n)]


def send_stream(addr: str, n_fit: int, n_detect: int) -> None:
    """The upstream stage of (a), run in a process of its own (the
    parser's place in a pipeline): on each line of standard input it sends
    the next batch of single messages to ``addr``, the fit messages and
    then the detect stream, and prints when the detect stream began and
    ended (``time.perf_counter``, the host's monotonic clock). A third line
    closes the socket."""
    fit_msgs, _ = make_messages(n_fit, anomaly_rate=0.0)
    detect_msgs, _ = make_messages(n_detect, anomaly_rate=0.01, seed=1)
    sender = ZmqPairSocketFactory().create_output(addr, buffer_size=1000)
    print("ready", flush=True)
    sys.stdin.readline()
    for msg in fit_msgs:
        sender.send(msg)
    print("fit", flush=True)
    sys.stdin.readline()
    t0 = time.perf_counter()
    for msg in detect_msgs:
        sender.send(msg)
    print(json.dumps({"t_first": t0, "t_sent": time.perf_counter()}), flush=True)
    sys.stdin.readline()
    sender.close()


def phase_coalesce(smi: str, device: str = "cuda") -> dict:
    """The scorer example's adaptive batching on the card: (a) hosted by the
    port's Service, (b) bucket retirement, (c) upload workers, and the
    example's buckets replayed against the eager call."""
    tmp = Path(tempfile.mkdtemp(prefix="dmco", dir="/tmp"))
    try:
        served = coalesce_service(tmp / "a", smi, device)
        retire = coalesce_retirement(tmp / "b", served["checkpoint"], device)
        workers = coalesce_workers(tmp / "c", served["checkpoint"], device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(served, retire=retire, workers=workers)
    result.pop("checkpoint")
    return result


def coalesce_service(tmp: Path, smi: str, device: str) -> dict:
    """(a): the example hosted by the port's Service in this process."""
    tmp.mkdir(parents=True)
    settings = ServiceSettings.from_yaml(str(coalesce_files(tmp, device)))
    cid = settings.component_id
    fit_msgs, _ = make_messages(512, anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(COALESCE_DETECT, anomaly_rate=0.01, seed=1)
    lone = _lone_anomalies(COALESCE_LONE, "lone")
    factory = ZmqPairSocketFactory()
    sink = factory.create(settings.out_addr[0])
    service = Service(settings)
    t0 = time.perf_counter()
    service.setup_io()
    setup_s = time.perf_counter() - t0
    det = service.library_component
    if det.config.data_use_training != len(fit_msgs):
        raise AssertionError(f"the example fits on {det.config.data_use_training} messages")
    runner = threading.Thread(target=service.run, name="ServiceRun", daemon=True)
    runner.start()
    _wait(lambda: service.engine.running and service.web_server.port, 30, "the service")
    port = service.web_server.port
    # deep health: a check latched UNHEALTHY while the warm set was being
    # captured recovers after two clean evaluations
    deep_first = _http_any("GET", port, "/admin/health?deep=1")[0]
    _wait(lambda: _http_any("GET", port, "/admin/health?deep=1")[0] == 200, 30,
          "deep health after warm-up", interval=0.2)
    deep_code, deep = _http_any("GET", port, "/admin/health?deep=1")
    # the series are process-wide: this run's counts are the deltas
    releases0, unexpected0 = _coalesce_counters(_http("GET", port, "/metrics")[1], det, cid)
    collector = _Collector(sink)
    collector.start()
    # the stream comes from another process, as from an upstream stage: a
    # sender in this interpreter would take the lock the engine loop needs
    upstream = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.send_stream("
         f"{settings.engine_addr!r}, {len(fit_msgs)}, {COALESCE_DETECT})"],
        cwd=Path(__file__).resolve().parent, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    try:
        if upstream.stdout.readline().strip() != "ready":
            raise AssertionError("the sender process did not start")

        # the main path: launch counts 0 just before, read just after
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        upstream.stdin.write("fit\n")
        upstream.stdin.flush()
        upstream.stdout.readline()
        _wait(lambda: det._fitted and det._fit_thread is None and det.pending_count() == 0,
              300, "the fit at the boundary")
        fit_s = time.perf_counter() - t0
        lines_sent = sum(map(count_lines, fit_msgs + detect_msgs))
        upstream.stdin.write("detect\n")
        upstream.stdin.flush()
        sent = json.loads(upstream.stdout.readline())
        t_first = sent["t_first"]
        _coalesce_settle(det, service.engine, collector)
        upstream.stdin.write("close\n")
        upstream.stdin.flush()
        upstream.wait(30)
    finally:
        if upstream.poll() is None:
            upstream.kill()
            upstream.wait(10)
    sender = factory.create_output(settings.engine_addr, buffer_size=1000)

    t_last = collector.times[-1] if collector.times else float("nan")
    stats = det.batching_stats()
    latencies = _lone_latencies(sender, sink, lone)
    counts = read_launches()
    variants = read_variants()["candidate_lse"]
    graph = replay_delta(det, replays0)
    stats_after = det.batching_stats()

    lines_sent += sum(map(count_lines, lone))
    text = _http("GET", port, "/metrics")[1]
    read_lines = metric_value(text, "data_read_lines_total", cid)
    releases1, unexpected1 = _coalesce_counters(text, det, cid)
    releases_metric = {reason: n - releases0.get(reason, 0.0)
                       for reason, n in releases1.items() if n > releases0.get(reason, 0.0)}
    unexpected_metric = unexpected1 - unexpected0
    xla = _http("GET", port, "/admin/xla")[1]
    # the ring's longest holds (queue wait: the oldest row's arrival to the
    # scoring call, a capture on first use included)
    slowest = sorted((s for s in xla["batches"] if s["release"]),
                     key=lambda s: s["queue_wait_s"])[-5:]
    alerts = _messages_of(collector.frames)
    ids = [DetectorSchema.from_bytes(a)["logIDs"][0] for a in alerts]
    threshold = det._threshold
    by_id = _alerts_by_id(alerts, threshold)
    _http("POST", port, "/admin/shutdown")
    runner.join(30)
    sender.close()
    sink.close()

    # the plain path: the einsum head on the same weights and statistics
    plain = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": dict(
        det.config.to_dict(), head_impl="einsum", data_use_training=0,
        score_threshold=threshold, batch_deadline_ms=0.0)}})
    plain.load_params(det._model.state_dict())
    plain._set_norm(det._norm_mu, det._norm_sigma)
    tokens, ok = det._featurize_raw_batch(detect_msgs)
    scores = plain.score_tokens(tokens)
    want = {str(i) for i in np.flatnonzero(ok & (scores > threshold))}
    flips = sorted(want ^ set(by_id), key=int)
    near = [float(abs(scores[int(i)] - threshold)) for i in flips]
    checks = replay_vs_eager(det, "coalesce_mlp", "norm_calibrated",
                             [det.config.max_batch, det.config.train_batch_size],
                             detect_msgs) if device == "cuda" else []
    checkpoint = tmp / "ckpt"
    det.save_checkpoint(str(checkpoint))

    tick_ms = det.drain_poll_ms
    wait_bound_s = (det.config.batch_deadline_ms + tick_ms + 2.0) / 1e3
    recall = len(anomalies & set(by_id)) / max(1, len(anomalies))
    result = dict(
        card=smi, setup_s=setup_s, fit_s=fit_s, n_detect=COALESCE_DETECT,
        socket_lines_per_s=COALESCE_DETECT / (t_last - t_first),
        sender_lines_per_s=COALESCE_DETECT / (sent["t_sent"] - t_first),
        lone_p50_ms=float(np.percentile(latencies, 50) * 1e3),
        lone_p99_ms=float(np.percentile(latencies, 99) * 1e3),
        releases=stats["releases"], occupancy_mean=stats["occupancy_mean"],
        max_release_wait_ms=stats["max_wait_s"] * 1e3,
        mean_release_wait_ms=stats["mean_wait_s"] * 1e3,
        release_wait_bound_ms=wait_bound_s * 1e3, drain_poll_ms=tick_ms,
        dispatches=stats["dispatches"], path_counts=dict(det.path_counts),
        releases_with_lone=stats_after["releases"], releases_metric=releases_metric,
        lines_sent=lines_sent, read_lines=read_lines, alerts=len(ids),
        unique_alerts=len(set(ids)), anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(by_id)) / max(1, len(by_id)), threshold=threshold,
        decision_flips=len(flips), flip_distances=near,
        launches=counts["candidate_lse"], launch_counts=counts, variants=variants,
        replayed_launches=graph, deep_health={"first": deep_first, "after": deep_code},
        warmup_check=[c for c in deep.get("checks", []) if c["name"] == "scorer_warmup_pending"],
        xla={"warmup_complete": xla["warmup_complete"], "totals": xla["totals"],
             "buckets": xla.get("buckets"), "warmup_phases": xla["warmup_phases"],
             "keys": sorted(xla)},
        slowest_spans=slowest, unexpected_metric=unexpected_metric,
        warm_set=det.warm_set_spec(),
        replay_vs_eager=checks, checkpoint=str(checkpoint))
    emit("coalesce", **result)
    failures = []
    # off the card the batches score synchronously in the engine loop, which
    # the bound does not allow for: it is held on the card
    if device == "cuda" and stats["max_wait_s"] > wait_bound_s:
        failures.append(f"a release waited {stats['max_wait_s'] * 1e3:.3f} ms, over "
                        f"{wait_bound_s * 1e3} ms")
    if read_lines != lines_sent:
        failures.append(f"read {read_lines} lines of {lines_sent} sent")
    if len(set(ids)) != len(ids):
        failures.append("an alert was received twice")
    if recall < 0.9:
        failures.append(f"recall {recall}")
    if near and max(near) >= 1e-2:
        failures.append(f"decisions apart from the plain path beyond 1e-2: {near}")
    warm = (xla.get("buckets") or {}).get("warm") or []
    if not (xla["warmup_complete"] and {det.config.train_batch_size,
                                        det.config.max_batch} <= set(warm)):
        failures.append(f"/admin/xla shows no warm set: {xla.get('buckets')}")
    if unexpected_metric or xla["totals"]["unexpected"]:
        failures.append(f"unexpected recompiles: metric {unexpected_metric}, "
                        f"ledger {xla['totals']['unexpected']}")
    if deep_code != 200 or not result["warmup_check"] or \
            result["warmup_check"][0]["status"] != "pass":
        failures.append(f"deep health after warm-up: {deep_code} {deep}")
    if releases_metric != {k: v for k, v in stats_after["releases"].items() if v}:
        failures.append(f"detector_deadline_releases_total {releases_metric} against "
                        f"batching_stats {stats_after['releases']}")
    if counts["candidate_lse"] < 1 or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"],
                                "coalesce")
            check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "coalesce")
        except AssertionError as exc:
            failures.append(str(exc))
    if runner.is_alive():
        failures.append("the service did not shut down")
    if failures:
        raise AssertionError(f"the coalesce phase failed: {failures}")
    return result


def _coalesce_counters(text: str, det, cid: str) -> tuple:
    """From a ``/metrics`` text: ``detector_deadline_releases_total`` by
    reason (the detector's series carry its name as component_id) and
    ``scorer_xla_recompiles_unexpected_total`` (the service's labels)."""
    releases = {labels.split('reason="')[1].split('"')[0]: value for labels, value
                in metric_samples(text, "detector_deadline_releases_total",
                                  det.name).items()}
    unexpected = sum(metric_samples(text, "scorer_xla_recompiles_unexpected_total",
                                    cid).values())
    return releases, unexpected


def _settle(det, engine, collector) -> None:
    """Wait until the engine read no frame, and no alert came, for a second
    and nothing is held or in flight. Only Python attributes are read while
    the stream runs: an HTTP scrape would hold the interpreter lock the
    engine loop needs, and the release waits would measure the scrape."""
    def settled():
        return (det.pending_count() == 0 and engine._hb_ingest.age() > 1.0
                and (not collector.times or time.perf_counter() - collector.times[-1] > 1.0))

    _wait(settled, 300, "the stream to go quiet", interval=0.1)


def _coalesce_settle(det, engine, collector) -> None:
    """``_settle``, then stop the collector."""
    _settle(det, engine, collector)
    collector.stop_flag.set()
    collector.join(5)


def _hbm_in_use(det) -> float:
    """``device_hbm_bytes{kind="in_use"}`` as the gauge reads it (0 off the
    card)."""
    if det._device.type != "cuda":
        return 0.0
    torch.cuda.synchronize()
    return float(torch.cuda.memory_stats(det._device)["allocated_bytes.all.current"])


def coalesce_retirement(tmp: Path, checkpoint: Path, device: str) -> dict:
    """(b): the example with ``bucket_retire_interval_s: 1``, restored from
    (a)'s checkpoint, driven in process with releases of two sizes: small
    ones (natural bucket 256, by deadline) and full ones (1024). While only
    full releases come, the 256 bucket retires and its graph is dropped;
    small releases then pad up to 1024 until the pressure resurrects 256
    with one expected capture."""
    tmp.mkdir(parents=True)
    ledger = device_obs.get_ledger()
    det = coalesce_detector(tmp, device, bucket_retire_interval_s=COALESCE_RETIRE_S)
    det.load_checkpoint(str(checkpoint))
    msgs, _ = make_messages(RETIRE_LARGE, anomaly_rate=0.01, seed=3)
    small = msgs[:RETIRE_SMALL]
    kind = det._serve_kind()
    natural = 256
    deadline_s = det.config.batch_deadline_ms / 1e3

    def small_release():
        det.process_batch(small)
        time.sleep(deadline_s)
        det.drain_ready()
        det.flush()
        return ledger.snapshot()["batches"][-1]

    seq0 = ledger.snapshot()["totals"]
    unexpected0 = seq0["unexpected"]
    warmed = small_release()
    hbm_before = _hbm_in_use(det)
    t0 = time.monotonic()
    large_rounds = 0
    while time.monotonic() - t0 < 2.2 * COALESCE_RETIRE_S or natural not in det._retired_buckets:
        det.process_batch(msgs)
        det.flush()
        large_rounds += 1
        if time.monotonic() - t0 > 30:
            raise AssertionError("no bucket retired in 30 s")
    retired = det.batching_stats()["retired_buckets"]
    dropped = not det._warm.has(kind, natural)
    hbm_after = _hbm_in_use(det)
    events0 = ledger.snapshot()["totals"]["compiles"]
    # small releases until the bucket is back (a sweep between two of them
    # restarts the pressure count), then one more on it
    spans = []
    while len(spans) < 20 and (not spans or spans[-1]["bucket"] != natural):
        spans.append(small_release())
    spans.append(small_release())
    snap = ledger.snapshot()
    new_events = snap["compiles"][-(snap["totals"]["compiles"] - events0):] \
        if snap["totals"]["compiles"] > events0 else []
    resurrections = [e for e in new_events if e["bucket"] == str(natural)]
    det.flush_final()
    result = dict(
        warm_span=warmed, retired_buckets=retired, graph_dropped=dropped,
        large_rounds=large_rounds, pad_up_spans=[s for s in spans if s["bucket"] > natural],
        spans=spans, resurrection_captures=resurrections,
        warm_after=det.batching_stats()["warm_buckets"],
        unexpected=snap["totals"]["unexpected"] - unexpected0,
        device_hbm_bytes_in_use={"before_retirement": hbm_before,
                                 "after_retirement": hbm_after,
                                 "after_resurrection": _hbm_in_use(det)},
        buckets_retired_total=det.batching_stats()["buckets_retired_total"])
    emit("coalesce_retire", **result)
    failures = []
    if warmed["bucket"] != natural or warmed["real"] != RETIRE_SMALL:
        failures.append(f"the small release took bucket {warmed['bucket']}")
    if natural not in retired or not dropped:
        failures.append(f"bucket {natural} did not retire with its graph: {retired}")
    pad_ups = len(result["pad_up_spans"])
    if pad_ups < det.config.bucket_retire_min_dispatches or \
            any(s["real"] != RETIRE_SMALL for s in spans):
        failures.append(f"fewer than {det.config.bucket_retire_min_dispatches} small "
                        f"releases padded up: {spans}")
    if len(resurrections) != 1 or resurrections[0]["where"] != "bucket_warm" \
            or resurrections[0]["unexpected"] \
            or not any(s["bucket"] == natural for s in spans):
        failures.append(f"bucket {natural} not resurrected by one expected capture: "
                        f"{resurrections}, warm {result['warm_after']}")
    if result["unexpected"]:
        failures.append(f"{result['unexpected']} unexpected captures")
    if failures:
        raise AssertionError(f"the retirement check failed: {failures}")
    return result


def _timeless(alert: bytes) -> bytes:
    """An alert with its wall-clock stamps (detection and receipt, whole
    seconds of the host clock) zeroed; every other byte as sent."""
    doc = DetectorSchema.from_bytes(alert)
    doc["detectionTimestamp"] = 0
    doc["receivedTimestamp"] = 0
    return doc.serialize()


def coalesce_workers(tmp: Path, checkpoint: Path, device: str) -> dict:
    """(c): (a)'s stream and lone messages in process through
    ``process_batch`` (calls of 1,024; each lone message flushed), inline
    and with ``upload_workers: 1``, each detector restored from (a)'s
    checkpoint; the alerts must be the same bytes apart from the wall-clock
    stamps. Then the example's buckets replayed against the eager call
    after the restore."""
    msgs, _ = make_messages(COALESCE_DETECT, anomaly_rate=0.01, seed=1)
    lone = _lone_anomalies(COALESCE_LONE, "lone")
    runs = {}
    for workers in (0, 1):
        sub = tmp / f"workers{workers}"
        sub.mkdir(parents=True)
        det = coalesce_detector(sub, device, upload_workers=workers)
        det.load_checkpoint(str(checkpoint))
        alerts = []
        t0 = time.perf_counter()
        for i in range(0, len(msgs), 1024):
            alerts.extend(det.process_batch(msgs[i:i + 1024]))
        alerts.extend(det.flush())
        elapsed = time.perf_counter() - t0
        alive = [t.name for t in det._upload_threads if t.is_alive()]
        for msg in lone:
            alerts.extend(det.process_batch([msg]))
            alerts.extend(det.flush())
        alerts.extend(det.flush_final())
        runs[workers] = dict(det=det, alerts=alerts, lines_per_s=len(msgs) / elapsed,
                             workers_alive=alive, stats=det.batching_stats(),
                             workers_after=[t.name for t in det._upload_threads
                                            if t.is_alive()])
    inline, worker = runs[0], runs[1]
    same = [_timeless(a) for a in inline["alerts"]] == [_timeless(a) for a in worker["alerts"]]
    checks = replay_vs_eager(inline["det"], "coalesce_mlp", "restore",
                             [inline["det"].config.max_batch,
                              inline["det"].config.train_batch_size],
                             msgs) if device == "cuda" else []
    result = dict(alerts=len(inline["alerts"]), identical=same,
                  inline_lines_per_s=inline["lines_per_s"],
                  workers_lines_per_s=worker["lines_per_s"],
                  workers_alive=worker["workers_alive"], workers_after=worker["workers_after"],
                  releases={"inline": inline["stats"]["releases"],
                            "workers": worker["stats"]["releases"]},
                  replay_vs_eager=checks)
    emit("coalesce_workers", **result)
    if not same or not inline["alerts"] or not worker["workers_alive"] \
            or worker["workers_after"] or inline["workers_alive"]:
        raise AssertionError(f"the upload-worker run differs from inline dispatch: {result}")
    return result


# -- phase 14: the model lifecycle -------------------------------------------
def make_shifted_messages(n: int, seed: int = 5) -> list:
    """(d)'s shifted stream: the audit lines of ``make_messages`` (no
    anomalies) mixed half and half with a template the fit never saw."""
    rng = np.random.default_rng(seed)
    audit, _ = make_messages(n, anomaly_rate=0.0, seed=seed)
    msgs = []
    for i in range(n):
        if rng.random() < 0.5:
            msgs.append(audit[i])
            continue
        msgs.append(ParserSchema(
            EventID=2, template="sshd[<*>]: Accepted publickey for <*> from <*> port <*>",
            variables=[str(int(rng.integers(1000, 1100))), ["deploy", "backup"][i % 2],
                       f"10.1.0.{i % 8}", "22"],
            logID=f"s{i}", logFormatVariables={"Time": str(1_700_100_000 + i)}).serialize())
    return msgs


def serve_sender(addr: str, n_fit: int, n_detect: int, n_shifted: int) -> None:
    """The upstream stage of the lifecycle phase, in a process of its own:
    for each command line of standard input (``fit``, ``detect``,
    ``shifted``) it sends that stream's single messages to ``addr`` and
    prints a JSON line with when the stream began and ended
    (``time.perf_counter``); ``close`` closes the socket."""
    streams = {"fit": make_messages(n_fit, anomaly_rate=0.0)[0],
               "detect": make_messages(n_detect, anomaly_rate=0.01, seed=1)[0],
               "shifted": make_shifted_messages(n_shifted)}
    sender = ZmqPairSocketFactory().create_output(addr, buffer_size=1000)
    print("ready", flush=True)
    for line in sys.stdin:
        command = line.strip()
        if command == "close":
            break
        t0 = time.perf_counter()
        for msg in streams[command]:
            sender.send(msg)
        print(json.dumps({"t_first": t0, "t_sent": time.perf_counter()}), flush=True)
    sender.close()


class uncounted:
    """Launches made inside (checks beside a path: replays against eager
    calls, candidate against live) leave every wrapper's count, and the
    detector's replayed launches, as they were."""

    def __init__(self, det):
        self.det = det

    def __enter__(self):
        self.saved = [(fn.launches, Counter(fn.variants)) for fn in KERNEL_WRAPPERS]
        self.replays = dict(self.det._warm.replay_launches)
        return self

    def __exit__(self, *exc):
        for fn, (launches, variants) in zip(KERNEL_WRAPPERS, self.saved):
            fn.launches = launches
            fn.variants.clear()
            fn.variants.update(variants)
        self.det._warm.replay_launches.clear()
        self.det._warm.replay_launches.update(self.replays)
        return False


def candidate_vs_live(det, params, msgs, rows: int = 1024) -> dict:
    """``rollout_scores`` of ``rows`` messages through a candidate's state
    dict (op by op) and through the live weights (the warm set's graph):
    after an install of that candidate they must be bit-equal."""
    tokens, ok = det._featurize_raw_batch(msgs[:rows])
    if not ok.all():
        raise AssertionError("a message of the candidate check did not featurize")
    with uncounted(det):
        live = det.rollout_scores(None, tokens)
        cand = det.rollout_scores(params, tokens)
    return {"rows": int(len(tokens)), "bit_equal": bool(np.array_equal(live, cand)),
            "max_abs_diff": float(np.abs(live - cand).max())}


def _swap_captures(ledger, since: int) -> list:
    """The ledger's capture events after the first ``since``."""
    snap = ledger.snapshot()
    n = snap["totals"]["compiles"] - since
    return snap["compiles"][-n:] if n > 0 else []


def _timed(obj, name: str, log: list):
    """Wrap ``obj``'s method ``name`` to log each call's span on the host's
    monotonic clock."""
    original = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return original(*args, **kwargs)
        finally:
            t1 = time.monotonic()
            log.append({"seam": name, "t0": t0, "t1": t1, "seconds": t1 - t0})

    setattr(obj, name, timed)


class _CycleThread(threading.Thread):
    """``POST /admin/model {"action": "cycle", "block": true}`` on a thread
    of its own, stamped with the host's monotonic clock."""

    def __init__(self, port: int):
        super().__init__(name="CycleRequest", daemon=True)
        self.port, self.result, self.error = port, None, None
        self.t0 = self.t1 = None

    def run(self) -> None:
        self.t0 = time.monotonic()
        try:
            self.result = _http("POST", self.port, "/admin/model", timeout=300,
                                payload={"action": "cycle", "block": True})[1]
        except Exception as exc:  # noqa: BLE001 — the caller raises it
            self.error = exc
        self.t1 = time.monotonic()


def _cycle(port: int, mgr, tries: int = 60) -> _CycleThread:
    """One blocking operator cycle; while another candidate (a drift
    cycle's) shadows, the cycle is skipped: wait for its verdict and send
    again."""
    for _ in range(tries):
        cycle = _CycleThread(port)
        cycle.start()
        cycle.join(300)
        if cycle.error is not None:
            raise AssertionError(f"the cycle request failed: {cycle.error}")
        if "skipped" not in cycle.result or "shadowing" not in cycle.result["skipped"]:
            return cycle
        _wait(lambda: mgr.status()["shadow"] is None, 60, "the shadowing candidate's verdict")
    raise AssertionError(f"the cycle was skipped {tries} times")


def _lone_during(port: int, sender, sink, mgr) -> tuple:
    """Lone anomalous messages, one at a time, while a blocking cycle runs:
    ``(cycle, [(send time, seconds, lines)...])``."""
    sink.recv_timeout = 10000
    cycle = _CycleThread(port)
    cycle.start()
    out, i = [], 0
    while cycle.is_alive() and i < 256:
        msg = _lone_anomalies(1, f"cyc{i}")[0]
        t0 = time.monotonic()
        sender.send(msg)
        alert = DetectorSchema.from_bytes(sink.recv())
        out.append((t0, time.monotonic() - t0, count_lines(msg)))
        if alert["logIDs"] != [f"cyc{i}-0"]:
            raise AssertionError(f"lone message cyc{i}-0 got the alert {alert['logIDs']}")
        i += 1
    cycle.join(300)
    if cycle.error is not None:
        raise AssertionError(f"the cycle request failed: {cycle.error}")
    return cycle, out


def phase_lifecycle(smi: str, device: str = "cuda") -> dict:
    """The scorer example with the model lifecycle on, hosted by the port's
    Service: (a) a cycle under load, (b) promote and rollback, (c) a broken
    candidate, (d) drift, (e) capacity."""
    tmp = Path(tempfile.mkdtemp(prefix="dmlc", dir="/tmp"))
    previous = device_obs.get_ledger()
    # a ledger of this phase's own, with room for every span of its streams
    device_obs.activate(device_obs.CompileLedger(max_spans=8192))
    try:
        return lifecycle_service(tmp, smi, device)
    finally:
        device_obs.activate(previous)
        shutil.rmtree(tmp, ignore_errors=True)


def lifecycle_service(tmp: Path, smi: str, device: str) -> dict:
    ledger = device_obs.get_ledger()
    settings = ServiceSettings.from_yaml(str(coalesce_files(
        tmp, device, settings_changes=dict(LIFECYCLE_SETTINGS,
                                           rollout_dir=str(tmp / "store")))))
    cid = settings.component_id
    fit_msgs, _ = make_messages(512, anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(LIFECYCLE_DETECT, anomaly_rate=0.01, seed=1)
    shifted_msgs = make_shifted_messages(LIFECYCLE_SHIFTED)
    lone = _lone_anomalies(LIFECYCLE_LONE, "lone")
    factory = ZmqPairSocketFactory()
    sink = factory.create(settings.out_addr[0])
    service = Service(settings)
    t0 = time.perf_counter()
    service.setup_io()
    setup_s = time.perf_counter() - t0
    det, mgr = service.library_component, service.rollout
    drift, capacity = service.drift, service.capacity
    if mgr is None or drift is None or capacity is None:
        raise AssertionError("the Service built no rollout manager, drift or capacity monitor")
    # every coalesced release's wait (the oldest held row's age), by the
    # host's monotonic clock; each seam's seconds
    waits, seams = [], []
    release = det._release_coalesced

    def recording(n, reason, now):
        waits.append((now, reason, det._coalescer.oldest_age(now)))
        return release(n, reason, now)

    det._release_coalesced = recording
    for name in ("rollout_fine_tune", "install_candidate"):
        _timed(det, name, seams)
    # every manager verb's span (operator, drift-started and thread-ticked
    # alike: a cycle is any of them), and the monitors' ticks
    verbs, ticks = [], []
    for name in ("run_cycle", "shadow_tick", "promote", "rollback", "inject_candidate"):
        _timed(mgr, name, verbs)
    _timed(drift, "tick", ticks)
    _timed(capacity, "tick", ticks)
    runner = threading.Thread(target=service.run, name="ServiceRun", daemon=True)
    runner.start()
    _wait(lambda: service.engine.running and service.web_server.port, 30, "the service")
    port = service.web_server.port
    collector = _Collector(sink)
    collector.start()
    upstream = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.serve_sender("
         f"{settings.engine_addr!r}, {len(fit_msgs)}, {LIFECYCLE_DETECT}, "
         f"{LIFECYCLE_SHIFTED})"],
        cwd=Path(__file__).resolve().parent, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))

    def command(name: str) -> dict:
        upstream.stdin.write(name + "\n")
        upstream.stdin.flush()
        return json.loads(upstream.stdout.readline())

    try:
        if upstream.stdout.readline().strip() != "ready":
            raise AssertionError("the sender process did not start")

        # the main path: launch counts 0 just before, read just after (d)
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        command("fit")
        _wait(lambda: det._fitted and det._fit_thread is None and det.pending_count() == 0,
              300, "the fit at the boundary")
        fit_s = time.perf_counter() - t0

        # (e), first half: no batch yet, so after 1 s idle the capacity
        # model is the probe's
        _wait(lambda: capacity.status()["capacity_source"] == "probe", 60,
              "the idle capacity probe")
        slo_probe = _http("GET", port, "/admin/slo")[1]

        # (a) a cycle under load: sent once the reservoir holds
        # LIFECYCLE_CYCLE_AT rows, while the stream flows
        sent_mono = time.monotonic()
        upstream.stdin.write("detect\n")
        upstream.stdin.flush()
        _wait(lambda: len(mgr.sampler) >= LIFECYCLE_CYCLE_AT, 120, "sampled rows", 0.005)
        cycle_a = _cycle(port, mgr)
        sent = json.loads(upstream.stdout.readline())
        _settle(det, service.engine, collector)
        t_last = collector.times[-1] if collector.times else float("nan")
        detect_alerts = list(collector.frames)
        collector.stop_flag.set()
        collector.join(5)
        slo_traffic = _http("GET", port, "/admin/slo")[1]
        sampler_after = mgr.sampler.stats()

        sender = factory.create_output(settings.engine_addr, buffer_size=1000)
        latencies = _lone_latencies(sender, sink, lone)
        cycle_b, lone_during = _lone_during(port, sender, sink, mgr)
        t_end_a = time.monotonic()

        # (b) promote a stored version, then roll back; every swap checked
        swaps = []
        compiles0 = ledger.snapshot()["totals"]["compiles"]
        history = _http("GET", port, "/admin/model?history=1")[1]
        stored = sorted(e["version"] for e in history["checkpoints"])
        live = _http("GET", port, "/admin/model")[1]["live_version"]
        actions = []
        if live is None:
            actions.append(("promote", stored[0]))
            live = stored[0]
        actions += [("promote", max(v for v in stored if v != live)), ("rollback", None)]
        for action, version in actions:
            outcome = _http("POST", port, "/admin/model", timeout=120,
                            payload={"action": action, "version": version})[1]
            swaps.append(lifecycle_swap_check(det, mgr, ledger, compiles0, action, outcome,
                                              detect_msgs, port))
        text = _http("GET", port, "/metrics")[1]
        swap_series = {name: metric_samples(text, name, cid) for name in (
            "model_swaps_total", "model_version_info", "model_shadow_divergence_count")}

        # (c) a broken candidate: the live weights with the embedding scaled
        state = det._model.state_dict()
        broken = {k: (v * 10.0 if k == "tok_embed.weight" else v.clone())
                  for k, v in state.items()}
        broken_version = None
        for _ in range(600):
            try:
                broken_version = mgr.inject_candidate(broken, det._optimizer.state_dict(),
                                                      tag="broken")
                break
            except Exception as exc:  # noqa: BLE001 — a drift candidate shadows: wait
                if "already shadowing" not in str(exc):
                    raise
                time.sleep(0.1)
        broken_outcome = None
        for _ in range(200):
            broken_outcome = mgr.shadow_tick()
            if broken_outcome is not None or mgr.status()["shadow"] is None:
                break
            time.sleep(0.05)
        broken_entry = mgr.store.entry(broken_version)
        events = _http("GET", port, "/admin/events")[1]
        holdback_events = [e for e in events.get("events", [])
                           if e.get("kind") == "model_canary_holdback"
                           and e.get("version") == broken_version]
        holdbacks = sum(v for k, v in metric_samples(
            _http("GET", port, "/metrics")[1], "model_swaps_total", cid).items()
            if 'result="holdback"' in k)

        # (d) drift: a shifted stream of the baseline's stream's size
        collector = _Collector(sink)
        collector.start()
        ticks0 = drift.status()["ticks"]
        upstream.stdin.write("shifted\n")
        upstream.stdin.flush()
        drifting = {}

        def detected():
            doc = _http("GET", port, "/admin/drift")[1]
            if doc["drifting"]:
                drifting.update(doc)
            return bool(drifting)

        _wait(detected, 120, "drift_detected", interval=0.25)
        shifted_sent = json.loads(upstream.stdout.readline())

        def drift_cycle():
            doc = _http("GET", port, "/admin/model?history=1")[1]
            return [e for e in doc["checkpoints"] if e["meta"].get("reason") == "drift"]

        _wait(lambda: bool(drift_cycle()), 120, "a drift-started cycle", interval=0.25)
        drift_entries = drift_cycle()
        _settle(det, service.engine, collector)
        shifted_alerts = list(collector.frames)
        counts = read_launches()
        variants = read_variants()["candidate_lse"]
        graph = replay_delta(det, replays0)
        collector.stop_flag.set()
        collector.join(5)
        drift_events = [e["kind"] for e in _http("GET", port, "/admin/events")[1]["events"]
                        if e.get("kind", "").startswith("drift_")]
        upstream.stdin.write("close\n")
        upstream.stdin.flush()
        upstream.wait(30)
    finally:
        if upstream.poll() is None:
            upstream.kill()
            upstream.wait(10)

    lines_sent = sum(map(count_lines, fit_msgs + detect_msgs + lone + shifted_msgs)) \
        + sum(lines for _, _, lines in lone_during)
    text = _http("GET", port, "/metrics")[1]
    read_lines = metric_value(text, "data_read_lines_total", cid)
    xla = _http("GET", port, "/admin/xla")[1]
    events = _http("GET", port, "/admin/events")[1]["events"]
    probe_failures = [e for e in events if "capacity probe failed" in e.get("message", "")]
    status = _http("GET", port, "/admin/model")[1]
    _http("POST", port, "/admin/shutdown")
    runner.join(60)
    sender.close()
    sink.close()

    ids = [DetectorSchema.from_bytes(a)["logIDs"][0] for a in _messages_of(detect_alerts)]
    by_id = set(ids)
    shifted_ids = [DetectorSchema.from_bytes(a)["logIDs"][0]
                   for a in _messages_of(shifted_alerts)]
    recall = len(anomalies & by_id) / max(1, len(anomalies))
    # release waits inside and outside the cycles: a wait is inside when
    # its span (the oldest row's arrival to the release) meets a manager
    # verb's span
    windows = [(v["t0"], v["t1"]) for v in verbs]

    def meets(w, spans):
        return any(a <= w[0] and w[0] - w[2] <= b for a, b in spans)

    # (a)'s stream and lone messages, the coalesce phase's traffic, are held
    # to the bound outside the cycles; (d)'s stream, half of it alerts, is
    # reported apart
    stream_a = [w for w in waits if w[0] <= t_end_a]
    inside = [w for w in stream_a if meets(w, windows)]
    outside = [w for w in stream_a if not meets(w, windows)]
    shifted_waits = [w for w in waits if w[0] > t_end_a]
    tick_spans = [(t["t0"], t["t1"]) for t in ticks]
    slowest_outside = [{"reason": w[1], "wait_ms": w[2] * 1e3,
                        "after_stream_start_s": w[0] - sent_mono,
                        "monitor_tick_overlaps": meets(w, tick_spans)}
                       for w in sorted(outside, key=lambda w: w[2])[-5:]]
    tick_ms = det.drain_poll_ms
    wait_bound_s = (det.config.batch_deadline_ms + tick_ms + 2.0) / 1e3
    during = [s for t, s, _ in lone_during if cycle_b.t0 <= t <= cycle_b.t1]
    outcome_a = cycle_a.result.get("outcome") or {}
    divergence = outcome_a.get("divergence") or {}
    fine_tunes = [s["seconds"] for s in seams if s["seam"] == "rollout_fine_tune"]
    capacity_doc = slo_traffic["capacity"]
    result = dict(
        card=smi, setup_s=setup_s, fit_s=fit_s, n_detect=LIFECYCLE_DETECT,
        socket_lines_per_s=LIFECYCLE_DETECT / (t_last - sent["t_first"]),
        sender_lines_per_s=LIFECYCLE_DETECT / (sent["t_sent"] - sent["t_first"]),
        cycle={"verdict": outcome_a.get("result"), "version": cycle_a.result.get("version"),
               "rows": cycle_a.result.get("rows"), "fine_tune": cycle_a.result.get("fine_tune"),
               "fine_tune_s": fine_tunes[0] if fine_tunes else None,
               "elapsed_s": cycle_a.result.get("elapsed_s"),
               "window_s": cycle_a.t1 - cycle_a.t0,
               "shadow_samples": divergence.get("samples"),
               "shadow_ticks": -(-(divergence.get("samples") or 0) // 256),
               "mean_abs_delta": divergence.get("mean_abs_delta"),
               "flip_ratio": divergence.get("flip_ratio"), "why": outcome_a.get("why"),
               "swap": outcome_a.get("swap")},
        second_cycle={"verdict": (cycle_b.result.get("outcome") or {}).get("result"),
                      "rows": cycle_b.result.get("rows"),
                      "fine_tune": cycle_b.result.get("fine_tune"),
                      "window_s": cycle_b.t1 - cycle_b.t0},
        fine_tune_s=fine_tunes, sampler=sampler_after,
        release_wait_ms={"outside_max": max((w[2] for w in outside), default=0.0) * 1e3,
                         "inside_max": max((w[2] for w in inside), default=0.0) * 1e3,
                         "outside_releases": len(outside), "inside_releases": len(inside),
                         "bound": wait_bound_s * 1e3, "slowest_outside": slowest_outside,
                         "shifted_stream_max": max((w[2] for w in shifted_waits),
                                                   default=0.0) * 1e3,
                         "shifted_stream_releases": len(shifted_waits)},
        manager_verbs={name: [round(v["seconds"], 4) for v in verbs if v["seam"] == name]
                       for name in ("run_cycle", "shadow_tick", "promote", "rollback",
                                    "inject_candidate")},
        monitor_tick_ms={"count": len(ticks),
                         "max": max((t["seconds"] for t in ticks), default=0.0) * 1e3,
                         "mean": (sum(t["seconds"] for t in ticks) / max(1, len(ticks))) * 1e3},
        lone_p50_ms={"outside": float(np.percentile(latencies, 50) * 1e3),
                     "during_cycle": (float(np.percentile(during, 50) * 1e3)
                                      if during else None),
                     "during_count": len(during)},
        lone_p99_ms=float(np.percentile(latencies, 99) * 1e3),
        swaps=swaps, swap_series=swap_series,
        broken={"version": broken_version, "status": broken_entry["status"],
                "mean_abs_delta": broken_entry["meta"].get("divergence", {}).get(
                    "mean_abs_delta"),
                "events": len(holdback_events), "holdback_metric": holdbacks},
        drift={"evaluations_to_detect": drifting.get("ticks", 0) - ticks0,
               "stats": drifting.get("stats"), "thresholds": drifting.get("thresholds"),
               "baseline": drifting.get("baseline"), "events": drift_events,
               "drift_cycles": [e["version"] for e in drift_entries],
               "shifted_lines_per_s_sent": LIFECYCLE_SHIFTED / (
                   shifted_sent["t_sent"] - shifted_sent["t_first"])},
        capacity={"probe": slo_probe["capacity"], "traffic": capacity_doc,
                  "probe_failures": len(probe_failures)},
        slo_burn=slo_traffic["burn"],
        lines_sent=lines_sent, read_lines=read_lines, alerts=len(ids),
        unique_alerts=len(by_id), anomalies=len(anomalies), recall=recall,
        shifted_alerts=len(shifted_ids), shifted_unique_alerts=len(set(shifted_ids)),
        launches=counts["candidate_lse"], launch_counts=counts, variants=variants,
        replayed_launches=graph,
        xla={"totals": xla["totals"],
             "model_swap_captures": [c for c in xla["compiles"] if c["where"] == "model_swap"]},
        final_status={k: status[k] for k in ("live_version", "detector_version", "history")})
    emit("lifecycle", **result)
    failures = []
    if device == "cuda" and result["release_wait_ms"]["outside_max"] > wait_bound_s * 1e3:
        failures.append(f"a release outside the cycles waited "
                        f"{result['release_wait_ms']['outside_max']:.3f} ms")
    if read_lines != lines_sent:
        failures.append(f"read {read_lines} lines of {lines_sent} sent")
    if len(by_id) != len(ids) or len(set(shifted_ids)) != len(shifted_ids):
        failures.append("an alert was received twice")
    if recall < 0.9:
        failures.append(f"recall {recall}")
    if outcome_a.get("result") not in ("promoted", "holdback"):
        failures.append(f"(a)'s cycle gave no verdict: {cycle_a.result}")
    if xla["totals"]["unexpected"] or result["xla"]["model_swap_captures"]:
        failures.append(f"captures: {result['xla']}")
    for swap in swaps:
        if swap["failures"]:
            failures.append(f"{swap['action']}: {swap['failures']}")
    if not any('result="promoted"' in k for k in swap_series["model_swaps_total"]) or \
            not any('result="rolled_back"' in k for k in swap_series["model_swaps_total"]) or \
            not swap_series["model_version_info"] or \
            not swap_series["model_shadow_divergence_count"]:
        failures.append(f"the swap series are not exported: {swap_series}")
    if broken_entry["status"] != "holdback" or not holdback_events or holdbacks < 1:
        failures.append(f"(c) the broken candidate was not held back: {result['broken']}")
    if "drift_detected" not in drift_events or not drift_entries:
        failures.append(f"(d) no drift_detected or no drift cycle: {result['drift']}")
    stats, limits = drifting.get("stats") or {}, drifting.get("thresholds") or {}
    if not ((stats.get("ks") or 0) > limits.get("ks", 1) or
            (stats.get("psi") or 0) > limits.get("psi", 1e9)):
        failures.append(f"(d) model_drift_score under its thresholds: {stats}")
    if slo_probe["capacity"]["capacity_source"] != "probe" or probe_failures or \
            not slo_probe["capacity"]["capacity_lines_per_s"]:
        failures.append(f"(e) no probed capacity: {result['capacity']}")
    if not capacity_doc or capacity_doc["capacity_source"] != "traffic":
        failures.append(f"(e) no modeled capacity from traffic: {capacity_doc}")
    if counts["candidate_lse"] < 1 or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"],
                                "lifecycle")
        except AssertionError as exc:
            failures.append(str(exc))
        if graph["candidate_lse"] > counts["candidate_lse"] or graph["candidate_lse"] < 1:
            failures.append(f"replayed {graph}, launched {counts}")
    if runner.is_alive():
        failures.append("the service did not shut down")
    if failures:
        raise AssertionError(f"the lifecycle phase failed: {failures}")
    return result


def lifecycle_swap_check(det, mgr, ledger, compiles0: int, action: str, outcome: dict,
                         msgs, port: int) -> dict:
    """After one swap over the admin plane: no unexpected capture and no
    capture under ``model_swap``; every warm bucket's replay bit-equal to
    its eager call on the new weights; the installed version's stored
    state scored as a candidate bit-equal to the live weights."""
    version = outcome["version"]
    entry = mgr.store.entry(version)
    params = det.load_params_checkpoint(str(mgr.store.root / entry["dir"]))[0]
    captures = _swap_captures(ledger, compiles0)
    xla = _http("GET", port, "/admin/xla")[1]
    with uncounted(det):
        checks = replay_vs_eager(det, "lifecycle_mlp", f"{action}_v{version}",
                                 det._active_buckets(), msgs) \
            if det._device.type == "cuda" else []
    cand = candidate_vs_live(det, params, msgs)
    row = {"action": action, "version": version, "result": outcome["result"],
           "install": outcome["swap"].get("install"),
           "model_swap_captures": len([c for c in captures if c["where"] == "model_swap"]),
           "captures": len(captures), "unexpected": xla["totals"]["unexpected"],
           "candidate_vs_live": cand, "replay_vs_eager": len(checks),
           "live_version": _http("GET", port, "/admin/model")[1]["live_version"]}
    failures = []
    if row["model_swap_captures"] or row["captures"] or row["unexpected"]:
        failures.append(f"captures {captures}, unexpected {row['unexpected']}")
    if not cand["bit_equal"]:
        failures.append(f"candidate against live: {cand}")
    if row["live_version"] != version or det.model_version() != version:
        failures.append(f"live {row['live_version']}, detector {det.model_version()}")
    row["failures"] = failures
    emit("lifecycle_swap", **row)
    return row


def int8_lifecycle(det, msgs) -> dict:
    """(f): phase 10's int8w detector fine-tuned on 512 of its detect
    messages and the candidate installed: the gate judged again (rows and
    flips), every warm bucket re-captured as an expected capture, none
    unexpected, replays bit-equal to eager, and the state's bytes equal to
    ``quant_stats``."""
    tokens, ok = det._featurize_raw_batch(msgs[:512])
    if not ok.all():
        raise AssertionError("a message of the int8w fine-tune did not featurize")
    ledger = det._ledger
    before = ledger.snapshot()["totals"]
    kind_keys = {bucket for _, bucket in det._warm.keys()}
    # the path: launch counts 0 just before, read just after
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    params, opt_state, info = det.rollout_fine_tune(tokens, seed=1)
    torch.cuda.synchronize()
    fine_tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    swap = det.install_candidate(params, opt_state, version=1)
    install_s = time.perf_counter() - t0
    counts = read_launches()
    variants = read_variants()["candidate_lse"]
    graph = replay_delta(det, replays0)
    captures = _swap_captures(ledger, before["compiles"])
    unexpected = ledger.snapshot()["totals"]["unexpected"] - before["unexpected"]
    report = swap["int8"]
    with uncounted(det):
        checks = replay_vs_eager(det, "int8w_mlp", "install",
                                 [32, CALL_SIZE, INT8_CONFIG["max_batch"]], msgs)
    state_bytes = None if det._qstate is None else sum(
        t.numel() * t.element_size() for leaf in det._qstate.values() for t in leaf)
    quant_bytes = report.get("bytes") or {}
    recaptured = {int(c["bucket"]) for c in captures
                  if c["where"] == "int8_activate" and not c["unexpected"]}
    result = dict(fine_tune=info, fine_tune_s=fine_tune_s, install_s=install_s,
                  install=swap["install"], gate=report, captures=len(captures),
                  recaptured_buckets=sorted(recaptured), warm_buckets=sorted(kind_keys),
                  model_swap_captures=len([c for c in captures if c["where"] == "model_swap"]),
                  unexpected=unexpected, launches=counts["candidate_lse"],
                  launch_counts=counts, variants=variants, replayed_launches=graph,
                  state_bytes=state_bytes, quant_bytes=quant_bytes, replay_vs_eager=checks)
    emit("int8w_lifecycle", **result)
    failures = []
    if report.get("where") != "install" or report.get("rows") != 512 or "flips" not in report:
        failures.append(f"the gate was not judged again: {report}")
    if not kind_keys <= recaptured:
        failures.append(f"warm buckets {sorted(kind_keys)} re-captured {sorted(recaptured)}")
    if unexpected or result["model_swap_captures"]:
        failures.append(f"{unexpected} unexpected captures, "
                        f"{result['model_swap_captures']} under model_swap")
    if report.get("activated") and state_bytes != (quant_bytes.get("int8_bytes", 0)
                                                   + quant_bytes.get("float_bytes", 0)):
        failures.append(f"resident {state_bytes} B against quant_stats {quant_bytes}")
    # the gate's two passes over the 512-row parity corpus, 16 chunks each,
    # replayed on the card
    replayed_all = det._device.type != "cuda" or counts["candidate_lse"] == graph["candidate_lse"]
    if not replayed_all or counts["candidate_lse"] != 32 or counts["flash_forward"]:
        failures.append(f"launches {counts}, replayed {graph}")
    check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"],
                        "int8w lifecycle")
    if failures:
        raise AssertionError(f"the int8w lifecycle check failed: {failures}")
    return result


def logbert_expected_lifecycle(steps: int, chunks: int, depth: int) -> dict:
    """The LogBERT check's launches: each train step runs the flash forward,
    dQ and dK/dV once per layer; each shadow chunk (live, replayed, and
    candidate, op by op) the forward once per layer and the fused head
    once."""
    return {"flash_forward": (steps + 2 * chunks) * depth, "flash_dq": steps * depth,
            "flash_dkv": steps * depth, "candidate_lse": 2 * chunks,
            "replayed_candidate_lse": chunks, "replayed_flash_forward": chunks * depth}


def logbert_lifecycle(det, msgs) -> dict:
    """The LogBERT check: ``rollout_fine_tune`` on 256 sampled rows (8
    steps through the flash forward, dQ and dK/dV), ``rollout_scores`` of
    live and candidate, ``install_candidate``; then the 256 bucket's replay
    bit-equal to its eager call, the candidate's scores bit-equal to the
    live scores, and no capture at all."""
    tokens, ok = det._featurize_raw_batch(msgs[:LOGBERT_LIFECYCLE_ROWS])
    if not ok.all():
        raise AssertionError("a message of the LogBERT fine-tune did not featurize")
    ledger = det._ledger
    before = ledger.snapshot()["totals"]
    reset_launches()
    replays0 = replayed(det)
    t0 = time.perf_counter()
    params, opt_state, info = det.rollout_fine_tune(tokens, seed=1)
    torch.cuda.synchronize()
    fine_tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    live = det.rollout_scores(None, tokens)
    cand = det.rollout_scores(params, tokens)
    shadow_s = time.perf_counter() - t0
    counts = read_launches()
    variants = read_variants()
    graph = replay_delta(det, replays0)
    swap = det.install_candidate(params, opt_state, version=1)
    captures = _swap_captures(ledger, before["compiles"])
    with uncounted(det):
        checks = replay_vs_eager(det, "logbert", "install", [LOGBERT_CALL], msgs)
    after = candidate_vs_live(det, params, msgs, rows=LOGBERT_LIFECYCLE_ROWS)
    bucket = det.config.train_batch_size
    expected = logbert_expected_lifecycle(info["steps"], -(-len(tokens) // bucket),
                                          LOGBERT_CONFIG["depth"])
    delta = np.abs(live - cand)
    result = dict(fine_tune=info, fine_tune_s=fine_tune_s, shadow_s=shadow_s,
                  shadow_mean_abs_delta=float(delta.mean()), install=swap["install"],
                  captures=len(captures), candidate_vs_live=after,
                  launch_counts=counts, expected_launches=expected, variants=variants,
                  replayed_launches=graph, replay_vs_eager=checks)
    emit("logbert_lifecycle", **result)
    failures = []
    if info["steps"] != LOGBERT_LIFECYCLE_ROWS // bucket:
        failures.append(f"{info['steps']} train steps")
    for name in ("candidate_lse", "flash_forward", "flash_dq", "flash_dkv"):
        if counts[name] != expected[name]:
            failures.append(f"{name} launched {counts[name]}, expected {expected[name]}")
    if det._device.type == "cuda" and (
            graph["candidate_lse"] != expected["replayed_candidate_lse"]
            or graph["flash_forward"] != expected["replayed_flash_forward"]):
        failures.append(f"replayed {graph}")
    want = {name: {"wgmma_tma_d64": counts[name]}
            for name in ("flash_forward", "flash_dq", "flash_dkv")}
    if {name: variants[name] for name in want} != want:
        failures.append(f"flash variants {variants}")
    if captures or not after["bit_equal"] or not np.isfinite(cand).all():
        failures.append(f"captures {captures}, candidate against live {after}")
    try:
        check_head_variants(variants["candidate_lse"], "wgmma_tma_d256_",
                            counts["candidate_lse"], "LogBERT lifecycle")
    except AssertionError as exc:
        failures.append(str(exc))
    if failures:
        raise AssertionError(f"the LogBERT lifecycle check failed: {failures}")
    return result


# -- phase 15 ----------------------------------------------------------------
def device_busy(events: list) -> dict:
    """The device's busy and idle share over a profiler window: the window
    is the trace's session span (its ``Trace`` event), busy the union of
    its kernel intervals (and, apart, with memory copies and sets); the 3
    longest idle gaps with their offsets into the window."""
    spans = [e for e in events if e.get("cat") == "Trace" and e.get("ph") == "X"]
    if spans:
        w0, w1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    else:
        stamps = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
        w0, w1 = min(stamps), max(stamps)

    def union(kinds):
        spans = sorted((max(w0, e["ts"]), min(w1, e["ts"] + e["dur"])) for e in events
                       if e.get("cat") in kinds and e.get("ph") == "X")
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    kernels = union(("kernel",))
    edges = [w0, *[t for span in kernels for t in span], w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:3]
    busy = sum(b - a for a, b in kernels)
    copies = union(("kernel", "gpu_memcpy", "gpu_memset"))
    window = max(w1 - w0, 1e-9)
    return {"window_ms": window / 1e3, "kernel_events": sum(
                1 for e in events if e.get("cat") == "kernel"),
            "busy_ms": busy / 1e3, "busy_share": busy / window,
            "busy_share_with_copies": sum(b - a for a, b in copies) / window,
            "idle_share": 1.0 - busy / window,
            "idle_gaps": [{"ms": g / 1e3, "at_ms": (t - w0) / 1e3} for g, t in gaps]}


def kernel_in_trace(events: list, name: str) -> dict:
    """Count and mean duration (ms) of the device events whose name holds
    ``name``, also by launch grid."""
    found = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
    by_grid: dict = {}
    for e in found:
        key = str((e.get("args") or {}).get("grid"))
        n, total = by_grid.get(key, (0, 0.0))
        by_grid[key] = (n + 1, total + e["dur"])
    return {"count": len(found),
            "mean_ms": (sum(e["dur"] for e in found) / len(found) / 1e3) if found else None,
            "by_grid": {k: {"count": n, "mean_ms": total / n / 1e3}
                        for k, (n, total) in by_grid.items()}}


def capture_events(last: dict) -> list:
    return json.loads((Path(last["dir"]) / profiling.TRACE_FILE).read_text())["traceEvents"]


# -- phase mesh (16) -----------------------------------------------------------
def example_block(name: str, **changes) -> dict:
    """The detector block of ``examples/<name>``, renamed for the port
    (``method_type: torch_scorer``), with the fused head and ``changes``."""
    import yaml

    doc = yaml.safe_load((Path(__file__).resolve().parent / "examples" / name).read_text())
    return dict(doc["detectors"]["JaxScorerDetector"], method_type="torch_scorer",
                head_impl="pallas", **changes)


def _repeated_device(device: str) -> torch.device:
    return torch.device("cuda", 0) if device == "cuda" else torch.device(device)


def phase_mesh(smi: str, device: str = "cuda") -> dict:
    """The chip plane (``parallel/``) as one process drives it, on a mesh
    that repeats one device ``MESH_DEVICES`` times (``mesh.local_devices``
    replaced for the phase): (a) ring attention against the one-device
    blockwise attention, (b) BASELINE config #5, (c) the sequence-parallel
    example, (d) a mesh of one, (e) a process group of one, (f) and (g) the
    ``model`` axis computing: LogBERT's Megatron split with kernel 1, and
    with the flash kernels on each model shard. Each part's seconds go
    into ``parts_s``."""
    parts_s = {}

    def part(name: str, fn, *args, devices: int = 0):
        # devices: the repeated device's count in the mesh (0: unpatched)
        t0 = time.perf_counter()
        if devices:
            with _mesh_devices(device, devices):
                out = fn(*args)
            _empty_cache(device)
        else:
            out = fn(*args)
        parts_s[name] = time.perf_counter() - t0
        return out

    ring = part("ring", mesh_ring, device)
    scorer = part("scorer", mesh_scorer, smi, device, devices=MESH_DEVICES)
    seqpar = part("seqparallel", mesh_seqparallel, smi, device, devices=MESH_DEVICES)
    one = part("one", mesh_of_one, device, devices=1)
    boot = part("bootstrap", mesh_bootstrap, device)
    _empty_cache(device)
    model = part("model", mesh_model, smi, device,
                 devices=int(np.prod(list(MESH_MODEL_SHAPE.values()))))
    model_flash = part("model_flash", mesh_model_flash, smi, device,
                       devices=int(np.prod(list(MESH_MODEL_FLASH_SHAPE.values()))))
    result = dict(card=smi, ring=ring, scorer=scorer, seqparallel=seqpar, one=one,
                  bootstrap=boot, model=model, model_flash=model_flash, parts_s=parts_s,
                  launches=scorer["launches"] + seqpar["launches"],
                  replayed_launches={"candidate_lse": scorer["replayed_launches"]["candidate_lse"]
                                     + seqpar["replayed_launches"]["candidate_lse"]},
                  variants=dict(Counter(scorer["variants"]) + Counter(seqpar["variants"])),
                  head_max_abs_err=max(r["max_abs_err"] for r in
                                       scorer["head_checks"] + seqpar["head_checks"]
                                       + model["head_checks"] + model_flash["head_checks"]),
                  flash_max_abs_err=model_flash["flash_max_abs_err"])
    emit("mesh", **{k: v for k, v in result.items()
                    if k not in ("ring", "scorer", "seqparallel", "one", "bootstrap", "model",
                                 "model_flash")})
    return result


class _mesh_devices:
    """Inside: ``parallel.mesh.local_devices`` gives the one device ``n``
    times (the mesh of a card that repeats ``cuda:0``)."""

    def __init__(self, device: str, n: int):
        self.devices = [_repeated_device(device)] * n

    def __enter__(self):
        from detectmateservice_tpu_torch.parallel import mesh as mesh_mod

        self.mesh_mod, self.saved = mesh_mod, mesh_mod.local_devices
        mesh_mod.local_devices = lambda device_type="cuda": list(self.devices)
        return self

    def __exit__(self, *exc):
        self.mesh_mod.local_devices = self.saved
        return False


def _empty_cache(device: str) -> None:
    if device == "cuda":
        torch.cuda.empty_cache()


def mesh_ring(device: str) -> list:
    """(a): ring attention over {seq: 4} and {data: 2, seq: 4} of the
    repeated device, fp32 and bf16, output and gradients, against the
    port's one-device blockwise attention on the same inputs."""
    from detectmateservice_tpu_torch.ops.attention import blockwise_attention
    from detectmateservice_tpu_torch.parallel import make_mesh, ring_attention

    dev = _repeated_device(device)
    b, h, s, d = RING_SHAPE
    block = min(128, s)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        q, k, v, g = (torch.randn(b, h, s, d, generator=gen) for _ in range(4))
        q, k, v = (t.to(dev, dtype).requires_grad_(True) for t in (q, k, v))
        g = g.to(dev)
        valid = (torch.arange(s) < s - RING_PAD_TAIL).expand(b, s).to(dev)

        def run(fn):
            for t in (q, k, v):
                t.grad = None
            out = fn()
            (out.float() * g).sum().backward()
            return [out.detach()] + [t.grad.detach() for t in (q, k, v)]

        want = run(lambda: blockwise_attention(q, k, v, block_size=block,
                                               mask=valid[:, None, None, :]))
        plain_ms = time_ms(lambda: blockwise_attention(q, k, v, block_size=block,
                                                       mask=valid[:, None, None, :]),
                           reps=5, warmup=1) if device == "cuda" else None
        for shape, batch_axis in (({"seq": 4}, None), ({"data": 2, "seq": 4}, "data")):
            mesh = make_mesh(shape, devices=[dev] * int(np.prod(list(shape.values()))))
            got = run(lambda: ring_attention(q, k, v, mesh, kv_valid=valid,
                                             batch_axis=batch_axis))
            errs = [float((x.float() - y.float()).abs().max()) for x, y in zip(got, want)]
            row = dict(dtype=_dtype_name(dtype), mesh=shape, shape=list(RING_SHAPE),
                       pad_tail=RING_PAD_TAIL, max_abs_err=dict(zip(("out", "dq", "dk", "dv"),
                                                                    errs)),
                       tolerance=RING_TOL[dtype],
                       ring_ms=(time_ms(lambda: ring_attention(
                           q, k, v, mesh, kv_valid=valid, batch_axis=batch_axis),
                           reps=5, warmup=1) if device == "cuda" else None),
                       blockwise_ms=plain_ms)
            emit("mesh_ring", **row)
            if not all(np.isfinite(errs)) or max(errs) > RING_TOL[dtype]:
                raise AssertionError(f"ring attention on {shape} ({dtype}) is {errs} from the "
                                     f"blockwise attention, over {RING_TOL[dtype]}")
            rows.append(row)
    return rows


def _mesh_yardstick(det, cfg: dict, tokens: np.ndarray, threshold: float, call: int,
                    **changes) -> tuple:
    """The one-device port detector of ``cfg`` (mesh removed, ``changes``
    applied) on the mesh detector's weights, norm statistics and
    threshold: its scores of ``tokens`` (uncounted) and the detector."""
    one_cfg = {k: v for k, v in cfg.items() if k != "mesh_shape"}
    one_cfg.update(data_use_training=0, score_threshold=threshold, **changes)
    plain = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": one_cfg}})
    plain.load_params(det._sharded.state_dict())
    if det._norm_mu is not None:
        plain._set_norm(det._norm_mu, det._norm_sigma)
    with uncounted(plain):
        scores = np.concatenate([plain.score_tokens(tokens[i:i + call])
                                 for i in range(0, len(tokens), call)])
    return scores, plain


def _decision_gap(mesh_scores: np.ndarray, one_scores: np.ndarray, threshold: float) -> dict:
    """Max |delta| and the decisions that differ, each with its distance
    from the threshold under the one-device scores."""
    flips = np.flatnonzero((mesh_scores > threshold) != (one_scores > threshold))
    return {"max_abs_delta": float(np.abs(mesh_scores - one_scores).max()),
            "flips": int(len(flips)),
            "flip_distances": [float(abs(one_scores[i] - threshold)) for i in flips]}


class _head_shapes:
    """Inside: the (N, C, D, dtype) of every call the scorers make to kernel
    1's wrapper (a CUDA graph's replays launch the shapes of its capture,
    so these are every shape the path launches)."""

    def __enter__(self):
        from detectmateservice_tpu_torch.models import base

        self.base, self.saved, self.shapes = base, base.candidate_lse, set()

        def recording(h, e):
            self.shapes.add((int(h.shape[0]), int(e.shape[0]), int(h.shape[1]), h.dtype))
            return self.saved(h, e)

        base.candidate_lse = recording
        return self

    def __exit__(self, *exc):
        self.base.candidate_lse = self.saved
        return False


def mesh_head_checks(shapes, device: str) -> list:
    """Kernel 1 against its plain version at each shape a mesh path gave it
    (``check_lse`` on seeded inputs, the splits and row tiles of that N)."""
    gen = torch.Generator(device=device).manual_seed(2)
    rows = [check_lse(n, c, d, dtype, gen, device)
            for n, c, d, dtype in sorted(shapes, key=lambda t: (t[0], t[1], t[2], str(t[3])))]
    _empty_cache(device)
    return rows


def mesh_scorer(smi: str, device: str) -> dict:
    """(b): ``examples/mesh_scorer_config.yaml`` (BASELINE config #5) on
    the repeated device: fit on 512 messages, 65,536 through
    ``process_batch``; against the one-device detector on the same weights."""
    changes = dict(MESH_CPU_CHANGES, device="cpu") if device != "cuda" else {}
    cfg = example_block("mesh_scorer_config.yaml", **changes)
    with _head_shapes() as seen:
        det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": cfg}})
        t0 = time.perf_counter()
        det.setup_io()
        setup_s = time.perf_counter() - t0
        dp = int(cfg["mesh_shape"]["data"])
        if (det._device_label != f"mesh(data={dp})" or det._obs_backend != "mesh"
                or det._host_scorer is not None or len(det._warm.rows) != dp):
            raise AssertionError(f"mesh mode: label {det._device_label}, backend "
                                 f"{det._obs_backend}, {len(det._warm.rows)} row warm sets")
        fit_msgs, _ = make_messages(cfg["data_use_training"], anomaly_rate=0.0)
        detect_msgs, anomalies = make_messages(MESH_DETECT, anomaly_rate=0.01, seed=1)

        # the main path: launch counts 0 just before, read just after
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        assert det.process_batch(fit_msgs) == []
        det._finish_fit(wait=True)
        fit_s = time.perf_counter() - t0
        alerts, detect_s = _stream(det, detect_msgs, MESH_CALL)
        counts = read_launches()
        variants = read_variants()["candidate_lse"]
        graph = replay_delta(det, replays0)

    # kernel 1 once per data row in every calibration chunk and device batch
    n_fit = cfg["data_use_training"]
    n_cal = (max(16, n_fit // 5) if cfg.get("score_norm") == "position" and n_fit >= 64
             else n_fit)
    calib_chunks = -(-n_cal // min(32, cfg["max_batch"]))   # the train bucket
    device_batches = det.path_counts["device"]
    expected = (calib_chunks + device_batches) * dp
    threshold = det._threshold
    by_id = _alerts_by_id(alerts, threshold)
    tokens, ok = det._featurize_raw_batch(detect_msgs)
    mesh_scores = det.score_tokens(tokens)
    one_scores, one = _mesh_yardstick(det, cfg, tokens, threshold, MESH_CALL)
    gap = _decision_gap(mesh_scores, one_scores, threshold)
    checks = replay_vs_eager(det, "mesh_scorer", "fitted", [MESH_CALL],
                             detect_msgs) if device == "cuda" else []
    head_rows = mesh_head_checks(seen.shapes, device)
    result = dict(
        card=smi, config="examples/mesh_scorer_config.yaml", mesh=det._device_label,
        shards_of=str(det._device), setup_s=setup_s, fit_s=fit_s, detect_s=detect_s,
        lines_per_s=MESH_DETECT / detect_s, n_detect=MESH_DETECT, call_size=MESH_CALL,
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies),
        recall=len(anomalies & set(by_id)) / max(1, len(anomalies)),
        launches=counts["candidate_lse"], expected_launches=expected,
        calibration_chunks=calib_chunks, device_batches=device_batches, launch_counts=counts,
        variants=variants, replayed_launches=graph, vs_one_device=gap, tolerance=MESH_TOL,
        head_checks=head_rows,
        alerts_match=sorted(by_id) == sorted(str(i) for i in np.flatnonzero(
            ok & (mesh_scores > threshold))),
        captures=det._warm.captures, replay_vs_eager=checks)
    emit("mesh_scorer", **result)
    failures = []
    if counts["candidate_lse"] != expected or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}, expected {expected} of kernel 1 "
                        f"(({calib_chunks} + {device_batches}) x {dp} rows)")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"], "mesh")
            check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "mesh")
        except AssertionError as exc:
            failures.append(str(exc))
    if not gap["max_abs_delta"] <= MESH_TOL:
        failures.append(f"scores {gap['max_abs_delta']} from one device, over {MESH_TOL}")
    if gap["flip_distances"] and max(gap["flip_distances"]) >= 1e-2:
        failures.append(f"decisions apart from one device beyond 1e-2: {gap}")
    failures += [f"kernel 1 disagrees with its plain version: {r}"
                 for r in head_rows if not r["ok"]]
    if not np.isfinite(threshold) or not np.isfinite(mesh_scores).all():
        failures.append(f"threshold {threshold} or scores not finite")
    if not result["alerts_match"]:
        failures.append("the stream's alerts are not the mesh's own decisions")
    del one
    if failures:
        raise AssertionError(f"phase mesh (b) failed: {failures}")
    return result


def mesh_seqparallel(smi: str, device: str) -> dict:
    """(c): ``examples/seqparallel_config.yaml`` (``attn_impl: ring`` over
    {data: 2, seq: 4}, depth cut to ``MESH_SEQ_CUTS``) on the repeated
    device: the fit, then
    1,024 messages; against the one-device detector with ``attn_impl:
    flash`` on the same weights."""
    changes = dict(MESH_SEQ_CPU_CHANGES, device="cpu") if device != "cuda" else {}
    cfg = example_block("seqparallel_config.yaml", **dict(MESH_SEQ_CUTS, **changes))
    with _head_shapes() as seen:
        det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": cfg}})
        t0 = time.perf_counter()
        det.setup_io()
        setup_s = time.perf_counter() - t0
        dp = int(cfg["mesh_shape"]["data"])
        losses = []
        train_step = det._sharded.train_step

        def recording(*args, **kwargs):
            loss = train_step(*args, **kwargs)
            losses.append(loss)
            return loss

        det._sharded.train_step = recording
        fit_msgs, _ = make_messages(cfg["data_use_training"], anomaly_rate=0.0)
        detect_msgs, anomalies = make_messages(MESH_SEQ_DETECT, anomaly_rate=0.01, seed=1)

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        assert det.process_batch(fit_msgs) == []
        det._finish_fit(wait=True)
        fit_s = time.perf_counter() - t0
        alerts, detect_s = _stream(det, detect_msgs, MESH_SEQ_CALL)
        counts = read_launches()
        variants = read_variants()["candidate_lse"]
        graph = replay_delta(det, replays0)

    calib_chunks = -(-cfg["data_use_training"] // min(32, cfg["max_batch"]))
    device_batches = det.path_counts["device"]
    expected = (calib_chunks + device_batches) * dp
    threshold = det._threshold
    by_id = _alerts_by_id(alerts, threshold)
    tokens, _ = det._featurize_raw_batch(detect_msgs)
    mesh_scores = np.concatenate([det.score_tokens(tokens[i:i + MESH_SEQ_CALL])
                                  for i in range(0, len(tokens), MESH_SEQ_CALL)])
    one_scores, one = _mesh_yardstick(det, cfg, tokens, threshold, MESH_SEQ_CALL,
                                      attn_impl="flash")
    gap = _decision_gap(mesh_scores, one_scores, threshold)
    head_rows = mesh_head_checks(seen.shapes, device)
    head = max(1, min(8, len(losses) // 4))
    result = dict(
        card=smi, config="examples/seqparallel_config.yaml", mesh=det._device_label,
        cuts=dict(MESH_SEQ_CUTS), setup_s=setup_s, fit_s=fit_s, train_steps=len(losses),
        loss_first=float(np.mean(losses[:head])), loss_last=float(np.mean(losses[-head:])),
        detect_s=detect_s, lines_per_s=MESH_SEQ_DETECT / detect_s, n_detect=MESH_SEQ_DETECT,
        threshold=threshold, alerts=len(by_id), anomalies=len(anomalies),
        recall=len(anomalies & set(by_id)) / max(1, len(anomalies)),
        launches=counts["candidate_lse"], expected_launches=expected,
        calibration_chunks=calib_chunks, device_batches=device_batches, launch_counts=counts,
        variants=variants, replayed_launches=graph, vs_one_device_flash=gap,
        tolerance=MESH_SEQ_TOL, head_checks=head_rows,
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                      else None))
    emit("mesh_seqparallel", **result)
    failures = []
    if counts["candidate_lse"] != expected or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}, expected {expected} of kernel 1 and no flash "
                        f"kernel (the ring runs in torch ops)")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d256_", counts["candidate_lse"],
                                "mesh seqparallel")
            check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "mesh seqparallel")
        except AssertionError as exc:
            failures.append(str(exc))
    if not gap["max_abs_delta"] <= MESH_SEQ_TOL:
        failures.append(f"scores {gap['max_abs_delta']} from the flash detector, over "
                        f"{MESH_SEQ_TOL}")
    if gap["flip_distances"] and max(gap["flip_distances"]) >= 1e-2:
        failures.append(f"decisions apart from the flash detector beyond 1e-2: {gap}")
    failures += [f"kernel 1 disagrees with its plain version: {r}"
                 for r in head_rows if not r["ok"]]
    if not losses or not result["loss_last"] < result["loss_first"]:
        failures.append(f"the fit's loss did not fall: {losses[:3]} ... {losses[-3:]}")
    del one
    if failures:
        raise AssertionError(f"phase mesh (c) failed: {failures}")
    return result


class _flash_shapes:
    """Inside: the (B, H, S, T, D, dtype, backward) of every call the
    models make to the flash attention (``ops/attention``'s binding of
    ``flash.flash_attention``); backward when its q takes a gradient."""

    def __enter__(self):
        from detectmateservice_tpu_torch.ops import attention as attention_mod

        self.mod, self.saved, self.shapes = attention_mod, attention_mod.flash_attention, set()

        def recording(q, k, v, key_mask=None):
            b, h, s, d = q.shape
            self.shapes.add((int(b), int(h), int(s), int(k.shape[2]), int(d), q.dtype,
                             bool(q.requires_grad and torch.is_grad_enabled())))
            return self.saved(q, k, v, key_mask)

        attention_mod.flash_attention = recording
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.saved
        return False


def mesh_flash_checks(shapes) -> list:
    """The three flash kernels against their plain versions at each shape
    a model shard gave them: q, k and v cut as a shard cuts them from the
    gathered qkv (``"shard"``), keys masked as tokenized lines are."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for b, h, s, t, d, dtype, backward in sorted(shapes, key=str):
        results = flash_case_results((b, h, s, t, d, dtype, "rows", backward, "shard"), gen)
        ok = all(r[0] for r in results.values())
        row = dict(shape=[b, h, s, t, d], dtype=_dtype_name(dtype), backward=backward, ok=ok,
                   variants={kind: flash.variant(kind, dtype, d)
                             for kind in ("forward", "dq", "dkv")},
                   **{name: {"max_abs_err": r[1], "tol": r[2], "ok": r[0]}
                      for name, r in results.items()})
        emit("mesh_flash_check", **row)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def mesh_shape_timings(head_shapes, flash_shapes) -> list:
    """Kernel 1 at the largest N a split path gave it, each flash kernel at
    the largest batch of its kind, against the plain version and the
    library call on the same inputs (median of ``MESH_MODEL_REPS``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    if head_shapes:
        n, c, d, dtype = max(head_shapes, key=lambda t: t[0])
        h, e = _lse_inputs(n, c, d, dtype, gen, "cuda")
        bound_ms, bound_by = lse_bound(n, c, d, dtype)
        ms = time_ms(lambda: scorehead.candidate_lse(h, e), reps=MESH_MODEL_REPS)
        rows.append(dict(kernel="candidate_lse", shape=[n, c, d], ms=ms,
                         plain_ms=time_ms(lambda: lse_plain(h, e), reps=MESH_MODEL_REPS,
                                          warmup=1),
                         library_ms=time_ms(lambda: lse_library(h, e), reps=MESH_MODEL_REPS,
                                            warmup=1),
                         bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                         variant=scorehead.variant(n, c, d, dtype)))
        del h, e
    for backward in (False, True):
        picked = [s for s in flash_shapes if s[6] == backward]
        if not picked:
            continue
        b, hh, s, t, d, dtype, _ = max(picked, key=lambda x: x[0])
        q, k, v, g, mask = _flash_inputs(b, hh, s, t, d, dtype, "rows", gen, "shard")
        bias = flash.key_bias(mask)[:, None, None, :].to(dtype).expand(b, hh, s, t)
        kinds = {"flash_forward": (
            lambda: flash.flash_forward(q, k, v, mask, want_lse=backward),
            lambda: flash.flash_forward_reference(q, k, v, mask),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), "forward")}
        if backward:
            out, lse = flash.flash_forward(q, k, v, mask, want_lse=True)
            delta = flash.flash_delta(g, out)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias)

            def sdpa_backward():
                torch.autograd.grad(sdpa_out, (qg, kg, vg), g, retain_graph=True)

            kinds = {"flash_dq": (lambda: flash.flash_dq(q, k, v, mask, g, lse, delta),
                                  lambda: flash.flash_dq_reference(q, k, v, mask, g, lse, delta),
                                  sdpa_backward, "dq"),
                     "flash_dkv": (lambda: flash.flash_dkv(q, k, v, mask, g, lse, delta),
                                   lambda: flash.flash_dkv_reference(q, k, v, mask, g, lse,
                                                                     delta),
                                   sdpa_backward, "dkv")}
        for name, (kernel, plain, library, kind) in kinds.items():
            ms = time_ms(kernel, reps=MESH_MODEL_REPS)
            bound_ms, bound_by, _ = flash_bound(kind, b, hh, s, t, d, dtype,
                                                with_lse=backward)
            rows.append(dict(kernel=name, shape=[b, hh, s, t, d], ms=ms,
                             plain_ms=time_ms(plain, reps=MESH_MODEL_REPS, warmup=1),
                             library_ms=time_ms(library, reps=MESH_MODEL_REPS),
                             bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                             variant=flash.variant(kind, dtype, d)))
        del q, k, v, g, mask, bias, kinds
        torch.cuda.empty_cache()
    for row in rows:
        emit("mesh_model_timing", **row)
    return rows


def _reordered_state(state: dict, cfg) -> dict:
    """The same function in real arithmetic with every row-parallel sum in
    another order: the heads reversed in qkv's three thirds and in proj's
    inputs, the MLP's hidden units reversed."""
    d, h = cfg.dim, cfg.heads
    heads = torch.arange(d).reshape(h, d // h).flip(0).reshape(-1)
    thirds = torch.cat([heads + t * d for t in range(3)])
    out = dict(state)
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        out[p + "qkv.weight"] = state[p + "qkv.weight"][thirds.to(state[p + "qkv.weight"].device)]
        out[p + "qkv.bias"] = state[p + "qkv.bias"][thirds.to(state[p + "qkv.bias"].device)]
        out[p + "proj.weight"] = state[p + "proj.weight"][:, heads.to(
            state[p + "proj.weight"].device)]
        out[p + "mlp_in.weight"] = state[p + "mlp_in.weight"].flip(0)
        out[p + "mlp_in.bias"] = state[p + "mlp_in.bias"].flip(0)
        out[p + "mlp_out.weight"] = state[p + "mlp_out.weight"].flip(1)
    return out


def _swapped_state(state: dict, cfg) -> dict:
    """A fault: proj's two input halves swapped in every block, so the
    first half of the heads meets the second half's weights."""
    out = dict(state)
    half = cfg.dim // 2
    for i in range(cfg.depth):
        w = state[f"blocks.{i}.proj.weight"]
        out[f"blocks.{i}.proj.weight"] = torch.cat([w[:, half:], w[:, :half]], dim=1)
    return out


def mesh_split_controls(det, tokens: np.ndarray, call: int) -> dict:
    """Op by op on the mesh detector's weights and norm statistics, each
    model scoring ``tokens`` in calls of ``call`` rows the way the detector
    serves them (positional z-scores once calibrated); max |delta| against
    the one-device model of the same dtype:

    * ``fp32``: the split with an fp32 scorer, which must give the
      one-device function (``MESH_TOL``);
    * ``split``: the split at the path's dtype;
    * ``reordered``: one device against itself with its row-parallel sums
      in another order (``_reordered_state``), the dtype's noise floor,
      which a bound on the split must pass;
    * ``swapped``: the fault ``_swapped_state``, which it must fail.

    Launches made here are outside the path's counts."""
    from detectmateservice_tpu_torch.parallel import ShardedScorer

    sharded = det._sharded
    lead = sharded.mesh.lead
    state = sharded.state_dict()
    kind = det._serve_kind()
    norm = (det._norm_mu, det._norm_sigma) if kind == "normscore" else None

    def scores(fn) -> np.ndarray:
        return np.concatenate([fn(torch.from_numpy(np.ascontiguousarray(
            tokens[i:i + call])).to(lead)).cpu().numpy() for i in range(0, len(tokens), call)])

    def one_device(scorer, weights: dict) -> np.ndarray:
        model = scorer.init_model(lead)
        model.load_state_dict(weights)
        if norm is None:
            return scores(lambda part: scorer.score(model, part))
        mu, sigma = (torch.from_numpy(x).to(lead) for x in norm)
        return scores(lambda part: scorer.normscore(model, part, mu, sigma))

    def gap(got: np.ndarray, want: np.ndarray) -> float:
        return float(np.abs(got - want).max())

    fp32 = type(sharded.scorer)(dataclasses.replace(sharded.scorer.config, dtype=torch.float32))
    split32 = ShardedScorer(fp32, mesh=sharded.mesh, ledger=device_obs.CompileLedger())
    split32.install_params(state)
    if norm is not None:
        split32.set_norm(*norm)
    out = {"kind": kind, "rows": len(tokens),
           "fp32": gap(scores(lambda part: split32.eager(kind, part)), one_device(fp32, state))}
    del split32
    scorer, cfg = sharded.scorer, sharded.scorer.config
    one = one_device(scorer, state)
    out.update(split=gap(scores(lambda part: sharded.eager(kind, part)), one),
               reordered=gap(one_device(scorer, _reordered_state(state, cfg)), one),
               swapped=gap(one_device(scorer, _swapped_state(state, cfg)), one))
    _empty_cache(lead.type)
    return out


def _mesh_model_path(label: str, smi: str, device: str, cfg: dict, source: str,
                     n_detect: int, call: int, tol: float) -> dict:
    """(f) or (g): a LogBERT detector on a mesh whose ``model`` axis
    computes (the rows hold the rules' slices), through its fit and a
    stream, against the one-device detector on its weights; kernel 1 (and
    the flash kernels) counted over the path and held against their plain
    versions at each shape it gave them; the split leaves' bytes per model
    shard beside 1/m of the whole; the split in fp32 against one device
    within ``MESH_TOL``, and ``tol``, the bound on the scores' gap at the
    path's own dtype, passing one device's gap to itself with its sums
    reordered and failing a fault (``mesh_split_controls``, on one call's
    rows). Each part's seconds go into ``parts_s``."""
    parts_s = {}
    t_part = time.perf_counter()
    with _head_shapes() as seen, _flash_shapes() as seen_flash:
        det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": cfg}})
        t0 = time.perf_counter()
        det.setup_io()
        setup_s = time.perf_counter() - t0
        sharded = det._sharded
        dp, m = int(cfg["mesh_shape"]["data"]), int(cfg["mesh_shape"]["model"])
        if not sharded.split or sharded.model_parallelism != m or len(det._warm.rows) != dp:
            raise AssertionError(f"{label}: the mesh {det._device_label} does not split over "
                                 f"model (split {sharded.split}, {len(det._warm.rows)} rows)")
        steps = []
        train_step = sharded.train_step

        def recording(*args, **kwargs):
            loss = train_step(*args, **kwargs)
            steps.append(loss)
            return loss

        sharded.train_step = recording
        fit_msgs, _ = make_messages(cfg["data_use_training"], anomaly_rate=0.0)
        detect_msgs, anomalies = make_messages(n_detect, anomaly_rate=0.01, seed=1)

        # the main path: launch counts 0 just before, read just after
        reset_launches()
        replays0 = replayed(det)
        t0 = time.perf_counter()
        assert det.process_batch(fit_msgs) == []
        det._finish_fit(wait=True)
        fit_s = time.perf_counter() - t0
        alerts, detect_s = _stream(det, detect_msgs, call)
        counts = read_launches()
        variants = read_variants()
        graph = replay_delta(det, replays0)
        sharded.train_step = train_step
    parts_s["path"], t_part = time.perf_counter() - t_part, time.perf_counter()

    n_fit = cfg["data_use_training"]
    n_cal = (max(16, n_fit // 5) if cfg.get("score_norm") == "position" and n_fit >= 64
             else n_fit)
    calib_chunks = -(-n_cal // min(32, cfg["max_batch"]))     # the train bucket
    device_batches = det.path_counts["device"]
    scored_rows = (calib_chunks + device_batches) * dp
    expected = {"candidate_lse": scored_rows}
    flash_path = cfg.get("attn_impl") == "flash"
    if flash_path:
        # each shard's attention, in every layer, of every row's call
        per_call = int(cfg["depth"]) * m
        expected.update(flash_forward=(scored_rows + len(steps) * dp) * per_call,
                        flash_dq=len(steps) * dp * per_call,
                        flash_dkv=len(steps) * dp * per_call)
    threshold = det._threshold
    by_id = _alerts_by_id(alerts, threshold)
    tokens, ok = det._featurize_raw_batch(detect_msgs)
    mesh_scores = np.concatenate([det.score_tokens(tokens[i:i + call])
                                  for i in range(0, len(tokens), call)])
    one_scores, one = _mesh_yardstick(det, cfg, tokens, threshold, call)
    gap = _decision_gap(mesh_scores, one_scores, threshold)
    del one
    parts_s["yardstick"], t_part = time.perf_counter() - t_part, time.perf_counter()
    controls = mesh_split_controls(det, tokens[:call], call)
    parts_s["controls"], t_part = time.perf_counter() - t_part, time.perf_counter()
    held = sharded.shard_bytes()
    head_rows = mesh_head_checks(seen.shapes, device)
    on_card = device == "cuda"
    flash_rows = mesh_flash_checks(seen_flash.shapes) if on_card else []
    parts_s["kernel_checks"], t_part = time.perf_counter() - t_part, time.perf_counter()
    timings = mesh_shape_timings(seen.shapes, seen_flash.shapes) if on_card else []
    parts_s["kernel_timings"] = time.perf_counter() - t_part
    head = max(1, min(8, len(steps) // 4))
    result = dict(
        card=smi, config=source, mesh=det._device_label, setup_s=setup_s,
        fit_s=fit_s, train_steps=len(steps),
        loss_first=float(np.mean(steps[:head])) if steps else None,
        loss_last=float(np.mean(steps[-head:])) if steps else None,
        detect_s=detect_s, lines_per_s=n_detect / detect_s, n_detect=n_detect,
        call_size=call, threshold=threshold, alerts=len(by_id), anomalies=len(anomalies),
        recall=len(anomalies & set(by_id)) / max(1, len(anomalies)),
        launches=counts["candidate_lse"], launch_counts=counts, expected_launches=expected,
        calibration_chunks=calib_chunks, device_batches=device_batches,
        variants=variants, replayed_launches=graph, vs_one_device=gap, tolerance=tol,
        controls=controls, fp32_tolerance=MESH_TOL, parts_s=parts_s,
        split_bytes={"whole": held["whole"], "one_mth": held["whole"] / m,
                     "per_shard": held["per_shard"], "leaves": held["split_leaves"]},
        head_checks=head_rows, flash_checks=flash_rows,
        head_shapes=sorted([n, c, d, _dtype_name(t)] for n, c, d, t in seen.shapes),
        flash_shapes=sorted([b, h, s, t, d, _dtype_name(dt), bw]
                            for b, h, s, t, d, dt, bw in seen_flash.shapes),
        flash_max_abs_err=max((r[k]["max_abs_err"] for r in flash_rows
                               for k in ("out", "dq", "dk", "dv") if k in r), default=0.0),
        timings=timings,
        alerts_match=sorted(by_id) == sorted(str(i) for i in np.flatnonzero(
            ok & (mesh_scores > threshold))))
    emit(label, **result)
    failures = []
    if counts["candidate_lse"] != expected["candidate_lse"] or (
            not flash_path and (counts["flash_forward"] or counts["flash_dq"]
                                or counts["flash_dkv"])):
        failures.append(f"launches {counts}, expected {expected}")
    if on_card:
        if flash_path and {k: counts[k] for k in expected} != expected:
            failures.append(f"launches {counts}, expected {expected}")
        try:
            check_head_variants(variants["candidate_lse"], f"wgmma_tma_d{cfg['dim']}_",
                                counts["candidate_lse"], label)
            replays_want = {"candidate_lse": counts["candidate_lse"]}
            if flash_path:
                replays_want["flash_forward"] = scored_rows * int(cfg["depth"]) * m
            check_replays(graph, replays_want, label)
        except AssertionError as exc:
            failures.append(str(exc))
        if flash_path and (not flash_rows or any(not r["ok"] for r in flash_rows)
                           or {r["backward"] for r in flash_rows} != {False, True}):
            failures.append(f"the flash kernels at the shards' shapes: {flash_rows}")
        if flash_path and any(not v.startswith("wgmma_tma") for name in
                              ("flash_forward", "flash_dq", "flash_dkv")
                              for v in variants[name]):
            failures.append(f"a bf16 flash launch took another variant: {variants}")
    if not gap["max_abs_delta"] <= tol:
        failures.append(f"scores {gap['max_abs_delta']} from one device, over {tol}")
    if not controls["fp32"] <= MESH_TOL:
        failures.append(f"the split in fp32 is {controls['fp32']} from one device, over "
                        f"{MESH_TOL}")
    if not controls["reordered"] <= tol:
        failures.append(f"one device with its sums reordered is {controls['reordered']} from "
                        f"itself, over the bound {tol}")
    if not controls["swapped"] > tol:
        failures.append(f"the bound {tol} passes a fault (proj's head halves swapped: "
                        f"{controls['swapped']})")
    if gap["flip_distances"] and max(gap["flip_distances"]) >= 1e-2:
        failures.append(f"decisions apart from one device beyond 1e-2: {gap}")
    if not head_rows or any(not r["ok"] for r in head_rows):
        failures.append(f"kernel 1 against its plain version: {head_rows}")
    if any(h * m != held["whole"] for row in held["per_shard"] for h in row):
        failures.append(f"a model shard does not hold 1/{m} of the split leaves: {held}")
    if not np.isfinite(threshold) or not np.isfinite(mesh_scores).all():
        failures.append(f"threshold {threshold} or scores not finite")
    if not result["alerts_match"]:
        failures.append("the stream's alerts are not the mesh's own decisions")
    if not steps or not result["loss_last"] < result["loss_first"]:
        failures.append(f"the fit's loss did not fall: {steps[:3]} ... {steps[-3:]}")
    if failures:
        raise AssertionError(f"phase mesh ({label}) failed: {failures}")
    return result


def mesh_model(smi: str, device: str) -> dict:
    """(f): ``examples/mesh_scorer_config.yaml``'s widths on {data: 4,
    model: 2}: every row's LogBERT over its two model shards, kernel 1 once
    per row on the row's first device."""
    changes = dict(MESH_MODEL_CPU_CHANGES, device="cpu") if device != "cuda" else {}
    cfg = example_block("mesh_scorer_config.yaml", mesh_shape=dict(MESH_MODEL_SHAPE), **changes)
    source = "examples/mesh_scorer_config.yaml, mesh_shape " + json.dumps(MESH_MODEL_SHAPE)
    return _mesh_model_path("mesh_model", smi, device, cfg, source, MESH_MODEL_DETECT,
                            MESH_MODEL_CALL, MESH_MODEL_TOL)


def mesh_model_flash(smi: str, device: str) -> dict:
    """(g): ``examples/seqparallel_config.yaml``'s widths with ``attn_impl:
    flash`` on {data: 2, model: 2}: the flash forward, dQ and dK/dV kernels
    at two heads per shard, kernel 1 once per row."""
    changes = dict(MESH_MODEL_FLASH_CPU_CHANGES, device="cpu") if device != "cuda" else {}
    cfg = example_block("seqparallel_config.yaml", attn_impl="flash",
                        mesh_shape=dict(MESH_MODEL_FLASH_SHAPE), **changes)
    source = ("examples/seqparallel_config.yaml, attn_impl flash, mesh_shape "
              + json.dumps(MESH_MODEL_FLASH_SHAPE))
    return _mesh_model_path("mesh_model_flash", smi, device, cfg, source,
                            MESH_MODEL_FLASH_DETECT, MESH_MODEL_FLASH_CALL, MESH_SEQ_TOL)


def mesh_of_one(device: str) -> dict:
    """(d): ``{data: 1}`` on the device: the mesh detector and the one-device
    detector of the same config fit on the same messages and must score
    bit-equal."""
    changes = dict(MESH_CPU_CHANGES, device="cpu") if device != "cuda" else {}
    cfg = example_block("mesh_scorer_config.yaml", **changes)
    fit_msgs, _ = make_messages(cfg["data_use_training"], anomaly_rate=0.0)
    detect_msgs, _ = make_messages(MESH_ONE_DETECT, anomaly_rate=0.01, seed=1)
    dets = {}
    for name, shape in (("mesh", {"data": 1}), ("one", None)):
        block = dict(cfg, mesh_shape=shape, async_fit=False)
        det = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": block}})
        det.setup_io()
        with uncounted(det):
            assert det.process_batch(fit_msgs) == []
        dets[name] = det
    tokens, _ = dets["one"]._featurize_raw_batch(detect_msgs)
    with uncounted(dets["one"]):
        want = dets["one"].score_tokens(tokens)
    got = dets["mesh"].score_tokens(tokens)
    result = dict(mesh=dets["mesh"]._device_label, rows=len(tokens),
                  bit_equal=bool(np.array_equal(got, want)),
                  threshold_equal=dets["mesh"]._threshold == dets["one"]._threshold,
                  max_abs_diff=float(np.abs(got - want).max()))
    emit("mesh_of_one", **result)
    if not (result["bit_equal"] and result["threshold_equal"]):
        raise AssertionError(f"a mesh of one is not the one device: {result}")
    return result


def mesh_bootstrap(device: str) -> dict:
    """(e): a process group of one (NCCL on the card, gloo on the CPU) over
    a localhost coordinator, in a subprocess: one all_reduce,
    ``process_info``, the group destroyed, exit 0 within 120 s."""
    code = (
        "import json, sys, torch\n"
        "import torch.distributed as dist\n"
        "from detectmateservice_tpu_torch.parallel import distributed\n"
        "class S:\n"
        "    coordinator_address = '127.0.0.1:' + sys.argv[1]\n"
        "    num_processes = 1\n"
        "    process_id = 0\n"
        "assert distributed.initialize_from_settings(S(), device_type=sys.argv[2])\n"
        "dev = 'cuda:0' if sys.argv[2] == 'cuda' else 'cpu'\n"
        "t = torch.full((4,), 2.0, device=dev)\n"
        "dist.all_reduce(t)\n"
        "ok = float(t.sum()) == 8.0\n"
        "info = dict(distributed.process_info(), backend=dist.get_backend(), all_reduce=ok)\n"
        "dist.destroy_process_group()\n"
        "print(json.dumps(info), flush=True)\n")
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, str(_free_port()), device],
                          cwd=root, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(root)))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    info = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    result = dict(returncode=proc.returncode, seconds=seconds, **info)
    emit("mesh_bootstrap", **result)
    want_backend = "nccl" if device == "cuda" else "gloo"
    if proc.returncode != 0 or not info.get("all_reduce") or info.get("backend") != want_backend \
            or info.get("process_count") != 1 or not info.get("initialized"):
        raise AssertionError(f"the process group of one failed: {result} "
                             f"{proc.stderr[-2000:]}")
    return result


def phase_frames_profile(smi: str, device: str = "cuda") -> dict:
    """A 1 s capture over phase 7b's path, taken last: a fresh detector of
    phase 7b's configuration through ``bench_torch.drive`` (fit, warm-up,
    the timed loop), then ``profile_frames``. Last, because a finished
    capture may leave a cost in the process (§7 of PERF.md): the phases
    with a release-wait bound run before it, and phase ``trace``'s own
    capture is the process's first."""
    det = bench_torch.build_detector("cuda:0" if device == "cuda" else device, SCORER_CONFIG)
    det.setup_io()
    msgs, _ = make_messages(N_DETECT, anomaly_rate=0.01, seed=1)
    tmp = Path(tempfile.mkdtemp(prefix="dmprof", dir="/tmp"))
    try:
        with uncounted(det):
            bench_torch.drive(det, N_DETECT)
        result = dict(card=smi, **profile_frames(det, msgs, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("frames_profile", **result)
    return result


def profile_frames(det, msgs, base_dir: Path) -> dict:
    """A 1 s ``ProfileManager`` capture (the API, no HTTP) over the
    wire-frame path of phase 7b: ``process_frames`` over the same frames in
    calls of 32, again and again while the capture runs, outside the
    path's launch counts. Its device busy share and idle gaps."""
    frames = [pack_batch(msgs[i:i + bench_torch.FRAME_N])
              for i in range(0, len(msgs), bench_torch.FRAME_N)]
    per_call = max(1, det.config.max_batch // bench_torch.FRAME_N)
    if not profiling.PROFILER.wait(60):
        raise AssertionError("a profiler capture is still running")
    n_msgs = 0
    with uncounted(det):
        profiling.PROFILER.start(str(base_dir), TRACE_PROFILE_S, 2, device=det.device)
        t0 = time.perf_counter()
        while profiling.PROFILER.status()["running"]:
            for start in range(0, len(frames), per_call):
                n_msgs += det.process_frames(frames[start:start + per_call])[1]
            det.flush()
        elapsed = time.perf_counter() - t0
        profiling.PROFILER.wait(60)
    last = profiling.PROFILER.status()["last"]
    if last["state"] != "done":
        raise AssertionError(f"the 7b capture failed: {last}")
    events = capture_events(last)
    result = {"capture": {k: last.get(k) for k in ("activities", "all_threads", "trace_bytes",
                                                   "transitions_monotonic", "export_s")},
              "lines_per_s": n_msgs / elapsed, "events": len(events),
              "lse_wgmma": kernel_in_trace(events, "lse_wgmma_kernel")}
    if det.device.type == "cuda":
        result["device"] = device_busy(events)
    return result


def _http_bytes(method: str, port: int, path: str, timeout: float = 60.0) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=b"{}" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _histogram(text: str, name: str, component_id: str) -> dict:
    """Buckets (upper bound → cumulative count) and count of one histogram
    series in a Prometheus exposition."""
    buckets, count = {}, 0.0
    for labels, value in metric_samples(text, name + "_bucket", component_id).items():
        le = labels.split('le="')[1].split('"')[0]
        buckets[float("inf") if le == "+Inf" else float(le)] = value
    for value in metric_samples(text, name + "_count", component_id).values():
        count += value
    return {"buckets": dict(sorted(buckets.items())), "count": count}


def histogram_quantile(hist: dict, q: float) -> float:
    """The ``q`` quantile of a cumulative histogram, linear inside its
    bucket (as Prometheus's ``histogram_quantile``)."""
    total = hist["count"]
    if not total:
        return float("nan")
    rank, lower, below = q * total, 0.0, 0.0
    for upper, cumulative in hist["buckets"].items():
        if cumulative >= rank:
            if upper == float("inf"):
                return lower
            return lower + (upper - lower) * (rank - below) / max(cumulative - below, 1e-12)
        lower, below = upper, cumulative
    return lower


def trace_settings(tmp: Path, device: str) -> tuple:
    """The pipeline's three settings: ``relay`` (core, micro-batching, the
    origin of every trace) → ``detector`` (``coalesce_files``: the scorer
    example, with ``trace_terminal``) → ``sink`` (core, ``trace_terminal``,
    hosting the telemetry collector, which keeps every assembled trace: a
    ratio of 1 instead of 0.05, so that the exemplar check finds its trace)
    → this script's alert socket. All three trace; relay and detector
    export spans. Relay and sink run as CLI processes of their own (their
    settings are returned as mappings), each stage in its own interpreter as
    a deployment runs them, and flow-control their outputs (``block``) so a
    slower downstream throttles its upstream instead of losing frames."""
    telemetry = f"ipc://{tmp}/telemetry.ipc"
    detector = ServiceSettings.from_yaml(str(coalesce_files(tmp, device, settings_changes=dict(
        engine_trace=True, trace_terminal=True, trace_stage="detector",
        telemetry_addr=telemetry, profile_dir=str(tmp / "profiles"),
        profile_max_captures=TRACE_MAX_CAPTURES))))
    common = dict(component_type="core", log_to_file=False, log_level="WARNING",
                  engine_trace=True, engine_buffer_size=4096, out_backpressure="block")
    relay = dict(common, component_name="relay", trace_stage="relay",
                 engine_addr=f"ipc://{tmp}/relay.ipc", out_addr=[detector.engine_addr],
                 telemetry_addr=telemetry, engine_batch_size=TRACE_RELAY_BATCH)
    sink = dict(common, component_name="sink", trace_stage="sink", trace_terminal=True,
                engine_addr=detector.out_addr[0], out_addr=[f"ipc://{tmp}/alerts.ipc"],
                telemetry_collector=True, telemetry_collector_addr=telemetry,
                telemetry_sample_healthy_ratio=1.0)
    return relay, detector, sink


class _CliStage:
    """A port Service run by the CLI in a process of its own, on a free
    HTTP port."""

    def __init__(self, tmp: Path, name: str, settings: dict):
        import yaml

        self.name, self.port = name, _free_port()
        path = tmp / f"{name}_settings.yaml"
        path.write_text(yaml.safe_dump(dict(settings, http_port=self.port)))
        self.settings = ServiceSettings.from_yaml(str(path))
        self.err = tmp / f"{name}.err"
        with open(tmp / f"{name}.out", "wb") as out, open(self.err, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "detectmateservice_tpu_torch.cli", "--settings",
                 str(path)], stdout=out, stderr=err,
                env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))

    def running(self) -> bool:
        if self.proc.poll() is not None:
            raise AssertionError(f"{self.name}: {self.err.read_text()[-2000:]}")
        try:
            return _http("GET", self.port, "/admin/status", 2)[1]["status"]["running"]
        except OSError:
            return False

    def stop(self) -> int:
        try:
            if self.proc.poll() is None:
                _http_any("POST", self.port, "/admin/shutdown")
            return self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(10)


def phase_trace(smi: str, lse_ms=None, device: str = "cuda") -> dict:
    """The observability plane on the card: a traced three-stage pipeline
    of port Services (the detector in this process, relay and sink as CLI
    processes), the flight recorder, the pipeline series, the SLO trackers,
    the telemetry collector and a profiler capture of the detector's
    process during the stream. ``lse_ms`` is kernel 1's CUDA-event time at
    N 1,024 (phase 4), printed beside its time in the capture."""
    tmp = Path(tempfile.mkdtemp(prefix="dmtr", dir="/tmp"))
    try:
        return trace_pipeline(tmp, smi, lse_ms, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trace_pipeline(tmp: Path, smi: str, lse_ms, device: str) -> dict:
    relay_s, det_s, sink_s = trace_settings(tmp, device)
    fit_msgs, _ = make_messages(512, anomaly_rate=0.0)
    detect_msgs, anomalies = make_messages(TRACE_DETECT, anomaly_rate=0.01, seed=1)
    lone = _lone_anomalies(TRACE_LONE, "lone")
    factory = ZmqPairSocketFactory()
    alerts = factory.create(sink_s["out_addr"][0])
    stages = [_CliStage(tmp, "sink", sink_s)]
    try:
        detector = Service(det_s)
        t0 = time.perf_counter()
        detector.setup_io()
        setup_s = time.perf_counter() - t0
        stages.append(_CliStage(tmp, "relay", relay_s))
        return _trace_stream(tmp, smi, lse_ms, device, detector, setup_s, stages, alerts,
                             factory, fit_msgs, detect_msgs, anomalies, lone)
    finally:
        codes = [stage.stop() for stage in stages]
        alerts.close()
        if any(codes):
            raise AssertionError(f"a CLI stage exited with {codes}")


def _trace_stream(tmp, smi, lse_ms, device, detector, setup_s, stages, alerts, factory,
                  fit_msgs, detect_msgs, anomalies, lone) -> dict:
    sink, relay = stages
    det_s = detector.settings
    det = detector.library_component
    # every coalesced release's wait and every warm-set replay, on the
    # host's monotonic clock
    waits, replays = [], []
    release, run = det._release_coalesced, det._warm.run

    def recording(n, reason, now):
        waits.append((now, reason, det._coalescer.oldest_age(now)))
        return release(n, reason, now)

    def replaying(kind, host_tokens):
        replays.append(time.monotonic())
        return run(kind, host_tokens)

    det._release_coalesced, det._warm.run = recording, replaying
    runner = threading.Thread(target=detector.run, name="ServiceRun", daemon=True)
    runner.start()
    _wait(lambda: detector.engine.running and detector.web_server.port, 30, "the detector")
    for stage in stages:
        _wait(stage.running, 300, f"the {stage.name} stage", interval=0.2)
    port = detector.web_server.port
    loop_tid = detector.engine._thread.native_id
    collector = _Collector(alerts)
    collector.start()
    upstream = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.send_stream("
         f"{relay.settings.engine_addr!r}, {len(fit_msgs)}, {TRACE_DETECT})"],
        cwd=Path(__file__).resolve().parent, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    try:
        if upstream.stdout.readline().strip() != "ready":
            raise AssertionError("the sender process did not start")
        # the SLO tracker's first observation: its windows difference
        # against it
        _http("GET", port, "/admin/slo")
        # the main path: launch counts 0 just before, read just after
        reset_launches()
        replays0 = replayed(det)
        upstream.stdin.write("fit\n")
        upstream.stdin.flush()
        upstream.stdout.readline()
        _wait(lambda: det._fitted and det._fit_thread is None and det.pending_count() == 0,
              300, "the fit at the boundary")
        n_waits_fit = len(waits)
        upstream.stdin.write("detect\n")
        upstream.stdin.flush()
        time.sleep(0.05)
        # a capture of the detector's process while the stream flows, and a
        # second request while it runs
        started = _http_any("POST", port, f"/admin/profile?seconds={TRACE_PROFILE_S}")
        busy = _http_any("POST", port, f"/admin/profile?seconds={TRACE_PROFILE_S}")
        sent = json.loads(upstream.stdout.readline())
        if not profiling.PROFILER.wait(120):
            raise AssertionError("the profiler capture did not end")
        _settle(det, detector.engine, collector)
        upstream.stdin.write("close\n")
        upstream.stdin.flush()
        upstream.wait(30)
    finally:
        if upstream.poll() is None:
            upstream.kill()
            upstream.wait(10)
    t_last = collector.times[-1] if collector.times else float("nan")
    collector.stop_flag.set()
    collector.join(5)
    sender = factory.create_output(relay.settings.engine_addr, buffer_size=1000)
    latencies = _lone_latencies(sender, alerts, lone)
    counts = read_launches()
    variants = read_variants()["candidate_lse"]
    graph = replay_delta(det, replays0)
    last = profiling.PROFILER.status()["last"]
    code, archive = _http_bytes("GET", port, "/admin/profile/latest")
    # pruning: two more captures leave the newest two
    for _ in range(2):
        _http("POST", port, f"/admin/profile?seconds={TRACE_PRUNE_S}")
        profiling.PROFILER.wait(60)
    kept = sorted(p.name for p in (tmp / "profiles").iterdir())

    n_relay = len(fit_msgs) + TRACE_DETECT + TRACE_LONE
    lines_sent = sum(map(count_lines, fit_msgs + detect_msgs + lone))
    _wait(lambda: _http("GET", sink.port, "/admin/traces?limit=0")[1]["stats"]["backlog"] == 0,
          30, "the collector to assemble every trace", interval=0.2)
    # each stage's series, from its own process
    texts = {"relay": _http("GET", relay.port, "/metrics")[1],
             "detector": _http("GET", port, "/metrics")[1],
             "sink": _http("GET", sink.port, "/metrics")[1]}
    cids = {"relay": relay.settings.component_id, "detector": det_s.component_id,
            "sink": sink.settings.component_id}
    pipeline = {name: {stage: _histogram(texts[stage], f"pipeline_{name}", cids[stage])["count"]
                       for stage in texts}
                for name in ("stage_dwell_seconds", "transit_seconds", "e2e_latency_seconds")}
    e2e = _histogram(texts["detector"], "pipeline_e2e_latency_seconds", det_s.component_id)
    read_lines = {stage: metric_value(texts[stage], "data_read_lines_total", cids[stage])
                  for stage in ("relay", "detector")}
    recorder = _http("GET", port, "/admin/trace")[1]
    # each process's SLO tracker reads its own stages' series
    slo = _http("GET", port, "/admin/slo")[1]
    relay_slo = _http("GET", relay.port, "/admin/slo")[1]
    xla = _http("GET", port, "/admin/xla")[1]
    traces = _http("GET", sink.port, "/admin/traces?limit=4096")[1]
    two_hop = [t for t in traces["traces"] if t["stages"] == 2 and t["complete"]]
    one = (_http("GET", sink.port, f"/admin/traces?id={two_hop[-1]['trace_id']}")[1]
           if two_hop else None)
    openmetrics = _http("GET", port, "/metrics?format=openmetrics")[1]
    exemplars = [line.split('trace_id="')[1].split('"')[0] for line in openmetrics.splitlines()
                 if line.startswith("pipeline_e2e_latency_seconds_bucket{")
                 and f'component_id="{det_s.component_id}"' in line and "trace_id=" in line]
    detector.shutdown()
    runner.join(60)
    sender.close()

    ids = [DetectorSchema.from_bytes(a)["logIDs"][0] for a in _messages_of(collector.frames)]
    by_id = set(ids)
    recall = len(anomalies & by_id) / max(1, len(anomalies))
    # the bound is the coalescer's promise with tracing on: it holds on the
    # releases whose wait meets no part of the profiler's capture (its start
    # and stop synchronize the device and hold the warm set's lock; inside
    # the window every thread's ops are recorded), and the waits that meet
    # the capture are reported apart
    spans = list((last.get("transitions_monotonic") or {}).values())
    capture = [(spans[0][0], spans[-1][1])] if spans else []

    def meets(w, windows):
        return any(a <= w[0] and w[0] - w[2] <= b for a, b in windows)

    stream = waits[n_waits_fit:]
    inside = [w for w in stream if meets(w, capture)]
    outside = [w for w in stream if not meets(w, capture)]
    tick_ms = det.drain_poll_ms
    wait_bound_s = (det.config.batch_deadline_ms + tick_ms + 2.0) / 1e3

    import io
    import zipfile

    names = zipfile.ZipFile(io.BytesIO(archive)).namelist() if code == 200 else []
    events = (json.loads(zipfile.ZipFile(io.BytesIO(archive)).read(profiling.TRACE_FILE))
              ["traceEvents"] if profiling.TRACE_FILE in names else [])
    window = [spans[0][1], spans[1][0]] if len(spans) == 2 else [0.0, 0.0]
    margin = 0.02
    replays_in_window = sum(1 for t in replays if window[0] + margin <= t <= window[1] - margin)
    lse = kernel_in_trace(events, "lse_wgmma_kernel")
    result = dict(
        card=smi, setup_s=setup_s, n_detect=TRACE_DETECT, relay_frames=n_relay,
        lines_sent=lines_sent,
        socket_lines_per_s=TRACE_DETECT / (t_last - sent["t_first"]),
        sender_lines_per_s=TRACE_DETECT / (sent["t_sent"] - sent["t_first"]),
        lone_p50_ms=float(np.percentile(latencies, 50) * 1e3),
        lone_p99_ms=float(np.percentile(latencies, 99) * 1e3),
        e2e_p50_ms=histogram_quantile(e2e, 0.5) * 1e3,
        e2e_p99_ms=histogram_quantile(e2e, 0.99) * 1e3, e2e_count=e2e["count"],
        release_wait_ms={"outside_max": max((w[2] for w in outside), default=0.0) * 1e3,
                         "inside_max": max((w[2] for w in inside), default=0.0) * 1e3,
                         "transitions_max": max((w[2] for w in inside if meets(w, spans)),
                                                default=0.0) * 1e3,
                         "outside_releases": len(outside), "inside_releases": len(inside),
                         "bound": wait_bound_s * 1e3,
                         "slowest_outside": [
                             {"reason": w[1], "wait_ms": w[2] * 1e3,
                              "after_capture_s": (w[0] - capture[0][1]) if capture else None}
                             for w in sorted(outside, key=lambda w: w[2])[-5:]]},
        pipeline_counts=pipeline, read_lines=read_lines,
        recorder={"tracing_enabled": recorder.get("tracing_enabled"),
                  "completed": recorder.get("completed"),
                  "hops": [list(h) for h in sorted({tuple(h["stage"] for h in t["hops"])
                                                    for t in recorder["slowest"]
                                                    + recorder["sampled"]})]},
        slo={"burn": slo["burn"], "dwell_share": slo["stages"]["dwell_share"],
             "relay_dwell_share": relay_slo["stages"]["dwell_share"]},
        collector={"stats": traces["stats"], "two_hop": len(two_hop),
                   "trace": one, "exemplars": exemplars},
        profile={"post": started[0], "second_post": busy[0], "latest": code,
                 "zip": names, "kept": kept,
                 "capture": {k: last.get(k) for k in (
                     "state", "activities", "all_threads", "trace_bytes",
                     "transitions_monotonic", "export_s")},
                 "events": len(events),
                 "event_counts": dict(Counter(e.get("cat") for e in events)),
                 "lse_wgmma": lse, "lse_combine": kernel_in_trace(events, "lse_combine_kernel"),
                 "lse_cuda_event_ms": lse_ms, "replays_in_window": replays_in_window,
                 # CPU ops the engine loop ran inside a capture another
                 # thread started
                 "engine_loop_cpu_ops": sum(1 for e in events if e.get("cat") == "cpu_op"
                                            and e.get("tid") == loop_tid)},
        alerts=len(ids), unique_alerts=len(by_id), anomalies=len(anomalies), recall=recall,
        launches=counts["candidate_lse"], launch_counts=counts, variants=variants,
        replayed_launches=graph, xla_totals=xla["totals"])
    if device == "cuda":
        result["profile"]["device"] = device_busy(events)
    emit("trace", **result)

    failures = []
    if device == "cuda" and result["release_wait_ms"]["outside_max"] > wait_bound_s * 1e3:
        failures.append(f"a release waited {result['release_wait_ms']['outside_max']:.3f} ms")
    if read_lines != {"relay": lines_sent, "detector": lines_sent}:
        failures.append(f"read {read_lines} lines of {lines_sent} sent")
    if len(by_id) != len(ids):
        failures.append("an alert was received twice")
    if recall < 0.9:
        failures.append(f"recall {recall}")
    if xla["totals"]["unexpected"]:
        failures.append(f"unexpected captures: {xla['totals']}")
    if not recorder.get("tracing_enabled") or recorder.get("completed") != n_relay \
            or result["recorder"]["hops"] != [["relay", "detector"]]:
        failures.append(f"flight recorder: {result['recorder']}")
    for trace in recorder["slowest"] + recorder["sampled"]:
        stamps = [t for h in trace["hops"] for t in (h["recv_ns"], h["send_ns"])]
        if stamps != sorted(stamps):
            failures.append(f"hops out of time order: {trace}")
            break
    want = {"stage_dwell_seconds": {"relay": n_relay, "detector": n_relay},
            "transit_seconds": {"relay": 0, "detector": n_relay},
            "e2e_latency_seconds": {"relay": 0, "detector": n_relay}}
    for name, stages in want.items():
        if {s: pipeline[name][s] for s in stages} != stages:
            failures.append(f"pipeline_{name}: {pipeline[name]}, want {stages}")
    if any(w["error_ratio"] is None for w in slo["burn"].values()) or \
            TORCH_SCORER not in slo["stages"]["dwell_share"] or \
            "core" not in relay_slo["stages"]["dwell_share"]:
        failures.append(f"/admin/slo: {result['slo']}")
    if not two_hop or one is None or [h["stage"] for h in one["hops"]] != ["relay", "detector"]:
        failures.append(f"the collector holds no two-hop trace: {traces['stats']}")
    retained = {t["trace_id"] for t in traces["traces"]}
    if not set(exemplars) & retained:
        failures.append(f"no e2e exemplar names a retained trace: {exemplars}")
    if started[0] != 200 or busy[0] != 409 or code != 200 or "capture.json" not in names:
        failures.append(f"profile routes: {result['profile']}")
    if kept != ["capture-0002", "capture-0003"]:
        failures.append(f"pruning kept {kept}")
    if device == "cuda":
        if not result["profile"]["device"]["kernel_events"]:
            failures.append("the capture holds no CUDA kernel event")
        if lse["count"] < replays_in_window or not replays_in_window:
            failures.append(f"{lse['count']} lse_wgmma_kernel events for "
                            f"{replays_in_window} replays in the window")
    if counts["candidate_lse"] < 1 or counts["flash_forward"] or counts["flash_dq"] \
            or counts["flash_dkv"]:
        failures.append(f"launches {counts}")
    if device == "cuda":
        try:
            check_head_variants(variants, "wgmma_tma_d128_", counts["candidate_lse"], "trace")
            check_replays(graph, {"candidate_lse": counts["candidate_lse"]}, "trace")
        except AssertionError as exc:
            failures.append(str(exc))
    if runner.is_alive():
        failures.append("the detector's service did not shut down")
    if failures:
        raise AssertionError(f"the trace phase failed: {failures}")
    return result


# -- the pipeline phase --------------------------------------------------------
def audit_line(i: int, rng, anomaly: bool) -> str:
    """One Linux-audit SYSCALL record (the header ``container/config/``'s
    parser format reads, then the content its template matches): normal
    records run one of five processes; an anomalous one runs an
    executable no normal record has. Its stamp cycles through 60 seconds,
    4 milliseconds and 64 serials and each process keeps 4 pids, so that
    the fit sees every value of those fields: the stack's detector config
    has no ``score_norm`` to quiet fields that differ on every line, and a
    line's only unseen tokens are then an anomaly's."""
    k = rng.integers(len(AUDIT_ANOMALOUS if anomaly else AUDIT_NORMAL))
    comm, exe, uid = AUDIT_ANOMALOUS[k] if anomaly else AUDIT_NORMAL[k]
    syscall = 59 if anomaly else (59, 42, 2)[rng.integers(3)]
    stamp = f"{1_753_800_000 + i % 60}.{250 * (i % 4):03d}:{9000 + i % 64}"
    return (f"type=SYSCALL msg=audit({stamp}): arch=c000003e syscall={syscall} success=yes "
            f"exit=0 pid={1000 + 10 * k + rng.integers(4)} uid={uid} comm=\"{comm}\" "
            f"exe=\"{exe}\"")


def make_audit_log(n_fit: int, n_detect: int, anomaly_rate: float = 0.01,
                   seed: int = 7) -> tuple:
    """``n_fit`` normal lines, then ``n_detect`` with ``anomaly_rate``
    anomalies → (lines, indices of the anomalous lines)."""
    rng = np.random.default_rng(seed)
    lines, anomalies = [], set()
    for i in range(n_fit + n_detect):
        anomaly = i >= n_fit and rng.random() < anomaly_rate
        lines.append(audit_line(i, rng, anomaly))
        if anomaly:
            anomalies.add(i)
    return lines, anomalies


def pipeline_files(tmp: Path, device: str = "cuda") -> dict:
    """The demo stack's four stages from ``container/config/`` under ``tmp``
    with only these changes: the detector's component type (the port's
    scorer in place of ``JaxScorerDetector``, its config block renamed with
    ``method_type: torch_scorer`` and ``head_impl: pallas``); the addresses
    (ipc sockets under ``tmp``, the parser's outputs with a tap the phase
    reads, the output stage's records to a socket the phase drains (without
    an output it answers on its input socket, which its detector never
    reads), HTTP on 127.0.0.1 at free ports); the paths (config files, the
    templates file, the output directory, the detector's
    ``checkpoint_dir``); and, off the card, ``device`` and
    ``PIPELINE_CPU_CHANGES``. Returns {stage: settings file}."""
    import yaml

    conf = Path(__file__).resolve().parent / "container" / "config"
    out = {}
    for stage in PIPELINE_STAGES:
        settings = yaml.safe_load((conf / f"{stage}_settings.yaml").read_text())
        config = yaml.safe_load((conf / f"{stage}_config.yaml").read_text())
        if stage == "detector":
            block = dict(config["detectors"]["JaxScorerDetector"],
                         method_type="torch_scorer", head_impl="pallas")
            if device != "cuda":
                block.update(PIPELINE_CPU_CHANGES, device=device)
            config = {"detectors": {"TorchScorerDetector": block}}
            settings.update(component_type=TORCH_SCORER,
                            checkpoint_dir=str(tmp / "ckpt"))
        elif stage == "parser":
            config["parsers"]["MatcherParser"]["params"]["path_templates"] = str(
                conf / "audit_templates.txt")
        elif stage == "output":
            # `directory` is no field of OutputWriterConfig (a key the
            # component keeps unread, as the JAX one does): the records go
            # to the stage's working directory, which the phase sets to it
            config["outputs"]["OutputWriter"]["directory"] = str(tmp / "out")
        nxt = {"reader": ["parser"], "parser": ["detector", "tap"],
               "detector": ["output"], "output": ["records"]}[stage]
        settings.update(engine_addr=f"ipc://{tmp}/{stage}.ipc",
                        out_addr=[f"ipc://{tmp}/{n}.ipc" for n in nxt],
                        http_host="127.0.0.1", http_port=_free_port(),
                        config_file=str(tmp / f"{stage}_config.yaml"))
        (tmp / f"{stage}_config.yaml").write_text(yaml.safe_dump(config))
        path = tmp / f"{stage}_settings.yaml"
        path.write_text(yaml.safe_dump(settings))
        out[stage] = path
    return out


def serve_counted(settings_path: str, report_path: str) -> int:
    """``detectmateservice_tpu_torch.cli.main`` for one settings file,
    counting kernel 1's launches from the end of ``setup_io`` to shutdown
    and recording every shape the detector hands it; the counts go to
    ``report_path`` as JSON once the CLI returns. The pipeline phase starts
    its detector stage so."""
    import faulthandler

    from detectmateservice_tpu_torch import cli

    faulthandler.register(PIPELINE_DUMP_SIGNAL, all_threads=True)
    services = []

    class Counted(cli.Service):
        def setup_io(self):
            super().setup_io()
            reset_launches()
            services.append((self, replayed(self.library_component)))

    cli.Service = Counted
    with _head_shapes() as shapes:
        rc = cli.main(["--settings", settings_path])
    service, replays0 = services[0]
    det = service.library_component
    Path(report_path).write_text(json.dumps({
        "returncode": rc, "launches": read_launches(), "variants": read_variants(),
        "replayed": replay_delta(det, replays0), "device_batches": det.path_counts,
        "shapes": [[n, c, d, _dtype_name(dtype)] for n, c, d, dtype in sorted(
            shapes.shapes, key=lambda t: (t[0], t[1], t[2], str(t[3])))]}))
    return rc


class _Tap(threading.Thread):
    """Receives the parser's outputs on the tap address, in order."""

    def __init__(self, sock):
        super().__init__(name="ParserTap", daemon=True)
        self.sock, self.msgs, self.t_last = sock, [], None
        self.stop_flag = threading.Event()

    def run(self) -> None:
        self.sock.recv_timeout = 50
        while not self.stop_flag.is_set():
            try:
                frame = self.sock.recv()
            except TransportTimeout:
                continue
            self.msgs.extend(_messages_of([frame]))
            self.t_last = time.perf_counter()


def _stage_lines(ports: dict, cids: dict, timeout: float = 30.0) -> dict:
    """Each stage's read and written lines, from its ``/metrics``; a stage
    that does not answer raises ``StageSilent`` naming it."""
    out = {}
    for stage, port in ports.items():
        try:
            text = _http("GET", port, "/metrics", timeout)[1]
        except OSError as exc:
            raise StageSilent({stage: f"no answer from /metrics within {timeout} s: "
                                      f"{exc}"}) from exc
        out[stage] = (metric_value(text, "data_read_lines_total", cids[stage]),
                      metric_value(text, "data_written_lines_total", cids[stage]))
    return out


class StageSilent(AssertionError):
    """Stages of the demo stack that stopped answering (stage -> what was
    asked and how it failed)."""

    def __init__(self, silent: dict):
        super().__init__(f"stages stopped answering: {silent}")
        self.silent = silent


# the frame that tells each stage thread's role in a stack dump
_THREAD_ROLES = (("_run_loop", "engine"), ("serve_forever", "http"),
                 ("_collect_burst", "engine"), ("ProfileManager", "profiler"),
                 ("_fit_worker", "fit"), ("tick", "monitor"))


def dump_stage_stacks(procs: dict, tmp: Path) -> dict:
    """Each running stage's threads' stacks: ``PIPELINE_DUMP_SIGNAL`` to
    every stage process, whose faulthandler writes them to its stderr file;
    returns stage -> threads, each with its role (engine, http, ...) where
    a frame tells it and its innermost frames, and prints them."""
    marks = {}
    for stage, proc in procs.items():
        path = tmp / f"{stage}.err"
        marks[stage] = path.stat().st_size if path.exists() else 0
        if proc.poll() is None:
            proc.send_signal(PIPELINE_DUMP_SIGNAL)
    time.sleep(PIPELINE_DUMP_WAIT_S)
    out = {}
    for stage, proc in procs.items():
        if proc.poll() is not None:
            out[stage] = {"exited": proc.returncode}
            continue
        with open(tmp / f"{stage}.err", "rb") as fh:
            fh.seek(marks[stage])
            text = fh.read().decode(errors="replace")
        threads = []
        for block in re.split(r"\n(?=(?:Current thread|Thread) 0x)", "\n" + text):
            head, _, body = block.strip().partition("\n")
            if not head.startswith(("Current thread", "Thread")):
                continue
            frames = [line.strip() for line in body.splitlines() if line.strip().startswith(
                "File")]
            role = next((name for key, name in _THREAD_ROLES
                         if any(key in f for f in frames)), "other")
            threads.append({"thread": head.split(" (")[0], "role": role,
                            "innermost": frames[:6]})
        out[stage] = {"threads": threads}
        print(f"pipeline: {stage} stage's threads: {json.dumps(threads)}", file=sys.stderr,
              flush=True)
    return out


def _parser_fields_differ(got: dict, want: dict, t_lo: int, t_hi: int) -> list:
    """The fields where a parser output differs from the plain path's on the
    same line: every field equal but the drawn ones, ``parsedLogID`` (32
    lowercase hex digits) and the two timestamps (this run's seconds)."""
    bad = [k for k in want if k not in ("parsedLogID", "receivedTimestamp",
                                        "parsedTimestamp") and got[k] != want[k]]
    if not re.fullmatch(r"[0-9a-f]{32}", got["parsedLogID"]):
        bad.append("parsedLogID")
    for key in ("receivedTimestamp", "parsedTimestamp"):
        if not t_lo <= got[key] <= t_hi:
            bad.append(key)
    return bad


def phase_pipeline(smi: str, device: str = "cuda") -> dict:
    """The container demo stack on the port: reader → parser → scorer →
    output as four port CLI processes over ipc sockets, fed raw audit lines
    (``make_audit_log``): 2,048 to fit on, then 65,536 with 1 % anomalies,
    in frames of ``PIPELINE_FRAME`` lines; one 1 s ``/admin/profile``
    capture of the detector's process during the stream. Fails unless
    every stage read every line its upstream sent, every parser output (the
    tap beside the detector) equals the port's plain path on its line,
    recall >= 0.9 from the output files, no alert flips against the
    einsum-head detector restored from the stage's shutdown checkpoint 1e-2
    or farther from its threshold, kernel 1 holds against its plain version
    at every shape the detector handed it, and every process exits 0 after
    ``POST /admin/shutdown``."""
    import yaml

    from detectmateservice_tpu_torch.library.parsers import MatcherParser
    from detectmateservice_tpu_torch.schemas import LogSchema

    tmp = Path(tempfile.mkdtemp(prefix="dmpl", dir="/tmp"))
    procs, sender, tap_sock, tap, forwarded_sock, forwarded = {}, None, None, None, None, None
    try:
        files = pipeline_files(tmp, device)
        (tmp / "out").mkdir()
        docs = {stage: yaml.safe_load(path.read_text()) for stage, path in files.items()}
        ports = {stage: doc["http_port"] for stage, doc in docs.items()}
        cids = {stage: ServiceSettings.from_yaml(str(path)).component_id
                for stage, path in files.items()}
        lines, anomalies = make_audit_log(PIPELINE_FIT, PIPELINE_DETECT)
        factory = ZmqPairSocketFactory()
        tap_sock = factory.create(f"ipc://{tmp}/tap.ipc")
        tap = _Tap(tap_sock)
        tap.start()
        forwarded_sock = factory.create(f"ipc://{tmp}/records.ipc")
        forwarded = _Tap(forwarded_sock)
        forwarded.start()
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        # downstream first, so that every stage's outputs find their peer
        for stage in ("output", "detector", "parser", "reader"):
            if stage == "detector":
                cmd = [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                       f"chip_smoke.serve_counted({str(files[stage])!r}, "
                       f"{str(tmp / 'detector_report.json')!r}))"]
            else:
                cmd = [sys.executable, "-c", PIPELINE_STAGE_CODE, str(files[stage])]
            with open(tmp / f"{stage}.out", "wb") as out, open(tmp / f"{stage}.err", "wb") as err:
                procs[stage] = subprocess.Popen(
                    cmd, stdout=out, stderr=err, env=env,
                    cwd=tmp / "out" if stage == "output" else root)

            def running(stage=stage):
                if procs[stage].poll() is not None:
                    raise AssertionError(
                        f"the {stage} stage exited: "
                        f"{(tmp / f'{stage}.err').read_text()[-2000:]}")
                try:
                    return _http("GET", ports[stage], "/admin/status", 2)[1]["status"]["running"]
                except OSError:
                    return False

            _wait(running, 300, f"the {stage} stage", interval=0.2)
            print(f"pipeline: the {stage} stage runs ({time.perf_counter() - t0:.1f} s)",
                  file=sys.stderr, flush=True)
        start_s = time.perf_counter() - t0
        sender = factory.create_output(f"ipc://{tmp}/reader.ipc", buffer_size=1000)
        raw = [line.encode() for line in lines]
        # per stage, (time, read lines) while the stream runs
        progress, profile = {stage: [] for stage in PIPELINE_STAGES}, None
        t_first = time.perf_counter()
        for i in range(0, PIPELINE_FIT, PIPELINE_FRAME):
            sender.send(pack_batch(raw[i:i + PIPELINE_FRAME]))
        # one capture of the detector's process while the detect lines flow
        profile = _http("POST", ports["detector"], "/admin/profile", payload={
            "seconds": 1.0, "out_dir": str(tmp / "profile")})
        for i in range(PIPELINE_FIT, len(raw), PIPELINE_FRAME):
            sender.send(pack_batch(raw[i:i + PIPELINE_FRAME]))
        t_sent = time.perf_counter()
        total = len(raw)
        print(f"pipeline: {total} lines sent", file=sys.stderr, flush=True)

        last = {"said": 0.0}

        def poll(stage, path, parse):
            try:
                return parse(_http("GET", ports[stage], path, 5.0)[1])
            except OSError as exc:
                return f"no answer: {exc}"

        def settled():
            now = time.perf_counter()
            counts = {stage: poll(stage, "/metrics", lambda text, stage=stage: (
                metric_value(text, "data_read_lines_total", cids[stage]),
                metric_value(text, "data_written_lines_total", cids[stage])))
                for stage in PIPELINE_STAGES}
            scored = poll("detector", "/metrics", lambda text: sum(
                float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("detector_device_lines_total{")))
            profiling_now = poll("detector", "/admin/profile", lambda doc: doc["running"])
            last.update(counts=counts, scored=scored, profiling=profiling_now,
                        tapped=len(tap.msgs), forwarded=len(forwarded.msgs))
            if now - last["said"] > 5.0:
                last["said"] = now
                print(f"pipeline: {now - t_sent:.1f} s after the send: "
                      f"{ {k: v for k, v in last.items() if k != 'said'} }",
                      file=sys.stderr, flush=True)
            if any(isinstance(v, str) for v in (*counts.values(), scored, profiling_now)):
                return False    # a stage too busy to answer is not settled
            for stage, (read, _) in counts.items():
                progress[stage].append((now, read))
            done = (len(tap.msgs) >= total and counts["reader"][0] >= total
                    and counts["detector"][0] >= counts["parser"][1]
                    and scored >= PIPELINE_DETECT
                    and counts["output"][0] >= counts["detector"][1]
                    and not profiling_now)
            if not done:
                settled.quiet = None
            elif settled.quiet is None:
                settled.quiet = now
            return done and now - settled.quiet > 1.0

        settled.quiet = None
        try:
            _wait(settled, 240, "the pipeline to drain", interval=0.1)
        except AssertionError as exc:
            silent = {stage: v for stage, v in (last.get("counts") or {}).items()
                      if isinstance(v, str)}
            stacks = dump_stage_stacks(procs, tmp)
            tails = {stage: (tmp / f"{stage}.err").read_text()[-600:] for stage in procs}
            raise AssertionError(f"{exc}: last {last}; silent {silent}; stacks {stacks}; "
                                 f"stderr {tails}") from exc
        try:
            counts = _stage_lines(ports, cids)
        except StageSilent as exc:
            raise AssertionError(f"{exc}; stacks {dump_stage_stacks(procs, tmp)}") from exc
        profile_status = _http("GET", ports["detector"], "/admin/profile")[1]
        exits = {}
        for stage in PIPELINE_STAGES:
            _http("POST", ports[stage], "/admin/shutdown")
            exits[stage] = procs[stage].wait(timeout=120)
        report = json.loads((tmp / "detector_report.json").read_text())

        # the parser's outputs against the port's plain path on each line
        parsed = [ParserSchema.from_bytes(m) for m in tap.msgs]
        pconf = yaml.safe_load((tmp / "parser_config.yaml").read_text())
        pconf["parsers"]["MatcherParser"]["params"]["native_parse"] = False
        plain_parser = MatcherParser(config=pconf)  # the Service builds it unnamed
        t_lo, t_hi = int(time.time()) - 3600, int(time.time())
        parser_mismatch, bad_ids = [], 0
        for i, got in enumerate(parsed[:total]):
            log_id = got["logID"]
            if not re.fullmatch(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-"
                                r"[0-9a-f]{12}", log_id):
                bad_ids += 1
            envelope = LogSchema(logID=log_id, log=lines[i], logSource="x",
                                 hostname="h").serialize()
            want = ParserSchema.from_bytes(
                plain_parser._process_batch_plain([envelope])[0]).to_dict()
            bad = _parser_fields_differ(got.to_dict(), want, t_lo, t_hi)
            if bad and len(parser_mismatch) < 5:
                parser_mismatch.append({"line": i, "fields": bad})
            elif bad:
                parser_mismatch.append(None)
        index = {p["logID"]: i for i, p in enumerate(parsed)}

        # the alerts in the output files
        records = [json.loads(line) for f in sorted((tmp / "out").glob("output.*"))
                   for line in f.read_text().splitlines()]
        alerted = [index.get(log_id, -1) for r in records for log_id in r["logIDs"]]

        # the plain detector: the stage's checkpoint under the einsum head
        dconf = yaml.safe_load((tmp / "detector_config.yaml").read_text())
        block = dict(dconf["detectors"]["TorchScorerDetector"], head_impl="einsum")
        plain = TorchScorerDetector(config={"detectors": {"TorchScorerDetector": block}})
        plain.setup_io()
        plain.load_checkpoint(str(tmp / "ckpt"))
        threshold = plain._threshold
        detect = list(range(PIPELINE_FIT, total))
        tokens, ok = plain._featurize_raw_batch([tap.msgs[i] for i in detect])
        scores = np.concatenate([plain.score_tokens(tokens[j:j + 4096])
                                 for j in range(0, len(tokens), 4096)])
        want = {detect[j] for j in np.flatnonzero(ok & (scores > threshold))}
        flips = sorted(want ^ set(alerted))
        near = [float(abs(scores[i - PIPELINE_FIT] - threshold)) if i >= PIPELINE_FIT
                else float("inf") for i in flips]
        del plain
        head_checks = mesh_head_checks(
            [(n, c, d, getattr(torch, dt)) for n, c, d, dt in report["shapes"]],
            device) if device == "cuda" else []

        # what each stage logged as an error (the detector's profiler
        # capture among them), for the record
        errors = {stage: [line for line in (tmp / f"{stage}.err").read_text(
            errors="replace").splitlines() if "ERROR" in line][:4] for stage in procs}

        def rate(stage):
            seen = [(t, n) for t, n in progress[stage] if n > 0]
            done = [t for t, n in seen if n >= seen[-1][1]] if seen else []
            return (seen[-1][1] / (done[0] - t_first)) if done and done[0] > t_first else None
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
        for thread in (tap, forwarded):
            if thread is not None:
                thread.stop_flag.set()
                thread.join(10)
        for sock in (sender, tap_sock, forwarded_sock):
            if sock is not None:
                sock.close()
        shutil.rmtree(tmp, ignore_errors=True)

    recall = len(anomalies & set(alerted)) / max(1, len(anomalies))
    result = dict(
        card=smi, start_s=start_s, lines_sent=total, n_fit=PIPELINE_FIT,
        n_detect=PIPELINE_DETECT,
        end_to_end_lines_per_s=total / ((tap.t_last or t_sent) - t_first),
        sender_lines_per_s=total / (t_sent - t_first),
        stage_read_lines_per_s={stage: rate(stage) for stage in PIPELINE_STAGES},
        stage_lines={stage: {"read": r, "written": w} for stage, (r, w) in counts.items()},
        parser_outputs=len(parsed), parser_mismatches=len(parser_mismatch),
        parser_mismatch_examples=[m for m in parser_mismatch if m][:5], bad_log_ids=bad_ids,
        records=len(records), records_forwarded=len(forwarded.msgs), alerts=len(alerted),
        unique_alerts=len(set(alerted)),
        anomalies=len(anomalies), recall=recall,
        precision=len(anomalies & set(alerted)) / max(1, len(set(alerted))),
        threshold=threshold, decision_flips=len(flips), flip_distances=near[:16],
        launches=report["launches"]["candidate_lse"], launch_counts=report["launches"],
        variants=report["variants"]["candidate_lse"], replayed_launches=report["replayed"],
        device_batches=report["device_batches"], head_shapes=report["shapes"],
        head_checks=head_checks,
        head_max_abs_err=max((r["max_abs_err"] for r in head_checks), default=0.0),
        profile={"started": profile[0],
                 "last": {k: (profile_status.get("last") or {}).get(k)
                          for k in ("state", "activities", "trace_bytes")}},
        exits=exits, detector_exit=report["returncode"], stage_errors=errors)
    emit("pipeline", **result)
    failures = []
    if counts["reader"][0] != total:
        failures.append(f"the reader read {counts['reader'][0]} lines of {total}")
    for stage, up in (("parser", "reader"), ("detector", "parser"), ("output", "detector")):
        if counts[stage][0] != counts[up][1]:
            failures.append(f"the {stage} read {counts[stage][0]} lines of the "
                            f"{counts[up][1]} its upstream wrote")
    if len(parsed) != total or parser_mismatch or bad_ids:
        failures.append(f"parser outputs: {len(parsed)} of {total}, "
                        f"{len(parser_mismatch)} apart from the plain path "
                        f"{result['parser_mismatch_examples']}, {bad_ids} malformed logIDs")
    if len(set(alerted)) != len(alerted) or -1 in alerted:
        failures.append("an alert was written twice or names no line")
    if len(forwarded.msgs) != len(records):
        failures.append(f"{len(records)} records in the files, {len(forwarded.msgs)} forwarded")
    if recall < 0.9:
        failures.append(f"recall {recall}")
    if near and min(near) < float("inf") and max(near) >= 1e-2:
        failures.append(f"decisions apart from the einsum head beyond 1e-2: {near[:16]}")
    if any(d == float("inf") for d in near):
        failures.append("an alert on a fit line")
    if any(rc != 0 for rc in exits.values()) or report["returncode"] != 0:
        failures.append(f"exit codes {exits}")
    if profile[0] != 200 or (profile_status.get("last") or {}).get("state") != "done":
        failures.append(f"the detector's profiler capture: {profile} {profile_status}")
    if device == "cuda":
        if report["launches"]["candidate_lse"] < 1 or not head_checks:
            failures.append(f"launches {report['launches']}, shapes {report['shapes']}")
        if result["head_max_abs_err"] > 2e-3:
            failures.append(f"kernel 1 against its plain version: {head_checks}")
        try:
            check_head_variants(result["variants"], "wgmma_tma_d128_",
                                report["launches"]["candidate_lse"], "pipeline")
            check_replays(report["replayed"],
                          {"candidate_lse": report["launches"]["candidate_lse"]}, "pipeline")
        except AssertionError as exc:
            failures.append(str(exc))
    if failures:
        raise AssertionError(f"the pipeline phase failed: {failures}")
    return result


def run_isolated(name: str, *args) -> dict:
    """``name(*args)`` of this script in a fresh interpreter (kernels load
    from the build cache phase 2 filled): its lines pass through, its
    result comes back as JSON, and its failure fails the run. The service
    a phase hosts then shares its process with nothing of the phases
    before it."""
    code = ("import json, sys, torch, chip_smoke\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            f"result = chip_smoke.{name}(*json.loads(sys.argv[1]))\n"
            "print('RESULT ' + json.dumps(result, default=lambda v: getattr(v, 'item', "
            "lambda: str(v))()), flush=True)\n")
    root = Path(__file__).resolve().parent
    proc = subprocess.Popen([sys.executable, "-c", code, json.dumps(args)], cwd=root,
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(root)))
    result = None
    try:
        for line in proc.stdout:
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    if rc != 0 or result is None:
        raise AssertionError(f"{name} failed in its own interpreter (exit {rc})")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phases_s = {}

    def timed(label: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases_s[label] = time.perf_counter() - t0
        return out

    name, _smi = timed("card", phase_card)
    main_path_ptxas = timed("build", phase_build)
    lse_err = timed("kernel_checks", phase_kernel_checks)
    lse_times = timed("timings", phase_timings)
    flash_err = timed("flash_checks", phase_flash_checks)
    flash_times = timed("flash_timings", phase_flash_timings)
    mlp = timed("detector", phase_detector)
    torch.cuda.empty_cache()
    frames = timed("frames", phase_frames, _smi)
    torch.cuda.empty_cache()
    logbert = timed("logbert", phase_logbert_detector)
    torch.cuda.empty_cache()
    gru, gru_det = timed("gru", phase_gru_detector)
    torch.cuda.empty_cache()
    int8, int8_det = timed("int8w", phase_int8_detector, mlp["lines_per_s"])
    timed("checkpoints", phase_checkpoints, {"gru": gru_det, "int8w_mlp": int8_det})
    int8_lc = timed("int8w_lifecycle", int8_lifecycle, int8_det, make_messages(
        INT8_CONFIG["max_batch"], anomaly_rate=0.01, seed=1)[0])
    del gru_det, int8_det
    torch.cuda.empty_cache()
    service = timed("service", phase_service, _smi, frames["lines_per_s"])
    torch.cuda.empty_cache()
    # the phases that hold the release-wait bound host the detector's
    # service in an interpreter of its own, as a deployment does
    coalesce = timed("coalesce", run_isolated, "phase_coalesce", _smi)
    lifecycle = timed("lifecycle", run_isolated, "phase_lifecycle", _smi)
    trace = timed("trace", run_isolated, "phase_trace", _smi, lse_times[(1024, 128)]["ms"])
    mesh = timed("mesh", phase_mesh, _smi)
    mesh_model, mesh_flash = mesh["model"], mesh["model_flash"]
    torch.cuda.empty_cache()
    pipeline = timed("pipeline", phase_pipeline, _smi)
    timed("frames_profile", phase_frames_profile, _smi)
    logbert_lc = logbert["lifecycle"]
    mlp_row = lse_times[(CALL_SIZE, 128)]
    kernels = [{
        "name": "candidate_lse",
        "route": "cuda",
        "source": "detectmateservice_tpu_torch/ops/csrc/scorehead.cu",
        "replaces": "detectmateservice_tpu/ops/scorehead.py:55",
        "launches": (mlp["launches"] + frames["launches"]
                     + logbert["launch_counts"]["candidate_lse"]
                     + gru["launch_counts"]["candidate_lse"] + int8["launches"]
                     + service["launches"] + coalesce["launches"] + lifecycle["launches"]
                     + int8_lc["launches"] + logbert_lc["launch_counts"]["candidate_lse"]
                     + trace["launches"] + mesh["launches"] + pipeline["launches"]
                     + mesh_model["launches"] + mesh_flash["launches"]),
        "launches_by_path": {"mlp": mlp["launches"], "mlp_frames": frames["launches"],
                             "logbert": logbert["launch_counts"]["candidate_lse"],
                             "gru": gru["launch_counts"]["candidate_lse"],
                             "int8w_mlp": int8["launches"], "service": service["launches"],
                             "coalesce": coalesce["launches"],
                             "lifecycle": lifecycle["launches"],
                             "int8w_lifecycle": int8_lc["launches"],
                             "logbert_lifecycle": logbert_lc["launch_counts"]["candidate_lse"],
                             "trace": trace["launches"], "mesh": mesh["launches"],
                             "pipeline": pipeline["launches"],
                             "mesh_model": mesh_model["launches"],
                             "mesh_model_flash": mesh_flash["launches"]},
        # every launch of the serving paths ran as part of a CUDA-graph
        # replay; on the lifecycle paths the candidate's shadow chunks run
        # op by op
        "replayed_by_path": {"mlp": mlp["replayed_launches"]["candidate_lse"],
                             "mlp_frames": frames["replayed_launches"]["candidate_lse"],
                             "logbert": logbert["replayed_launches"]["candidate_lse"],
                             "gru": gru["replayed_launches"]["candidate_lse"],
                             "int8w_mlp": int8["replayed_launches"]["candidate_lse"],
                             "service": service["replayed_launches"]["candidate_lse"],
                             "coalesce": coalesce["replayed_launches"]["candidate_lse"],
                             "lifecycle": lifecycle["replayed_launches"]["candidate_lse"],
                             "int8w_lifecycle": int8_lc["replayed_launches"]["candidate_lse"],
                             "logbert_lifecycle":
                                 logbert_lc["replayed_launches"]["candidate_lse"],
                             "trace": trace["replayed_launches"]["candidate_lse"],
                             "mesh": mesh["replayed_launches"]["candidate_lse"],
                             "pipeline": pipeline["replayed_launches"]["candidate_lse"],
                             "mesh_model": mesh_model["replayed_launches"]["candidate_lse"],
                             "mesh_model_flash":
                                 mesh_flash["replayed_launches"]["candidate_lse"]},
        "max_abs_err": max(lse_err, mesh["head_max_abs_err"], pipeline["head_max_abs_err"]),
        "ms": mlp_row["ms"],
        "plain_ms": mlp_row["plain_ms"],
        "bound_ms": mlp_row["bound_ms"],
        "bound_by": mlp_row["bound_by"],
        "library_ms": mlp_row["library_ms"],
        "shape": [CALL_SIZE, 32768, 128],
        "variant": mlp_row["variant"],
        "bound_share": mlp_row["bound_share"],
        "launches_by_variant": {"mlp": mlp["variants"], "mlp_frames": frames["variants"],
                                "logbert": logbert["variants"]["candidate_lse"],
                                "gru": gru["variants"],
                                "int8w_mlp": int8["variants"],
                                "service": service["variants"],
                                "coalesce": coalesce["variants"],
                                "lifecycle": lifecycle["variants"],
                                "int8w_lifecycle": int8_lc["variants"],
                                "logbert_lifecycle": logbert_lc["variants"]["candidate_lse"],
                                "trace": trace["variants"], "mesh": mesh["variants"],
                                "pipeline": pipeline["variants"],
                                "mesh_model": mesh_model["variants"]["candidate_lse"],
                                "mesh_model_flash": mesh_flash["variants"]["candidate_lse"]},
        "ptxas": {name: main_path_ptxas[MAIN_PATH_WGMMA[name]]
                  for name in ("lse_d128", "lse_d256", "lse_combine")},
        "logbert_calibration_shape": dict(shape=[65536, 32768, 256],
                                          **lse_times[(65536, 256)]),
        "logbert_detect_shape": dict(shape=[524288, 32768, 256],
                                     **lse_times[(524288, 256)]),
        "mlp_calibration_shape": dict(shape=[32, 32768, 128], **lse_times[(32, 128)]),
        "gru_detect_shape": dict(shape=[131072, 32768, 128], **lse_times[(131072, 128)]),
        "gru_calibration_shape": dict(shape=[1024, 32768, 128], **lse_times[(1024, 128)]),
        # the shapes the model axis's rows gave it, each held against its
        # plain version (max_abs_err above) and the largest timed
        "mesh_model_shapes": mesh_model["head_shapes"] + mesh_flash["head_shapes"],
        "mesh_model_timings": [r for r in mesh_model["timings"] + mesh_flash["timings"]
                               if r["kernel"] == "candidate_lse"],
    }]
    replaces = {"forward": "detectmateservice_tpu/ops/flash.py:64",
                "dq": "detectmateservice_tpu/ops/flash.py:221",
                "dkv": "detectmateservice_tpu/ops/flash.py:247"}
    main_label = {"forward": "scoring", "dq": "training", "dkv": "training"}
    for kind, fn_name in (("forward", "flash_forward"), ("dq", "flash_dq"),
                          ("dkv", "flash_dkv")):
        row = flash_times[(kind, main_label[kind])]
        entry = {
            "name": fn_name, "route": "cuda",
            "source": "detectmateservice_tpu_torch/ops/csrc/flash.cu",
            "replaces": replaces[kind],
            "launches": (logbert["launch_counts"][fn_name]
                         + logbert_lc["launch_counts"][fn_name]
                         + mesh_flash["launch_counts"][fn_name]),
            "max_abs_err": max(flash_err[fn_name], max(
                (r[name]["max_abs_err"] for r in mesh_flash["flash_checks"]
                 for name, kernel in _FLASH_RESULT_KERNEL.items()
                 if kernel == fn_name and name in r), default=0.0)),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "shape", "variant",
                                         "bound_share")},
            # the MLP lifecycle paths launch no flash kernel
            "launches_by_path": {"logbert": logbert["launch_counts"][fn_name],
                                 "lifecycle": lifecycle["launch_counts"][fn_name],
                                 "int8w_lifecycle": int8_lc["launch_counts"][fn_name],
                                 "logbert_lifecycle": logbert_lc["launch_counts"][fn_name],
                                 "mesh_model": mesh_model["launch_counts"][fn_name],
                                 "mesh_model_flash": mesh_flash["launch_counts"][fn_name]},
            "replayed_by_path": {"logbert": logbert["replayed_launches"][fn_name],
                                 "lifecycle": lifecycle["replayed_launches"][fn_name],
                                 "int8w_lifecycle": int8_lc["replayed_launches"][fn_name],
                                 "logbert_lifecycle":
                                     logbert_lc["replayed_launches"][fn_name],
                                 "mesh_model_flash": mesh_flash["replayed_launches"][fn_name]},
            "launches_by_variant": {"logbert": logbert["variants"][fn_name],
                                    "lifecycle": {}, "int8w_lifecycle": {},
                                    "logbert_lifecycle": logbert_lc["variants"][fn_name],
                                    "mesh_model_flash": mesh_flash["variants"][fn_name]},
            # the shapes the model shards gave it (two heads each), each held
            # against its plain version, and the largest timed
            "mesh_model_shapes": [s for s in mesh_flash["flash_shapes"]
                                  if kind == "forward" or s[6]],
            "mesh_model_timings": [r for r in mesh_flash["timings"] if r["kernel"] == fn_name],
        }
        if kind in MAIN_PATH_WGMMA:
            entry["ptxas"] = main_path_ptxas[MAIN_PATH_WGMMA[kind]]
        if kind == "forward":
            entry["training_shape"] = flash_times[("forward", "training")]
            # the scoring launches (calibration chunks, detect batches) ran
            # as graph replays; the train steps' launches eagerly
            entry["replays"] = logbert["replayed_launches"][fn_name]
        kernels.append(entry)
    spilled = {name: row for name, row in main_path_ptxas.items()
               if row is None or row.get("spill_stores") or row.get("spill_loads")}
    if spilled:
        raise AssertionError(f"ptxas reports spills (or no entry) for {spilled}")
    emit("total", seconds=time.perf_counter() - t_start, phases_s=phases_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
