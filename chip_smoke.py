#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  -- the card, its power limit (nvidia-smi) and the software;
2. build   -- compiles every CUDA source under src/repro_torch/kernels/csrc,
   one nvcc per source, all at once;
3. kernels -- holds each kernel against its plain PyTorch version on the
   hazard cases (flash attention, whose wrapper picks the fp32 tensor-core
   (split precision), the bf16 prefill or the bf16 decode kernel: fp32 tol
   2e-5, bf16 tol 2e-2; mLSTM chunk scan, whose wrapper picks the bf16
   tensor-core kernel, the fp32 one (split precision) or, for a chunk that
   is not a multiple of 16, the FMA kernel: bf16 rtol = atol = 5e-2 on h,
   fp32 rtol 5e-4 atol 5e-5 on the final state, and an fp32 h and state by
   mlstm_scan.check_fp32 -- the plain version element by element where it
   meets float64, else float64 row by row (ROADMAP C21)) and
   at the serving shapes, and times kernel, plain
   version and the library call, where there is one, beside its bound, on
   the device alone through a CUDA graph and per eager call; the
   attention hazard cases again at head dim 64 and at 256 (G = H/KV of 1
   to 12 among them: 5 and 6, where a prefill block of 192 rows holds 38
   and 32 positions; non-causal at T = S = 1500, and queries at position
   0 against 1500 keys at T 512 and T 1), and ``"phase": "attention"``
   lines at granite-moe-3b-a800m's serving shapes (D = 64), gemma3-1b's
   (D = 256: prefill, decode and the fp32 kernel at both), starcoder2-3b's
   (G = 12), hymba-1.5b's (G = 5, 640 positions; also in fp32),
   internvl2-26b's (G = 6, 768 positions; nemotron-4-15b's too),
   qwen3-moe-30b-a3b's (G = 8: prefill blocks of 24 positions x 8 heads)
   and whisper-base's (its encoder, non-causal at T = S =
   1500; cross-attention at T 512 and T 1 against S 1500), each naming the
   SDPA backend that ran; in fp32 the mLSTM's FMA kernel, which the
   split tensor-core one replaced, is timed beside it;
4. small   -- the reduced models in fp32 on the card against the CPU (the
   run that drives the fp32 attention kernel), the reduced MoE among them,
   the reduced gemma3-1b also at its published head dim, 256, and the
   reduced hymba-1.5b, whisper-base (seeded frames) and internvl2-26b
   (seeded patch embeddings);
5. serve   -- llama3.2-3b, granite-moe-3b-a800m (its MoE
   on one card: the single-shard path, 48 stored experts), gemma3-1b
   (head dim 256, a 512-key window on 22 of its 26 layers),
   starcoder2-3b (layernorm, gelu and biases; 12 query heads a KV head)
   and whisper-base (a 6-layer
   encoder over 1500 zero frames, as the engine passes them, and
   cross-attention in its 6 decoder layers) at full width and depth,
   xlstm-350m (8 of its 24 layers, the sLSTM at layer 4 among them) and
   hymba-1.5b (attention and the selective SSM side by side in each of 8
   of its 32 layers, 128 meta tokens in front of every prompt, 1024-key
   windows but on layer 0) at full width, cut so that the script keeps its
   time (their prefills are host-bound by the sLSTM's and the SSM's
   loops), nemotron-4-15b (layernorm, squared-ReLU MLP, G 6) with 16 of its 32
   layers and qwen3-moe-30b-a3b (128 experts, top 8, the MoE's
   single-shard path; qk-norm, G 8) with 8 of its 48, at full width, so
   that the fp32 initialisation and the bf16 copy fit the card,
   random weights from a seed, each through ServingEngine: 4 requests
   (prompts 512/384/256/128, one sampled at temperature 0.8) x 32 new
   tokens, with every kernel's launch count in that run (set to 0 just
   before it); the prefill logits against the same model with every kernel
   swapped for its plain version (xlstm-350m in bf16 also against the plain
   version re-chunked; hymba-1.5b in bf16 layer by layer, in the prefill
   and a decode step, at the plain run's inputs; whisper-base over seeded
   frames); prefill ms,
   decode tokens/s and peak memory; then ``"phase": "prefill"``:
   internvl2-26b's prefill at full width (d 6144, H48 KV8 D128) with 8 of
   its 48 layers, so that its fp32 initialisation fits the card: B4, 256
   seeded patch embeddings in front of a 512-token prompt, its launches and
   its logits against the plain versions;
6. profile -- device time by kernel over prefills and decode steps of each
   model (torch.profiler), and the share of the time the device is idle;
   then ``"phase": "moe"``: granite's MoE layer alone in bf16 at the
   prefill (2048 tokens) and decode (4 tokens) shapes, its time split into
   router and dispatch, expert FFN and combine, with and without the aux
   and z losses, beside the bound of the work it does and of the work it
   needs, with the tokens dropped; and the layer at the reduced width in fp32, card
   against CPU (slots and validity equal, y within atol 1e-5);
   then ``"phase": "train"``: the fp32 and the bf16 prefill kernel's lse
   and the flash-attention autograd Function (repro_torch.models.flash) on
   hazard cases against the plain version's autograd (o, lse, dq, dk, dv;
   bf16 calls with T <= 16 take the prefill kernel; head dims 16 to 256,
   G up to 12; and the lse at the training shapes of hymba-1.5b (G 5 D 64,
   T 1024 with 1024-key windows and T 640 with a 256-key window),
   internvl2-26b (G 6 D 128) and whisper-base (its encoder non-causal at
   T = S = 1500, its cross-attention at T 1024 against 1500 keys, queries
   at 0), each also timed), the mLSTM scan's autograd Function
   (repro_torch.models.xlstm.MLSTMScan: the scan kernel forward, the plain
   chunkwise backward) on its hazard cases against the plain version's
   autograd (h, dq, dk, dv, dlog_i, dlog_f), the attention forward with lse
   and the plain backward at the training shapes (B2 T1024 H24 KV8 D128,
   H4 KV1 D256 and H24 KV2 D128) beside SDPA's forward and backward and
   their bounds, the scan's forward and plain backward at xlstm-350m's (B2
   T1024 H4 D512, bf16 and fp32) beside their bounds, the reduced
   llama3.2-3b and granite-moe-3b-a800m in fp32 card against CPU (loss,
   every gradient, two train steps), and llama3.2-3b, gemma3-1b,
   starcoder2-3b and whisper-base (1500
   seeded frames, 1024 text tokens) at full width and depth,
   xlstm-350m (8 of its 24 layers, the sLSTM at layer 4 among them) and
   hymba-1.5b (8 of its 32; 128 meta tokens + 896 text tokens, its SSM's
   chunked scan under grad) at full width, cut so that the script keeps
   its time (their steps are host-bound by the loops), and
   internvl2-26b at full width with 4 of its 48 layers (256 seeded patch
   embeddings + 768 text tokens) (fp32 parameters, bf16 compute, remat
   "full") through runtime.trainer.make_train_step for 4 steps (3 for
   xlstm-350m and hymba-1.5b, whose steps are host-bound) of
   data.host_batch (B2, 1024 positions a row; launch/specs.py lays out the
   prefix): step 1 against the same step
   with the plain versions, the mLSTM scan differentiated by autograd, at
   the plain run's side of each mLSTM denominator near its kink
   (xlstm-350m in fp32 too; in bf16 its mLSTM layers one by one at the
   plain run's inputs; hymba-1.5b in fp32 at 4 of its layers, C20),
   finite losses and gradients, non-zero weight gradients in every layer
   (and in meta_tokens, the encoder's layers, the cross-attention's and
   the SSM's leaves), two kernel launches and one backward call an
   attention or mLSTM layer a step (llama 56 and 28, gemma 52 and 26,
   starcoder 60 and 30, xlstm 14 scans and 7, hymba 16 and 8, whisper 36
   and 18, internvl 8 and 4), step ms, tokens/s, peak
   memory and the idle share of a profiled step beside the step's bound
   (launch/analytic.py's ``train_cost``; for the attention models also
   ``train_step_work``);
   then ``"phase": "xlstm_sp"``: the context-parallel mLSTM
   (repro_torch.models.xlstm_sp) at xlstm-350m's width (B2 T1024 H4 D512,
   fp32) in 4 segments folded on one rank, h against the fp32 scan kernel
   over the whole sequence (relative L2 1e-4) and both against float64;
   then ``"phase": "shard"``: gemma3-1b at full width with 8 of its 26
   layers (so that the script keeps its time; the 262,144-entry
   embedding and head stay whole), B2 T1024,
   3 steps of the sharded train step (runtime.sharding: a (1, 1) "data" x
   "model" mesh of a world-1 NCCL group, ``grad_specs=grad_accum_specs``)
   against 3 unsharded steps from the same seed: losses within 1e-6
   relative, every parameter leaf within relative L2 1e-5, two prefill
   launches with lse and one backward call an attention layer a step; one
   more sharded step under FlopCounterMode (its arguments, FLOPs,
   launches and peak, for phase dryrun); then
   the sharded state saved through CheckpointManager (gathered, rank 0
   writes) and restored with ``shardings=``, equal to the bit: step ms
   beside the unsharded step's, peak memory, ``save_s``, ``restore_s``;
   the group destroyed before the phase returns;
   then ``"phase": "dryrun"`` (repro_torch.launch.dryrun): the same cell
   traced on fake CUDA tensors as rank 0 of a world-1 ``"fake"`` group,
   nothing allocated or launched, its argument bytes, FlopCounterMode's
   FLOPs and the kernel wrappers' calls by path equal to the real step's
   exactly, its peak estimate beside the real step's
   ``max_memory_allocated``; then gemma3-1b's ``prefill_32k`` cell on the
   16x16 production mesh (256 ranks): roofline terms, peak bytes a rank
   against 80 GB, ``trace_s``;
   then ``"phase": "tp"``: tensor-parallel compute (models/layers.py,
   ssm.py, xlstm.py over a ("model",) mesh) at published width:
   llama3.2-3b (8 of its 28 layers), xlstm-350m (8 of 24: the mLSTM
   head-parallel, the sLSTM whole), hymba-1.5b (4 of 32: the SSM
   channel-parallel, its 25 heads whole) and whisper-base (whole: the
   encoder, self- and cross-attention at 4 heads a rank), one line each:
   on one rank in this process, then on two ranks, two processes of this
   script (``--tp-rank``, each running every model) sharing the card over
   gloo (one card hosts one NCCL rank, ROADMAP C9): served in fp32
   (logits within 1e-5 relative L2 of the one-rank run, greedy tokens
   equal) and bf16 (5e-2; B4, 512-token prompts, 8 decode steps, the ranks
   fed the one-rank run's tokens), trained in bf16 (B2 T1024, losses and
   grad norms within 1e-2) and fp32 (2 steps: within 1e-5, the updates
   within relative L2 5e-4 over all leaves and 1e-2 a leaf), with the
   gates of the stacks that amplify rounding set from stated readings (the
   comment on TP_FULL), each rank's resident fp32 parameters, gradients,
   m and v at most 0.55 of one rank's, each kernel's launches a prefill,
   a decode run and a train step as the layers give them, every attention
   call and mLSTM scan at a rank's heads; ``"phase": "tp_times"`` prints
   both runs' prefill, decode step and train step ms and each rank's peak
   memory; the kernels are timed alone at a rank's shapes (llama's
   attention at H12 KV4 D128, with lse at B2 T1024; the mLSTM scan at H2
   D512, B4 T512 and B2 T1024; whisper's encoder, cross-attention and
   cross decode at H4, with lse at B2);
   then ``"phase": "extract"``: the collectives of a training step,
   recorded as the step posts them (repro_torch.workload.extract) in one
   process as rank 0 of an 8-rank recording group (torch's "fake"
   backend: every call posted, no data moved, outputs not results),
   lowered into a phased workload and replayed on CIN-xor-8 on the card, on
   the CPU and on the numpy oracle, all equal and at least the bound:
   granite-moe-3b-a800m's MoE layer forward (B4 T512 a rank, 6 of 48
   experts a rank: 14 permutes of 9,437,184 B, 2,016 cycles at 64 KiB a
   packet) and llama3.2-3b's manual-DP train step (B8 T1024, B1 a rank:
   2(N-1) permutes a leaf and one all-reduce of 4 B, at 1 MiB a packet; its
   56 prefill launches, counts set to 0 just before it); ``python -m
   repro_torch.workload extract`` and ``replay --backend both`` for the
   reference's three steps as processes of their own (moe 14 phases, 896
   packets, 112 cycles; dp 182, 3,360, 420; pipeline 11, 84, 26); and the
   llama serve run's ``arrival_trace()`` as serving traffic on CIN-16,
   swept card against CPU;
7. sim     -- the simulator's main path (repro_torch.sim), which runs no
   hand-written kernel: ``sim_speed`` (CIN xor 16, 3 loads x 8 seeds x
   1600 cycles in one sweep) and ``xl_scale`` (a 1040-switch Dragonfly,
   256 cycles), each bit for bit against the same engine on the CPU,
   with lane-cycles/s or cycles/s cold
   and warm, CUDA-graph capture apart from replay, device ms per cycle in
   the graph and eager, kernels per cycle and a profile of graph replays;
   then drained runs: a one-shot all-to-all against the closed-form link
   loads, and Valiant and adaptive sweeps on a Dragonfly against the CPU;
   then ``devices=`` (``"phase": "sim_blocks"``): ``"auto"`` and the
   copies split into two blocks on the card (``xengine._block_sweep``)
   against one program, to the bit, on a uniform sweep of 4 points and a
   collective replay of 4 copies, with both wall times;
8. studies -- the studies path (repro_torch.studies) at the bundled specs'
   own sizes on the torch engine: ``python -m repro_torch.studies run
   collective_replay`` as a subprocess (minimal replays at the
   contention-free bound on CIN-16 and HyperX-256, 142 cycles against 32
   on Dragonfly-72; all six records equal to the same Study on the CPU),
   then ``cin16_saturation`` (knees equal to the numpy oracle's, one
   experiment record for record against the CPU), ``hyperx256_uniform``
   and ``dragonfly72_uniform`` through ``Study.run()``; one line per spec
   with its points, cold and warm wall seconds, lane-cycles/s, summed
   capture, replay and host seconds, and completions or knees;
9. faults  -- ``failure_sweep`` (degraded CIN-16, HyperX-256 and
   Dragonfly-72 at 0, 5 and 10% link failure) through ``Study.run()``:
   the f0 experiments against the pristine grids, the CIN-16 experiments
   against the CPU record for record, the degraded CIN-16 knees against
   the numpy oracle's, knees non-increasing in the failure rate, and the
   degraded tables' host time;
10. flow   -- ``python -m repro_torch.studies run flow_scale_smoke`` (a
   4096-switch HyperX, which "auto" takes to the flow tier) as a
   subprocess on the card and on the CPU, records equal and within rtol
   1e-12 of the numpy solver; where a flow grid point's time goes (routes,
   upload, solver iterations and ms, RunStats); ``cin16_saturation``'s
   flow knees against its cycle knees;
11. trace  -- every ``collective_replay`` experiment as a traced sweep on
   the card against the CPU (every trace array, every RunStats field, and
   the untraced run's), kernels per cycle untraced and traced, and
   ``trace export --backend both`` as a subprocess, its JSON validated;
12. serving -- the graph cache from empty (``sim_speed`` twice: a capture,
   then a memory hit equal to it; kernels per cycle and blocks per call
   with and without shape bucketing; ``collective_replay`` cold and warm,
   its capture seconds), then ``python -m repro_torch.studies run
   serving_slo`` and ``python -m repro_torch.workload slo`` on each of its
   experiments as processes of their own (records equal to the CPU's, the
   CIN-16 experiments' request counts and attainment equal to the numpy
   oracle's, every search's probes and capacity equal to the CPU's), and
   an MMPP serving sweep on ``xl_scale``'s 1040-switch Dragonfly against
   the CPU, with the host seconds of its request metrics.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that last line; so does a machine without CUDA.  Imports only torch,
numpy and repro_torch.

Three more runs, each alone: ``python3 chip_smoke.py --xlstm-witness
[OUT.json]`` reads xlstm-350m's step 1 in float64, fp32 and bf16, with the
kernels and the plain versions and mixes of the two precisions, layer by
layer against float64 (every reading into OUT.json); ``python3
chip_smoke.py --gelu-ab`` times gemma3-1b's prefill, decode step and
train step with each way of computing its gelu, ``--silu-ab``
llama3.2-3b's (the same three) and granite-moe-3b-a800m's (prefill and
decode step) with F.silu and with the silu op by op.
"""
import collections
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mlstm_scan as ms  # noqa: E402
from repro_torch.kernels.ref import (reference_attention,  # noqa: E402
                                     reference_mlstm_scan,
                                     reference_mlstm_scan_float64)
from repro_torch.data import DataConfig, host_batch  # noqa: E402
from repro_torch.models import get_config, init_params  # noqa: E402
from repro_torch.models import flash as MF  # noqa: E402
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models import xlstm as MX  # noqa: E402
from repro_torch.models import xlstm_sp as XSP  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.launch import analytic  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch import sim as S  # noqa: E402
from repro_torch.core import DragonflyConfig  # noqa: E402
from repro_torch.core.simulate import cin_link_loads  # noqa: E402
from repro_torch.fabric import make_fabric  # noqa: E402
from repro_torch.sim.workloads import collective_workload  # noqa: E402
from repro_torch.sim import xengine as XE  # noqa: E402
from repro_torch import studies as ST  # noqa: E402
from repro_torch import workload as W  # noqa: E402
from repro_torch.workload import extract as XT  # noqa: E402
from repro_torch.obs import telemetry  # noqa: E402
from repro_torch.optim import OptConfig, adamw_update  # noqa: E402
from repro_torch.runtime import trainer as TR  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor cores
              torch.float32: 67e12}        # fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The fp32 tensor-core kernels form each fp32 product from bf16 terms, the
# term products a_i b_j with i + j < FP32_TERMS: 6 at 3 terms a side.
SPLIT_PRODUCTS = fa.FP32_TERMS * (fa.FP32_TERMS + 1) // 2
# mLSTM chunk scan, as tests/test_kernels.py holds the Pallas kernel: h in
# q's dtype; the final state is fp32 on both sides and held to the fp32 tol.
MLSTM_TOL = {torch.float32: dict(rtol=5e-4, atol=5e-5),
             torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}

# name: (b, t, s, h, kvh, d, q_pos, causal, window); q_pos None = arange(t),
# "tail" = the last t of s positions.
HAZARDS = {
    "gqa3_d128_odd_t_s": (2, 131, 131, 6, 2, 128, None, True, 0),
    "gqa3_d16_odd_tail": (2, 37, 101, 6, 2, 16, "tail", True, 0),
    "gqa2_d32": (2, 100, 100, 4, 2, 32, None, True, 0),
    "mqa_d64_tail": (1, 200, 333, 4, 1, 64, "tail", True, 0),
    "window7_d64": (2, 150, 150, 6, 2, 64, None, True, 7),
    "window64_d128": (2, 150, 150, 6, 2, 128, None, True, 64),
    "noncausal_d128": (1, 70, 190, 6, 2, 128, None, False, 0),
    "noncausal_window": (1, 70, 190, 3, 1, 64, "tail", False, 33),
    "decode_t1_s1024": (4, 1, 1024, 24, 8, 128, [700], True, 0),
    "decode_window": (4, 1, 1024, 24, 8, 128, [700], True, 100),
    "fully_masked_rows": (1, 16, 40, 6, 2, 128, [-5] * 16, True, 0),
    "some_rows_masked": (2, 80, 80, 6, 2, 64, list(range(-40, 40)), True, 0),
    # bf16 switches from the decode kernel (T <= 16) to the prefill kernel
    "decode_t16": (2, 16, 300, 6, 2, 128, "tail", True, 0),
    "prefill_t17": (2, 17, 300, 6, 2, 128, "tail", True, 0),
    "decode_t2_d64": (2, 2, 200, 6, 2, 64, "tail", True, 0),
    "decode_t8_gqa4_d32": (3, 8, 257, 8, 2, 32, "tail", True, 0),
    # group sizes G = H/KV of 1, 4 and 8, prefill and decode
    "mha_g1_d64": (2, 150, 150, 4, 4, 64, None, True, 0),
    "decode_g1": (2, 1, 300, 4, 4, 128, [250], True, 0),
    "gqa4_d128_tail": (1, 100, 140, 8, 2, 128, "tail", True, 0),
    "gqa8_d64": (1, 90, 90, 16, 2, 64, None, True, 0),
    "decode_gqa8_t16": (1, 16, 200, 16, 2, 64, "tail", True, 0),
    # D = 16 on the tensor cores, and S below one 64-key tile
    "d16_gqa4": (2, 70, 70, 8, 2, 16, None, True, 0),
    "decode_d16": (2, 1, 100, 6, 2, 16, [77], True, 0),
    "s_below_tile": (2, 40, 40, 6, 2, 128, None, True, 0),
    "decode_s_below_tile": (2, 1, 40, 6, 2, 64, [30], True, 0),
    # a window edge inside a split, a decode row that sees nothing (every
    # split empty), one (batch, KV head) over many splits
    "decode_window_edge": (2, 1, 1024, 6, 2, 128, [700], True, 97),
    "decode_all_masked": (2, 1, 512, 6, 2, 128, [-3], True, 0),
    "decode_bkv1": (1, 1, 2048, 4, 1, 128, [1500], True, 0),
    # G = 12 (starcoder2-3b, H24 KV2): prefill blocks of 16 positions (5 at
    # D = 256), decode rows of a group over 1 and 2 chunks
    "gqa12_odd_t": (2, 150, 150, 24, 2, 128, None, True, 0),
    "gqa12_window_tail": (1, 100, 300, 24, 2, 128, "tail", True, 50),
    "decode_gqa12": (4, 1, 1024, 24, 2, 128, [527], True, 0),
    "decode_gqa12_t8": (2, 8, 300, 24, 2, 128, "tail", True, 0),
    # G = 5 (hymba-1.5b, H25 KV5 D64): prefill blocks of 38 positions, 190
    # of the 192 rows used; G = 6 (internvl2-26b, H48 KV8 D128): 32
    # positions; at D 64 and 128, prefill and decode, windows that bind
    "gqa5_d64_window": (2, 300, 300, 10, 2, 64, None, True, 100),
    "gqa5_d128_window_tail": (1, 200, 500, 10, 2, 128, "tail", True, 128),
    "gqa6_d128_window": (2, 300, 300, 12, 2, 128, None, True, 100),
    "gqa6_d64_window_tail": (1, 150, 400, 12, 2, 64, "tail", True, 64),
    "decode_gqa5_window": (4, 1, 1024, 25, 5, 64, [700], True, 100),
    "decode_gqa5_d128_t8": (2, 8, 700, 10, 2, 128, "tail", True, 300),
    "decode_gqa6_window": (4, 1, 1024, 48, 8, 128, [700], True, 100),
    "decode_gqa6_d64_t4": (2, 4, 600, 12, 2, 64, "tail", True, 64),
    # whisper-base (H8 KV8 D64): the encoder, non-causal at T = S = 1500
    # (S not a multiple of the 64-key tile), and cross-attention, queries
    # at position 0 against 1500 keys, at prefill (T 512) and decode (T 1)
    "noncausal_t1500": (1, 1500, 1500, 8, 8, 64, None, False, 0),
    "cross_t512_s1500": (2, 512, 1500, 8, 8, 64, [0] * 512, False, 0),
    "cross_decode_s1500": (4, 1, 1500, 8, 8, 64, [0], False, 0),
    # the fp32 tensor-core kernel's hazards: rows of q and k whose entries
    # span 1e-3 to 1e3 (reciprocal column scales: scores stay O(1)) and v's
    # columns from 1 to 1e-6 (make_inputs' ``wide``); G = 5 with T not a
    # multiple of its blocks (25 positions, 12 at D = 256); D = 16 with a
    # window; queries at positions 300-339 of a 1024-slot cache filled to
    # 339
    "wide_range_d64": (2, 150, 150, 6, 2, 64, None, True, 0),
    "wide_range_d256": (1, 100, 100, 4, 1, 256, None, True, 0),
    "gqa5_d256_odd_t": (1, 77, 77, 10, 2, 256, None, True, 0),
    "gqa5_d16_window": (2, 131, 131, 10, 2, 16, None, True, 20),
    "cache_past_fill": (2, 40, 1024, 6, 2, 128, list(range(300, 340)), True,
                        0),
}
ALL_MASKED = ("fully_masked_rows", "decode_all_masked")

# name: (b, t, h, d, chunk, gates); gates "normal", "forget_near_zero"
# (log_f << 0), "forget_near_one" (log_f ~ 0: C sums every step of T),
# "large_log_i" (the stabilizer dominates) or "state" (a given initial
# state), "forget_near_one_state" both.  Calls with a chunk that is a
# multiple of 16 take the tensor-core kernel of their dtype (fp32: in split
# precision), the others the FMA kernel (chunk24_bf16, in either dtype).
# The last is the serving shape of xlstm-350m.
MLSTM_HAZARDS = {
    "d16": (1, 64, 1, 16, 16, "normal"),
    "d32": (2, 128, 3, 32, 32, "normal"),
    "d64_four_chunks": (2, 256, 2, 64, 64, "normal"),
    "d128": (1, 256, 2, 128, 128, "normal"),
    "d512": (1, 512, 2, 512, 256, "normal"),
    "chunk48": (1, 96, 2, 32, 48, "normal"),
    "forget_near_zero": (1, 256, 2, 64, 64, "forget_near_zero"),
    "large_log_i": (1, 256, 2, 64, 64, "large_log_i"),
    "initial_state": (2, 128, 2, 128, 64, "state"),
    "bh1": (1, 256, 1, 128, 64, "normal"),
    "forget_near_one": (1, 1024, 2, 512, 256, "forget_near_one"),
    "many_chunks_d512": (1, 1024, 1, 512, 64, "normal"),
    "state_d512": (2, 512, 2, 512, 256, "state"),
    "d48": (1, 128, 2, 48, 32, "normal"),
    "chunk16_d64": (1, 64, 2, 64, 16, "normal"),
    "chunk24_bf16": (1, 96, 2, 32, 24, "normal"),
    # D = 512 over many chunks, from a given state
    "forget_near_one_state": (1, 1024, 2, 512, 256, "forget_near_one_state"),
    "many_chunks_d512_state": (1, 1024, 1, 512, 64, "state"),
    "serving": (4, 512, 4, 512, 256, "normal"),
}
LF_SHIFT = {"forget_near_zero": -20.0, "forget_near_one": 20.0,
            "forget_near_one_state": 20.0}
MLSTM_NO_LIBRARY = "no single PyTorch call computes chunkwise mLSTM"

# The dtype in which each served model's prefill logits are held against the
# same model with every kernel swapped for its plain version (relative L2
# LOGITS_TOL).  xlstm-350m is held in float32, on its bf16 weights: in bf16
# its 21 mLSTM layers amplify rounding so far that at full depth the plain
# version differs from itself re-chunked (chunk 128 for 256, the same
# function) by a relative L2 of about 0.3, and no implementation can meet
# 5e-2 there.  Its bf16 logits are held to that floor instead
# (prefill_logits_check): the differences that re-chunking the plain
# version (chunk 256) into each of RECHUNKS makes, their mean plus three
# standard deviations.  hymba-1.5b is held in float32 too: at random
# initialisation its stack amplifies a perturbation of its input with depth
# (each layer adds the unit-RMS normalised attention and SSM outputs to the
# residual stream, which nothing damps), and bf16 rounding is such a
# perturbation in every layer.  In bf16 its plain version is about 0.15 from
# itself in fp32 at full depth, as the reference's own bf16 is from its fp32
# at 32 layers (tests/test_torch_model.py::
# test_hymba_bf16_drift_at_depth_is_the_references).  In bf16 each of its
# layers is held alone, in the prefill and in a decode step
# (hymba_layers_check), and the whole model is reported beside the fp32
# plain version's answer to relative noise of INPUT_NOISE on its input.
RECHUNKS = (16, 32, 64, 128, 512)
LOGITS_TOL = 5e-2
LOGITS_CHECK_DTYPE = {"llama3.2-3b": "bfloat16", "xlstm-350m": "float32",
                      "granite-moe-3b-a800m": "bfloat16",
                      "gemma3-1b": "bfloat16", "starcoder2-3b": "bfloat16",
                      "hymba-1.5b": "float32", "whisper-base": "bfloat16",
                      "nemotron-4-15b": "bfloat16",
                      "qwen3-moe-30b-a3b": "bfloat16"}
#: Served cut in depth alone, so that the fp32 initialisation and the bf16
#: copy fit the card: nemotron-4-15b 16 of 32 layers (9.39 B parameters,
#: 37.6 GB fp32 + 18.8 GB bf16), qwen3-moe-30b-a3b 8 of 48 (5.6 B); and so
#: that chip_smoke.py keeps its time limit: xlstm-350m 8 of 24 (its sLSTM
#: at layer 4 among them) and hymba-1.5b 8 of 32, whose prefills are
#: host-bound by the sLSTM's and the SSM's loops over positions.
SERVE_LAYERS = {"nemotron-4-15b": 16, "qwen3-moe-30b-a3b": 8,
                "xlstm-350m": 8, "hymba-1.5b": 8}
INPUT_NOISE = 2.0 ** -9                  # half a bf16 ulp, relative

# The serving runs: 4 slots, prompts left-padded to 512, a 1024-slot cache.
PROMPTS = (512, 384, 256, 128)
MAX_SEQ, NEW_TOKENS = 1024, 32
DECODE_POS = 527                           # a fill position the run decodes at


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls, replays=5):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed ``replays`` times between CUDA events.
    The host's time to issue each call (Python, allocation, launch) is left
    out; ``cuda_ms`` of the same calls keeps it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def model_extras(cfg, b, rng, device):
    """The encoder's frames and the patch embeddings, where ``cfg`` takes
    them, drawn from ``rng`` and scaled by 0.02 (as the reference's tests
    draw these stubs)."""
    out = {}
    for name, on, length in (("frames", cfg.is_encdec, cfg.encoder_seq_len),
                             ("patch_embeds", cfg.num_patch_tokens,
                              cfg.num_patch_tokens)):
        if on:
            out[name] = torch.from_numpy((rng.normal(
                size=(b, length, cfg.d_model)) * 0.02).astype(
                    np.float32)).to(device)
    return out


def make_inputs(b, t, s, h, kvh, d, q_pos, dtype, seed, copies=1,
                wide=False):
    """q, ``copies`` (k, v) pairs and q's positions.  With ``wide`` q's
    and k's columns are scaled by reciprocal factors from 1e-3 to 1e3 and
    v's by factors from 1 to 1e-6."""
    rng = np.random.default_rng(seed)
    span = (10.0 ** np.linspace(-3, 3, d) if wide else np.ones(d)).astype(
        np.float32)

    def draw(*shape, scale):
        x = rng.normal(size=shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(device="cuda", dtype=dtype)
    q = draw(b, t, h, d, scale=span)
    kvs = [(draw(b, s, kvh, d, scale=1 / span),
            draw(b, s, kvh, d, scale=span[::-1] / 1e3 if wide else span))
           for _ in range(copies)]
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    if q_pos is None:
        q_pos = list(range(t))
    return q, kvs, torch.tensor(q_pos, dtype=torch.int32, device="cuda")


def bound(q, k, q_pos, kv_pos, causal, window):
    """Least time the card could take: the bytes of the kernel's work()
    at the memory's rate or its operations at the peak of q's type (fp32:
    the FMA pipe), whichever is longer."""
    nbytes, flops = fa.work(q, k, q_pos, kv_pos, causal=causal,
                            window=window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def split_floor(nbytes, flops):
    """Least time of fp32 work on the tensor cores in split precision:
    ``flops`` as SPLIT_PRODUCTS bf16 products each at the bf16 peak, or
    ``nbytes`` at the memory's rate, whichever is longer (ms)."""
    return max(nbytes / HBM_BYTES_PER_S,
               SPLIT_PRODUCTS * flops / PEAK_FLOPS[torch.bfloat16]) * 1e3


def check_close(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    worst = float((err - tol * want.float().abs()).max())
    if not worst <= tol:
        raise AssertionError(f"{name} {dtype}: kernel and plain version differ "
                             f"by up to {float(err.max())} (atol = rtol = {tol})")
    return float(err.max())


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def ptxas_summary(text):
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` report: its
    name and all its template arguments as mangled (``ILi32ELi256EE``: 32,
    256), registers, and spills."""
    lines, name, spill = [], "?", ""
    for line in text.splitlines():
        if "entry function" in line:
            # the kernel's name is the one preceded by its length
            for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel))", line):
                if len(m.group(2)) == int(m.group(1)):
                    args = re.match(r"I(?:Li-?\d+E|\d+__nv_bfloat16|[a-z])+E",
                                    line[m.end(2):])
                    name = m.group(2) + (args.group(0) if args else "")
                    break
        elif "spill" in line:
            spill = line.strip()
        elif re.search(r"Used \d+ registers", line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def phase_build():
    t0 = time.perf_counter()
    reports = _build.build_all()
    fa._library()
    ms._library()
    ptxas = [line for text in reports.values() for line in ptxas_summary(text)]
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(reports),
         ptxas=ptxas, kernels_that_spill=[
             line for line in ptxas if "0 bytes spill stores" not in line])


def phase_hazards(head_dim=None):
    """Every case of HAZARDS in both dtypes; with ``head_dim``, every case
    at that head dim instead (named ``<case>@d<head_dim>``).  Rows that see
    no key must be zeros; at least one decode case must span more than one
    row chunk (at D = 256: G x T > 32)."""
    t0 = time.perf_counter()
    worst = {}
    chunked = []
    for case, (b, t, s, h, kvh, d, q_pos, causal, window) in HAZARDS.items():
        name = case
        if head_dim is not None:
            name, d = f"{case}@d{head_dim}", head_dim
        for dtype in (torch.float32, torch.bfloat16):
            q, [(k, v)], qp = make_inputs(b, t, s, h, kvh, d, q_pos, dtype,
                                          seed=sum(map(ord, name)),
                                          wide=case.startswith("wide_range"))
            kw = dict(q_pos=qp, causal=causal, window=window)
            plan = fa.plan(b, t, s, h, kvh, d, dtype)
            path = plan.path
            if path == "decode" and plan.row_chunks > 1:
                chunked.append(name)
            before = fa.launches, fa.launches_by_path[path]
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if (fa.launches, fa.launches_by_path[path]) != (before[0] + 1,
                                                            before[1] + 1):
                raise AssertionError("the wrapper did not count its launch")
            err = check_close(name, got, reference_attention(q, k, v, **kw),
                              dtype)
            if case in ALL_MASKED and got.any():
                raise AssertionError(f"{name}: fully masked rows are not "
                                     f"zeros")
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst.get(key, 0.0), err)
            emit("kernel_case", kernel="flash_attention", case=name,
                 path=path, dtype=key, block_q=plan.block_q,
                 row_chunks=plan.row_chunks, max_abs_err=err, tol=TOL[dtype])
    if not chunked:
        raise AssertionError("no decode case spans more than one row chunk")
    emit("kernel_hazards", kernel="flash_attention", cases=len(HAZARDS) * 2,
         head_dim=head_dim or "as listed", max_abs_err=worst,
         decode_cases_over_row_chunks=sorted(set(chunked)),
         seconds=time.perf_counter() - t0)


def sdpa_backend(q, k, v, attn_mask=None, is_causal=False):
    """The backend ``F.scaled_dot_product_attention`` picks for these
    (B, H, T, D) inputs with GQA on: PyTorch's own choice
    (``torch._fused_sdp_choice``, the function its dispatcher asks), by
    name: CUDNN_ATTENTION, FLASH_ATTENTION, EFFICIENT_ATTENTION or MATH."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, is_causal,
                                     enable_gqa=True)
    return SDPBackend(choice).name


def time_attention(label, b, t, s, h, kvh, d, q_pos, copies,
                   dtype=torch.bfloat16, phase="kernel_timing", causal=True,
                   **tags):
    """Kernel, plain version and SDPA at one serving shape, each timed on
    the device alone (``graph_ms``: ``ms``, ``plain_ms``, ``library_ms``)
    and per call with the host's time to issue it (``cuda_ms``: the
    ``*_eager`` keys).  In fp32 ``split_floor_ms`` is the split's least
    time (split_floor).  With ``copies`` > 1 the calls cycle over that many
    K/V caches, so that they find the cache in device memory and not in the
    50 MB L2, as each layer of a decode step does.  SDPA gets no mask where
    every key is visible, ``is_causal`` for aligned causal calls and the
    visibility mask otherwise."""
    t0 = time.perf_counter()
    q, kvs, qp = make_inputs(b, t, s, h, kvh, d, q_pos, dtype, seed=t + s,
                             copies=copies)
    kp = torch.arange(s, dtype=torch.int32, device="cuda")
    k, v = kvs[0]
    kw = dict(q_pos=qp, kv_pos=kp, causal=causal, window=0)
    err = check_close(label, fa.flash_attention(q, k, v, **kw),
                      reference_attention(q, k, v, **kw), dtype)
    mask = fa.visible(qp, kp, causal, 0)
    turn = [0]

    def cycle(fn):
        def call():
            k_, v_ = kvs[turn[0] % copies]
            turn[0] += 1
            return fn(q, k_, v_)
        return call

    sdpa_kw = ({} if bool(mask.all()) else dict(is_causal=True)
               if causal and t == s else dict(attn_mask=mask))

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            enable_gqa=True, **sdpa_kw)

    calls = {"kernel": cycle(lambda *a: fa.flash_attention(*a, **kw)),
             "plain": cycle(lambda *a: reference_attention(*a, **kw)),
             "library": cycle(sdpa)}
    order = ("kernel", "plain", "library", "kernel")
    fp32 = {}
    iters = 48                  # a multiple of copies (8)
    times = {}
    for timer, suffix in ((graph_ms, ""), (cuda_ms, "_eager")):
        for name in order:
            key = name + suffix
            times[key + ("_repeat" if key in times else "")] = timer(
                calls[name], iters)
    bound_ms, bound_by = bound(q, k, qp, kp, causal, 0)
    if dtype == torch.float32:
        fp32.update(split_floor_ms=split_floor(*fa.work(
            q, k, qp, kp, causal=causal, window=0)))
    backend = sdpa_backend(*(x.transpose(1, 2) for x in (q, k, v)),
                           **sdpa_kw)
    key = str(dtype).removeprefix("torch.")
    how = "causal" if causal else "non-causal"
    out = dict(shape=f"B{b} T{t} S{s} H{h} KV{kvh} D{d} {key} {how}",
               path=fa.plan(b, t, s, h, kvh, d, dtype).path,
               max_abs_err=err, tol=TOL[dtype], ms=times["kernel"],
               ms_repeat=times["kernel_repeat"], plain_ms=times["plain"],
               library_ms=times["library"], library_backend=backend,
               bound_ms=bound_ms,
               bound_by=bound_by, ms_eager=times["kernel_eager"],
               ms_eager_repeat=times["kernel_eager_repeat"],
               plain_ms_eager=times["plain_eager"],
               library_ms_eager=times["library_eager"], **fp32,
               seconds=time.perf_counter() - t0)
    emit(phase, kernel="flash_attention", case=label, **tags, **out)
    return out


def mlstm_inputs(b, t, h, d, gates, dtype, seed):
    """q, k, v in ``dtype``; log_i, log_f fp32; the initial state or None."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        x = rng.normal(size=shape).astype(np.float32) * scale + shift
        return torch.from_numpy(x).cuda()
    qkv = [draw(b, t, h, d).to(dtype) for _ in range(3)]
    li = draw(b, t, h, scale=2.0, shift=40.0 if gates == "large_log_i" else 0.0)
    lf = F.logsigmoid(draw(b, t, h, scale=2.0, shift=LF_SHIFT.get(gates, 1.0)))
    state = None
    if gates.endswith("state"):
        state = (draw(b, h, d, d, scale=0.1), draw(b, h, d).abs(), draw(b, h))
    return (*qkv, li, lf), state


def mlstm_bound(q, chunk, state):
    """Least time the card could take for one mlstm_scan call: each input
    read once and h and the final state written once, against the
    multiply-adds of the chunkwise algorithm at the peak of q's type (bf16:
    the tensor cores; fp32: the fp32 pipe): per (batch, head) and chunk of L
    rows, q k^T and p v over the causal L(L+1)/2 pairs, and q C0, q n0 and
    the k^T w v, k^T w state update over D x D.  The first chunk's q C0 and
    q n0 are left out when there is no initial state: they are zeros.
    Returns (bound ms, what bounds it, the same bound with the operations on
    the fp32 pipe, multiply-adds, bytes)."""
    nbytes, operations = ms.work(q, chunk, state)
    macs = operations // 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_FLOPS[q.dtype] * 1e3
    t_ops_fp32 = 2 * macs / PEAK_FLOPS[torch.float32] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, t_ops_fp32), macs, nbytes)


def check_mlstm(name, got, want, dtype):
    """h (tol of ``dtype``) and the final C, n, m (fp32 tol); returns the
    largest |error| of h and of the state."""
    errs = []
    for what, g, w, tol in (("h", got[0], want[0], MLSTM_TOL[dtype]),
                            *zip("Cnm", got[1], want[1],
                                 [MLSTM_TOL[torch.float32]] * 3)):
        err = (g.float() - w.float()).abs()
        excess = float((err - tol["rtol"] * w.float().abs()).max())
        if not excess <= tol["atol"]:
            raise AssertionError(
                f"mlstm_scan {name} {dtype}: {what} of the kernel and the "
                f"plain version differ by up to {float(err.max())} ({tol})")
        errs.append(float(err.max()))
    return errs[0], max(errs[1:])


def scan_parts(out):
    """A scan's (h, (C, n, m)) as the dict mlstm_scan.check_fp32 reads."""
    return dict(zip("hCnm", (out[0], *out[1])))


def check_mlstm_fp32(name, got, want, args, state, chunk):
    """An fp32 scan ``got`` against its plain version ``want`` on ``args``
    (and ``state``) by mlstm_scan.check_fp32 (ROADMAP C21): held to the
    plain version element by element where that version meets float64,
    else to float64 row by row and by its count of elements outside
    MLSTM_TOL, against the plain version's and the FMA kernel's.  Returns
    the readings and the largest |error| of h and of the state against the
    plain version."""
    fma = (scan_parts(fma_scan(*args, chunk=chunk, state=state))
           if args[0].is_cuda else None)
    readings = ms.check_fp32(
        scan_parts(got), scan_parts(want),
        scan_parts(mlstm_float64(args, state, chunk)), fma,
        MLSTM_TOL[torch.float32])
    if not readings["ok"]:
        raise AssertionError(f"mlstm_scan {name} float32: the kernel fails "
                             f"the fp32 check: {readings}")
    errs = [float((g - w).abs().max()) for g, w in zip(
        (got[0], *got[1]), (want[0], *want[1]))]
    return readings, errs[0], max(errs[1:])


def mlstm_path(chunk, dtype):
    """The kernel plan() gives a scan: a chunk that is a multiple of 16
    takes the tensor-core kernel of its dtype, any other the FMA kernel."""
    if chunk % 16:
        return "fma"
    return "tc" if dtype == torch.bfloat16 else "tc_f32"


def phase_mlstm_hazards():
    """Each hazard in fp32 (check_mlstm_fp32) and bf16 (check_mlstm) through
    the wrapper.  Returns the launches of this run: the chunk24_bf16 case
    is the one that takes the FMA kernel in each dtype."""
    worst = {}
    before_run = kernel_launches()
    for name, (b, t, h, d, chunk, gates) in MLSTM_HAZARDS.items():
        for dtype in (torch.float32, torch.bfloat16):
            args, state = mlstm_inputs(b, t, h, d, gates, dtype,
                                       seed=sum(map(ord, name)))
            path = ms.plan(b, t, h, d, chunk, dtype, state is not None).path
            if path != mlstm_path(chunk, dtype):
                raise AssertionError(f"mlstm_scan {name} {dtype}: path {path}")
            before = ms.launches, ms.launches_by_path[path]
            got = ms.mlstm_scan(*args, state, chunk=chunk)
            torch.cuda.synchronize()
            if (ms.launches, ms.launches_by_path[path]) != (before[0] + 1,
                                                            before[1] + 1):
                raise AssertionError("the wrapper did not count its launch")
            want = reference_mlstm_scan(*args, state, chunk=chunk)
            readings = {}
            if dtype == torch.float32:
                readings, err_h, err_state = check_mlstm_fp32(
                    name, got, want, args, state, chunk)
            else:
                err_h, err_state = check_mlstm(name, got, want, dtype)
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst.get(key, 0.0), err_h)
            worst["state"] = max(worst.get("state", 0.0), err_state)
            emit("kernel_case", kernel="mlstm_scan", case=name, path=path,
                 dtype=key,
                 shape=f"B{b} T{t} H{h} D{d} chunk {chunk} {gates}",
                 max_abs_err=err_h, state_max_abs_err=err_state,
                 tol=MLSTM_TOL[dtype], **readings)
    launched = {k: n - before_run[k] for k, n in kernel_launches().items()}
    emit("kernel_hazards", kernel="mlstm_scan", cases=len(MLSTM_HAZARDS) * 2,
         max_abs_err=worst, launches=launched)
    return launched


def mlstm_float64(args, state, chunk):
    """The plain version in float64 on these inputs: h and (C, n, m)."""
    return reference_mlstm_scan_float64(*args, state, chunk=chunk)


def fma_scan(q, k, v, log_i, log_f, *, chunk, state=None):
    """csrc/mlstm_scan.cu (the FMA kernel) on these inputs whatever their
    type and chunk: the kernel that calls of either dtype took before the
    tensor-core kernels, timed and checked beside them.  Called here, not
    through the wrapper, so that it counts no launch."""
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    c = q.new_empty((b, h, d, d), dtype=torch.float32)
    n = q.new_empty((b, h, d), dtype=torch.float32)
    m = q.new_empty((b, h), dtype=torch.float32)
    err = ms._kernel("fma")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
        log_f.data_ptr(),
        *((None,) * 3 if state is None else (x.data_ptr() for x in state)),
        out.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), b, t, h, d, chunk, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan fma kernel launch failed: {err}")
    return out, (c, n, m)


def time_mlstm(dtype, shape=None, **tags):
    """Kernel and plain version at the serving shape of xlstm-350m (or
    ``shape``, (b, t, h, d): a tensor-parallel rank's), cycling
    over 8 input sets so that each call finds them in device memory and not
    in the 50 MB L2, as each layer of a prefill does: on the device alone
    (``graph_ms``: ``ms``, ``plain_ms``) and per eager call with the host's
    time to issue it (``cuda_ms``: the ``*_eager`` keys).  The FMA kernel,
    which calls of both dtypes took before the tensor-core kernels, is
    timed beside it (``fma_ms``); in fp32 ``split_floor_ms`` is the least
    time of the same work on the tensor cores in split precision
    (split_floor) and the kernel is held by check_mlstm_fp32 (C21)."""
    b, t, h, d, chunk, gates = MLSTM_HAZARDS["serving"]
    if shape is not None:
        b, t, h, d = shape
    sets = [mlstm_inputs(b, t, h, d, gates, dtype, seed=i)[0]
            for i in range(8)]
    want = reference_mlstm_scan(*sets[0], chunk=chunk)
    got = ms.mlstm_scan(*sets[0], chunk=chunk)
    fma = fma_scan(*sets[0], chunk=chunk)
    out = {}
    if dtype == torch.float32:
        out, err_h, err_state = check_mlstm_fp32("serving", got, want,
                                                 sets[0], None, chunk)
        out["fma_max_abs_err"] = float((fma[0] - want[0]).abs().max())
    else:
        err_h, err_state = check_mlstm("serving", got, want, dtype)
        out["fma_max_abs_err"] = check_mlstm("serving (fma)", fma, want,
                                             dtype)[0]
    turn = [0]

    def cycle(fn):
        def call():
            args = sets[turn[0] % len(sets)]
            turn[0] += 1
            return fn(*args, chunk=chunk)
        return call

    calls = {"kernel": cycle(ms.mlstm_scan), "plain": cycle(reference_mlstm_scan),
             "fma": cycle(fma_scan)}
    order = ["kernel", "plain", "fma", "kernel"]
    iters = 16                  # a multiple of the 8 input sets
    times = {}
    for timer, suffix in ((graph_ms, ""), (cuda_ms, "_eager")):
        for name in order:
            key = name + suffix
            times[key + ("_repeat" if key in times else "")] = timer(
                calls[name], iters)
    bound_ms, bound_by, bound_fp32_ms, macs, nbytes = mlstm_bound(
        sets[0][0], chunk, None)
    if dtype == torch.float32:
        out["split_floor_ms"] = split_floor(nbytes, 2 * macs)
    key = str(dtype).removeprefix("torch.")
    out.update(shape=f"B{b} T{t} H{h} D{d} chunk {chunk} {key}",
               path=ms.plan(b, t, h, d, chunk, dtype).path,
               max_abs_err=err_h, state_max_abs_err=err_state,
               tol=MLSTM_TOL[dtype], ms=times["kernel"],
               ms_repeat=times["kernel_repeat"], plain_ms=times["plain"],
               ms_eager=times["kernel_eager"],
               ms_eager_repeat=times["kernel_eager_repeat"],
               plain_ms_eager=times["plain_eager"], library_ms=None,
               library_note=MLSTM_NO_LIBRARY, bound_ms=bound_ms,
               bound_by=bound_by, bound_ms_fp32_pipe=bound_fp32_ms,
               multiply_adds=macs, bytes=nbytes, fma_ms=times["fma"],
               fma_ms_eager=times["fma_eager"])
    emit("kernel_timing", kernel="mlstm_scan", case="prefill", **tags,
         **out)
    return out


def with_plain_kernels(fn, mlstm_chunk=None):
    """``fn()`` with every kernel entry point of ops swapped for its plain
    version; with ``mlstm_chunk``, the plain mLSTM scan runs chunks of that
    size whatever the caller asks (the same function, summed in another
    order)."""
    kept = ops.flash_attention, ops.mlstm_scan
    scan = reference_mlstm_scan
    if mlstm_chunk is not None:
        def scan(*args, chunk, **kw):
            return reference_mlstm_scan(*args, chunk=mlstm_chunk, **kw)
    ops.flash_attention, ops.mlstm_scan = reference_attention, scan
    try:
        return fn()
    finally:
        ops.flash_attention, ops.mlstm_scan = kept


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def kernel_launches():
    """Attention calls, each attention kernel's launches, mLSTM scans and
    each mLSTM kernel's launches."""
    return {"flash_attention": fa.launches,
            **{f"flash_attention_{path}": n
               for path, n in fa.launches_by_path.items()},
            "mlstm_scan": ms.launches,
            **{f"mlstm_scan_{path}": n
               for path, n in ms.launches_by_path.items()}}


def reset_launches():
    fa.launches = ms.launches = 0
    for counts in (fa.launches_by_path, ms.launches_by_path):
        for path in counts:
            counts[path] = 0


def expected_launches(cfg, new_tokens=NEW_TOKENS):
    """Launches of one serve run (bf16) of ``new_tokens`` decode steps: the
    prefill attention kernel at every attention of the prefill (the
    self-attention of each attention, cross-attention and hymba layer, the
    cross-attention of each cross-attention layer, each encoder layer's),
    the decode kernel at every attention of each decode step (the encoder
    runs once, at prefill), the fp32 kernel never; the bf16 tensor-core
    mlstm_scan at every mLSTM layer of the prefill (512 is a multiple of
    its chunk, 256, a multiple of 16), the fp32 and FMA ones never, none in
    decode, which takes the sequential step."""
    kinds = cfg.block_pattern
    attn = sum(kinds.count(k) for k in ("attn", "attn_cross", "hymba"))
    attn += kinds.count("attn_cross")
    pre = attn + cfg.encoder_layers
    return {"flash_attention": pre + attn * new_tokens,
            "flash_attention_fp32_tc": 0,
            "flash_attention_prefill": pre,
            "flash_attention_decode": attn * new_tokens,
            "mlstm_scan": kinds.count("mlstm"),
            "mlstm_scan_fma": 0,
            "mlstm_scan_tc": kinds.count("mlstm"),
            "mlstm_scan_tc_f32": 0}


def prefill_logits_check(params, batch, cfg, seq, check_dtype):
    """``prefill`` with the kernels (``params`` cast to ``cfg.dtype``)
    against the same call with every kernel swapped for its plain version:
    the last position's logits over the vocabulary (the padding columns,
    granite's 13 of 49,168, are -1e30 by construction and would swamp any
    norm), finite, and within relative L2 LOGITS_TOL in ``check_dtype``.
    A model with mLSTM layers is held in its own dtype to the plain
    version re-chunked into each of RECHUNKS (the mean plus three standard
    deviations), one with hymba layers layer by layer
    (hymba_layers_check).  Returns the kernels' (logits, caches) and the
    line's fields."""
    vocab = cfg.vocab_size

    def prefill(p, c, **plain):
        def run():
            return TT.prefill(p, batch, c, seq)[0][..., :vocab].float()
        return with_plain_kernels(run, **plain) if plain else run()
    logits, caches = TT.prefill(params, batch, cfg, seq)
    a = logits[..., :vocab].float()
    b = prefill(params, cfg, mlstm_chunk=None)
    if not torch.isfinite(a).all():
        raise AssertionError(f"{cfg.name}: prefill logits are not finite")
    rel = {cfg.dtype: rel_l2(a, b)}
    mlstm, hymba = ("mlstm" in cfg.block_pattern,
                    "hymba" in cfg.block_pattern)
    fields = {}
    if check_dtype != cfg.dtype:
        if not (mlstm or hymba):
            raise ValueError(f"{cfg.name} in {cfg.dtype} is not checked")
        c32 = dataclasses.replace(cfg, dtype=check_dtype)
        p32 = TT.cast_params(params, c32)
        plain32 = prefill(p32, c32, mlstm_chunk=None)
        rel[check_dtype] = rel_l2(prefill(p32, c32), plain32)
        # what rounding to cfg.dtype alone moves the plain version's
        # logits, and what relative noise of INPUT_NOISE on the embedded
        # prompt moves them in check_dtype
        gen = torch.Generator(device=a.device).manual_seed(SEED)
        embed = TT._prepare_prefix

        def noisy(*args):
            x = embed(*args)
            return x * (1 + INPUT_NOISE * torch.randn(
                x.shape, generator=gen, device=x.device, dtype=x.dtype))
        with patched((TT, "_prepare_prefix", noisy)):
            noised = prefill(p32, c32, mlstm_chunk=None)
        fields.update(plain_vs_plain_in_check_dtype_rel_l2=rel_l2(b, plain32),
                      input_noise=INPUT_NOISE,
                      plain_with_input_noise_rel_l2=rel_l2(noised, plain32))
        del p32, plain32, noised
    if not rel[check_dtype] <= LOGITS_TOL:
        raise AssertionError(f"{cfg.name}: prefill logits ({check_dtype}) "
                             f"with the kernels and with the plain versions "
                             f"differ: relative L2 {rel[check_dtype]}")
    # In fp32 the mLSTM scan takes the FMA kernel, so the check above does not
    # reach the bf16 tensor-core kernel.  That one is held to what re-chunking
    # the plain version moves the same logits: a kernel that differs from the
    # plain version by more than the same function summed in another order
    # does is wrong beyond rounding.  Each re-chunking is one draw of that
    # rounding noise (about 0.3, a few hundredths apart), and so is any
    # kernel that agrees with the plain version to rounding, so the bound is
    # the draws' mean plus three standard deviations.
    if mlstm:
        draws = {ch: rel_l2(prefill(params, cfg, mlstm_chunk=ch), b)
                 for ch in RECHUNKS}
        bound_rel = (statistics.mean(draws.values())
                     + 3 * statistics.stdev(draws.values()))
        fields.update(plain_vs_plain_rechunked_rel_l2=draws,
                      rechunked_bound_rel_l2=bound_rel)
        if not rel[cfg.dtype] <= bound_rel:
            raise AssertionError(
                f"prefill logits ({cfg.dtype}) with the kernels and with the "
                f"plain versions differ by relative L2 {rel[cfg.dtype]}, more "
                f"than the plain version re-chunked does ({draws}: bound "
                f"{bound_rel})")
    if hymba:
        fields.update(hymba_layers_check(params, batch, cfg, seq))
    fields.update(
        prefill_logits_rel_l2_vs_plain=rel, logits_checked_in=check_dtype,
        logits_tol_rel_l2=LOGITS_TOL,
        prefill_logits_max_abs_diff=float((a - b).abs().max()),
        prefill_logits_max_abs=float(b.abs().max()),
        prefill_argmax_agreement=float(
            (a.argmax(-1) == b.argmax(-1)).float().mean()))
    return logits, caches, fields


def hymba_layers_check(params, batch, cfg, seq):
    """Each hymba layer alone, in the prefill and in the decode step after
    it, at the plain run's inputs (its x and, in decode, a copy of its
    caches): the layer's increment to the residual stream with the kernels
    against the plain versions, within relative L2 LOGITS_TOL.  Returns
    the readings, layer by layer."""
    block = TT.apply_hymba_block
    seen = []

    def record(p, x, c, **kw):
        cache = kw["cache"]
        seen.append((p, x, kw, None if cache is None else
                     {n: t.clone() for n, t in cache.items()}))
        return block(p, x, c, **kw)

    def plain_run():
        logits, caches = TT.prefill(params, batch, cfg, seq)
        TT.decode_step(params, logits.argmax(-1), caches,
                       TT.prefix_len(cfg, batch) + batch["tokens"].shape[1],
                       cfg, seq)
    with patched((TT, "apply_hymba_block", record)):
        with_plain_kernels(plain_run)
    rel = {"prefill": [], "decode": []}
    for p, x, kw, cache in seen:
        def increment():
            c = (None if cache is None else
                 {n: t.clone() for n, t in cache.items()})
            return block(p, x, cfg, **dict(kw, cache=c))[0].float() - x.float()
        rel["prefill" if cache is None else "decode"].append(
            rel_l2(increment(), with_plain_kernels(increment)))
    worst = max(max(r) for r in rel.values())
    if not (len(rel["prefill"]) == len(rel["decode"]) == cfg.num_layers
            and worst <= LOGITS_TOL):
        raise AssertionError(f"{cfg.name} ({cfg.dtype}), each layer at the "
                             f"plain run's inputs with the kernels and with "
                             f"the plain versions: relative L2 {rel} (tol "
                             f"{LOGITS_TOL})")
    return {"layers_rel_l2_vs_plain": rel, "layers_max_rel_l2": worst}


def cut_depth(cfg, layers):
    """``cfg`` with its first ``layers`` layers: width as published."""
    return dataclasses.replace(cfg, num_layers=layers,
                               block_pattern=cfg.block_pattern[:layers],
                               windows=cfg.windows[:layers])


def phase_serve(arch):
    """One serve run of ``arch`` (bf16) and its checks, at ``SERVE_LAYERS``'
    depth where it names one.  Returns the run's launches (counts set to 0
    just before ``eng.run()``), its arrival trace, and the launches of
    prefill_logits_check (counts set to 0 just before it): the fp32
    prefills of the models held in fp32 among them."""
    phase_t0 = time.perf_counter()
    full = get_config(arch)
    cfg = cut_depth(full, SERVE_LAYERS[arch]) if arch in SERVE_LAYERS \
        else full
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device="cuda")
    eng = ServingEngine(cfg, params, slots=len(PROMPTS), max_seq=MAX_SEQ,
                        seed=SEED, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n,
                                                dtype=np.int32),
                    max_new_tokens=NEW_TOKENS,
                    temperature=0.8 if i == 1 else 0.0)
            for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = expected_launches(cfg)
    if launches != want:
        raise AssertionError(f"{arch}: kernels launched {launches} times, "
                             f"not {want}")
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in done:
        if len(r.out_tokens) != NEW_TOKENS or not all(
                0 <= tok < cfg.vocab_size for tok in r.out_tokens):
            raise AssertionError(f"request {r.rid}: bad tokens {r.out_tokens}")

    # The same prefill with every kernel swapped for its plain version
    # (an encoder-decoder's over seeded frames, where the engine passed
    # zeros).
    toks = np.zeros((len(PROMPTS), max(PROMPTS)), np.int64)
    for i, r in enumerate(reqs):
        toks[i, -len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             **model_extras(cfg, len(PROMPTS), rng, "cuda")}
    prefix = TT.prefix_len(cfg, batch)
    reset_launches()
    logits, caches, logit_fields = prefill_logits_check(
        eng.params, batch, cfg, MAX_SEQ, LOGITS_CHECK_DTYPE[arch])
    check_launches = kernel_launches()

    prefill_ms = cuda_ms(lambda: TT.prefill(eng.params, batch, cfg, MAX_SEQ),
                         iters=5, warmup=1)
    nxt = logits.argmax(-1)
    step_ms = cuda_ms(lambda: TT.decode_step(eng.params, nxt, caches,
                                             DECODE_POS + prefix, cfg,
                                             MAX_SEQ),
                      iters=20)
    moe = (dict(experts=cfg.num_experts,
                experts_stored=TM.expert_store_count(cfg), top_k=cfg.top_k,
                d_ff=cfg.d_ff, capacity_factor=cfg.capacity_factor,
                moe_path="single shard (dense)")
           if cfg.is_moe else {})
    cut = ({"layers_published": full.num_layers,
            "reduced": f"depth: {cfg.num_layers} of {full.num_layers} "
                       "layers, so that the fp32 parameters and their bf16 "
                       "copy fit one card; width as published"}
           if cfg.num_layers != full.num_layers else {})
    emit("serve", model=cfg.name, layers=cfg.num_layers, **cut,
         d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, vocab=cfg.vocab_size,
         params_stored=sum(a.numel() for a in _leaves(eng.params)), **moe,
         blocks={k: cfg.block_pattern.count(k) for k in dict.fromkeys(
             cfg.block_pattern)},
         prefix_positions=prefix, encoder_layers=cfg.encoder_layers,
         encoder_frames=cfg.encoder_seq_len or None,
         ssm_state=cfg.ssm_state or None,
         dtype=cfg.dtype, slots=len(PROMPTS), prompts=list(PROMPTS),
         new_tokens=NEW_TOKENS, max_seq=MAX_SEQ, init_s=init_s,
         run_s=run_s, generated_tokens=sum(len(r.out_tokens) for r in done),
         launches=launches, launches_expected=want,
         logits_check_launches=check_launches, **logit_fields,
         prefill_ms=prefill_ms,
         decode_step_ms=step_ms,
         decode_tokens_per_s=len(PROMPTS) / step_ms * 1e3,
         peak_memory_gb=peak_gb,
         tokens={r.rid: r.out_tokens[:8] for r in done},
         seconds=time.perf_counter() - phase_t0)
    phase_profile(arch, "prefill", lambda: TT.prefill(eng.params, batch, cfg,
                                                      MAX_SEQ),
                  prefill_ms, calls=2)
    phase_profile(arch, "decode step", lambda: TT.decode_step(
        eng.params, nxt, caches, DECODE_POS + prefix, cfg, MAX_SEQ), step_ms,
        calls=5)
    return launches, eng.arrival_trace(done), check_launches


#: internvl2-26b's prefill: full width, ``layers`` of its 48, so that the
#: fp32 initialisation (about 4.3 B parameters, 17 GB) fits the card; the
#: tiny sizes rehearse the phase on the CPU.
VLM = {"arch": "internvl2-26b", "reduced": False, "layers": 8,
       "prompt": 512, "iters": 3}
VLM_TINY = {"arch": "internvl2-26b", "reduced": True, "layers": 2,
            "prompt": 16, "iters": 1}


def phase_vlm_prefill(device="cuda", sizes=VLM):
    """internvl2-26b's prefill (bf16) through ``prefill``: B4, seeded patch
    embeddings (its stub frontend's, 256 a prompt) in front of a
    512-token prompt, so 768 positions at G = 6 (H48 KV8 D128).  Gates:
    one prefill launch a layer (none on the CPU, where the wrappers run
    their plain versions), logits finite and within relative L2 LOGITS_TOL
    of the plain versions, caches filled to 768.  Returns the launches
    (counts set to 0 just before the prefill)."""
    t0 = time.perf_counter()
    full = get_config(sizes["arch"])
    base = full.reduced() if sizes["reduced"] else full
    n = sizes["layers"]
    cfg = cut_depth(base, n)
    params = init_params(SEED, cfg, device=device)
    n_params = sum(a.numel() for a in _leaves(params))
    p = TT.cast_params(params, cfg, device)
    del params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED)
    b = len(PROMPTS)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, sizes["prompt"]))).to(device),
        **model_extras(cfg, b, rng, device)}
    seq = TT.prefix_len(cfg, batch) + sizes["prompt"]
    reset_launches()
    _, caches, logit_fields = prefill_logits_check(p, batch, cfg, seq,
                                                   cfg.dtype)
    launches = kernel_launches()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    want = expected_launches(cfg, new_tokens=0)
    if device != "cuda":
        want = dict.fromkeys(want, 0)
    if launches != want:
        raise AssertionError(f"{cfg.name} prefill: kernels launched "
                             f"{launches} times, not {want}")
    if caches[0]["k"].shape != (b, seq, cfg.num_kv_heads, cfg.head_dim):
        raise AssertionError(f"cache of {tuple(caches[0]['k'].shape)}")
    del caches
    prefill_ms = wall_ms(lambda: TT.prefill(p, batch, cfg, seq),
                         sizes["iters"], device)
    emit("prefill", model=cfg.name, device=device, layers=n,
         layers_published=full.num_layers,
         reduced=(f"the reduced config, {n} of its {base.num_layers} "
                  f"layers" if sizes["reduced"] else
                  f"depth: {n} of {full.num_layers} layers, so that the fp32 "
                  f"parameters fit one card; width as published"),
         d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         vocab=cfg.vocab_size, params_stored=n_params, dtype=cfg.dtype,
         batch=b, patch_embeds=batch["patch_embeds"].shape[1],
         prompt=sizes["prompt"], positions=seq, launches=launches,
         launches_expected=want, **logit_fields, prefill_ms=prefill_ms,
         peak_memory_gb=peak_gb, seconds=time.perf_counter() - t0)
    return launches


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        items = tree.values() if isinstance(tree, dict) else tree
        return [a for v in items for a in _leaves(v)]
    return [tree]


def phase_profile(arch, what, fn, call_ms, calls):
    """Device time by kernel over a few calls of ``fn`` (torch.profiler), and
    the share of the time in which the device ran no kernel: under the
    profiler, and against ``call_ms`` measured without it."""
    fn()
    dev, busy_us, wall_us = device_ops(fn, "cuda", calls)
    ours = {name: sum(t for k, t, _ in dev if name in k)
            for name in ("flash_attention", "mlstm_scan")}
    top = sorted(dev, key=lambda e: -e[1])[:8]
    emit("profile", model=arch, what=what, calls=calls, wall_us=wall_us,
         device_busy_us=busy_us, device_idle_share=1 - busy_us / wall_us,
         device_idle_share_unprofiled=1 - busy_us / calls / (call_ms * 1e3),
         kernel_launches_profiled=sum(c for _, _, c in dev),
         repo_kernel_us=ours,
         repo_kernel_share_of_device={
             k: (v / busy_us if busy_us else None) for k, v in ours.items()},
         top=[{"kernel": k[:80], "us": t, "calls": c} for k, t, c in top])


# name: (arch, prompt length, fields replaced in the reduced config); 256
# is a multiple of the mLSTM chunk, so the card takes the mlstm_scan kernel
# and the CPU its plain version.  gemma3-1b reduced has head dim 16; at its
# published 256 the fp32 kernel runs its <32, 256> and <16, 256> instances.
SMALL_MODELS = {"llama3.2-3b": ("llama3.2-3b", 70, {}),
                "lacin-demo": ("lacin-demo", 70, {}),
                "xlstm-350m": ("xlstm-350m", 256, {}),
                "granite-moe-3b-a800m": ("granite-moe-3b-a800m", 70, {}),
                "gemma3-1b": ("gemma3-1b", 70, {}),
                "gemma3-1b head_dim 256": ("gemma3-1b", 70,
                                           {"head_dim": 256}),
                "hymba-1.5b": ("hymba-1.5b", 70, {}),
                "whisper-base": ("whisper-base", 70, {}),
                "internvl2-26b": ("internvl2-26b", 70, {})}


def phase_small_model():
    """The reduced models in float32 on the card (kernels) against the CPU
    (plain versions): logits of prefill and one decode step, atol 1e-4.
    Returns the launches on the card (counts set to 0 just before): the
    path that runs the fp32 kernels: attention's tensor-core one at every
    head dim, decode steps included, and the mLSTM scan's FMA one."""
    worst = {}
    reset_launches()
    for name, (arch, t, fields) in SMALL_MODELS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **fields)
        params = init_params(SEED, cfg, device="cpu")
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, t))),
            **model_extras(cfg, 2, rng, "cpu")}
        pos = t + TT.prefix_len(cfg, batch)
        out = {}
        for dev in ("cpu", "cuda"):
            p = TT.cast_params(params, cfg, dev)
            before = kernel_launches()
            logits, caches = TT.prefill(
                p, {k: v.to(dev) for k, v in batch.items()}, cfg, pos + 26)
            step, _ = TT.decode_step(p, logits.argmax(-1), caches, pos, cfg,
                                     pos + 26)
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
            out[dev] = torch.cat([logits, step], 1).cpu()
        if launched["flash_attention_fp32_tc"] != launched["flash_attention"]:
            raise AssertionError(f"{name} reduced: fp32 attention left the "
                                 f"fp32 tensor-core kernel: {launched}")
        if arch == "xlstm-350m" and (
                launched["mlstm_scan"], launched["mlstm_scan_tc_f32"],
                launched["mlstm_scan_fma"], launched["mlstm_scan_tc"]) != (
                (cfg.block_pattern.count("mlstm"),) * 2 + (0, 0)):
            raise AssertionError(f"{arch} reduced: fp32 mlstm_scan left the "
                                 f"split tensor-core kernel: {launched}")
        err = float((out["cuda"] - out["cpu"]).abs().max())
        if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4):
            raise AssertionError(f"{name} reduced: card and CPU differ by {err}")
        worst[name] = err
    total = kernel_launches()
    emit("small_model_vs_cpu", max_abs_err=worst, tol=1e-4, launches=total)
    return total


#: granite-moe-3b-a800m's MoE layer alone: the token counts of one serve
#: run's prefill (4 prompts x 512) and decode step (4 slots), and the
#: tokens of the fp32 card-against-CPU check at the reduced width.
MOE_FULL = {"arch": "granite-moe-3b-a800m", "reduced": False,
            "tokens": {"prefill": len(PROMPTS) * max(PROMPTS),
                       "decode": len(PROMPTS)},
            "iters": {"prefill": 20, "decode": 50}, "check_tokens": 256}
MOE_TINY = {"arch": "granite-moe-3b-a800m", "reduced": True,
            "tokens": {"prefill": 64, "decode": 4},
            "iters": {"prefill": 2, "decode": 2}, "check_tokens": 64}


def moe_bound(p, cfg, rows, experts):
    """Least time of the expert FFN on the card: the weights of
    ``experts`` stored experts read once, and the FFN's multiply-adds on
    ``rows`` rows at the bf16 peak."""
    names = [n for n in ("wi", "wg", "wo") if n in p]
    nbytes = experts * sum(p[n][0].numel() * p[n].element_size()
                           for n in names)
    flops = 2 * len(names) * rows * cfg.d_model * cfg.d_ff
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def phase_moe(device="cuda", sizes=MOE_FULL):
    """granite's MoE layer (repro_torch.models.moe, single shard) in bf16
    at the serve run's prefill and decode token counts: ms of
    ``_moe_local`` (without the losses, as serving runs it; and with
    them, as training does) and of its three parts, the tokens dropped
    and two bounds: ``bound_ms`` for the work the layer does (every
    stored expert read, padding included, and ``e*cap`` bucket rows) and
    ``needed_bound_ms`` for the work the function needs (the experts this
    run's tokens select, and one row per assignment kept); then the layer
    at the reduced width in fp32 on the card against the CPU."""
    t0 = time.perf_counter()
    cfg = get_config(sizes["arch"])
    if sizes["reduced"]:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = TM.init_moe(gen, cfg, torch.bfloat16)
    e, k, d = p["wi"].shape[0], cfg.top_k, cfg.d_model
    shapes = {}
    for what, t in sizes["tokens"].items():
        x = torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)
        cap = TM._capacity(t, cfg)
        _, _, gates, flat_e, slot, valid, buf = TM._route(p, x, cfg, e, cap)
        xin = buf.reshape(e, cap, d)
        out_buf = TM._expert_ffn(p, xin, cfg).reshape(e * cap, d)
        y = TM._combine(out_buf, slot, valid, gates, t, k, x.dtype)
        whole = TM._moe_local(p, x, cfg, None, None, losses=False)[0]
        if not (torch.isfinite(whole).all() and torch.equal(y, whole)):
            raise AssertionError(f"moe {what}: the parts do not compose to "
                                 f"_moe_local, or it is not finite")
        iters = sizes["iters"][what]
        parts = {
            "route_dispatch_ms": lambda: TM._route(p, x, cfg, e, cap),
            "expert_ffn_ms": lambda: TM._expert_ffn(p, xin, cfg),
            "combine_ms": lambda: TM._combine(out_buf, slot, valid, gates, t,
                                              k, x.dtype),
            "ms": lambda: TM._moe_local(p, x, cfg, None, None,
                                        losses=False),
            "ms_with_losses": lambda: TM._moe_local(p, x, cfg, None, None)}
        times = {key: wall_ms(fn, iters, device) for key, fn in parts.items()}
        bound_ms, bound_by, nbytes, flops = moe_bound(p, cfg, e * cap, e)
        kept = int(valid.sum())
        touched = int(flat_e[valid].unique().numel())
        need_ms, need_by, need_bytes, need_flops = moe_bound(p, cfg, kept,
                                                             touched)
        shapes[what] = dict(tokens=t, capacity=cap, bucket_rows=e * cap,
                            assignments=t * k, tokens_dropped=t * k - kept,
                            **times, bound_ms=bound_ms, bound_by=bound_by,
                            expert_bytes=nbytes, ffn_flops=flops,
                            experts_selected=touched,
                            needed_bound_ms=need_ms, needed_bound_by=need_by,
                            needed_expert_bytes=need_bytes,
                            needed_ffn_flops=need_flops)

    # The layer at the reduced width in fp32: card against CPU.
    c32 = dataclasses.replace(get_config(sizes["arch"]).reduced(),
                              dtype="float32")
    p32 = TM.init_moe(torch.Generator().manual_seed(SEED), c32, torch.float32)
    x32 = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(sizes["check_tokens"], c32.d_model)).astype(np.float32))
    e32, cap32 = p32["wi"].shape[0], TM._capacity(sizes["check_tokens"], c32)
    got = {}
    for dev in ("cpu", device):
        pd = {n: a.to(dev) for n, a in p32.items()}
        route = TM._route(pd, x32.to(dev), c32, e32, cap32)
        y32 = TM._moe_local(pd, x32.to(dev), c32, None, None,
                            losses=False)[0]
        got[dev] = (route[4].cpu(), route[5].cpu(), y32.cpu())
    same_slots = (torch.equal(got["cpu"][0], got[device][0])
                  and torch.equal(got["cpu"][1], got[device][1]))
    err = float((got["cpu"][2] - got[device][2]).abs().max())
    if not (same_slots and err <= 1e-5):
        raise AssertionError(f"moe fp32 reduced: card and CPU differ (slots "
                             f"equal: {same_slots}, y by {err})")
    emit("moe", model=cfg.name, device=device, dtype="bfloat16",
         d_model=d, d_ff=cfg.d_ff, experts=cfg.num_experts,
         experts_stored=e, top_k=k, capacity_factor=cfg.capacity_factor,
         shapes=shapes, reduced_fp32_vs_cpu=dict(
             tokens=sizes["check_tokens"], slots_equal=same_slots,
             y_max_abs_err=err, tol=1e-5),
         seconds=time.perf_counter() - t0)
    return shapes


# ---------------------------------------------------------------------------
# Training (repro_torch.runtime.trainer): the flash-attention autograd
# Function's forward is the prefill kernel (bf16) or the fp32 kernel with
# its log-sum-exp; its backward is plain PyTorch, as the reference's is
# jnp.  llama3.2-3b trains at full width and depth.
# ---------------------------------------------------------------------------

#: name: (b, t, s, h, kvh, d, q_pos, kv_pos, causal, window); q_pos None =
#: arange(t), "tail" = the last t of s positions; kv_pos None = arange(s),
#: negative entries masked.  The last is the training shape of
#: llama3.2-3b (B2 T1024).
TRAIN_HAZARDS = {
    "gqa3_d128_odd_t": (2, 131, 131, 6, 2, 128, None, None, True, 0),
    "gqa4_window33_d64": (1, 150, 150, 8, 2, 64, None, None, True, 33),
    "mqa_window7_d32": (2, 100, 100, 4, 1, 32, None, None, True, 7),
    "noncausal_tail_d128": (1, 70, 190, 6, 2, 128, "tail", None, False, 0),
    "padded_keys_d64": (2, 100, 128, 6, 2, 64, "tail",
                        list(range(100)) + [-1] * 28, True, 0),
    "rows_see_nothing_d64": (1, 80, 80, 6, 2, 64, list(range(-40, 40)),
                             None, True, 0),
    "mha_g1_d128": (2, 150, 150, 4, 4, 128, None, None, True, 0),
    # bf16 with T <= 16 takes the prefill kernel when it needs the lse
    "t16_d128": (2, 16, 300, 6, 2, 128, "tail", None, True, 0),
    "t5_gqa8_d16": (1, 5, 90, 16, 2, 16, "tail", None, True, 0),
    "t1_d64": (2, 1, 200, 6, 2, 64, [150], None, True, 0),
    "training_shape": (2, 1024, 1024, 24, 8, 128, None, None, True, 0),
    # head dim 256 (gemma3-1b: H4 KV1, 512-key windows on local layers)
    "gqa3_d256_odd_t": (2, 131, 131, 6, 2, 256, None, None, True, 0),
    "mqa_window512_d256": (1, 700, 700, 4, 1, 256, None, None, True, 512),
    "t5_d256": (1, 5, 90, 4, 1, 256, "tail", None, True, 0),
    "training_shape_d256": (2, 1024, 1024, 4, 1, 256, None, None, True, 0),
    # G = 12 (starcoder2-3b: H24 KV2 D128)
    "gqa12_odd_t": (2, 131, 131, 24, 2, 128, None, None, True, 0),
    "gqa12_t5_tail": (1, 5, 90, 24, 2, 128, "tail", None, True, 0),
    "training_shape_gqa12": (2, 1024, 1024, 24, 2, 128, None, None, True,
                             0),
    # the training shapes of hymba-1.5b (G 5 D 64, 1024-key windows, and a
    # 256-key window that binds at T 640), internvl2-26b (G 6 D 128) and
    # whisper-base (its encoder non-causal at T = S = 1500, no tile's
    # multiple; its cross-attention: 1024 queries at position 0 against
    # 1500 keys)
    "train_hymba_g5": (2, 1024, 1024, 25, 5, 64, None, None, True, 1024),
    "train_hymba_g5_window256": (2, 640, 640, 25, 5, 64, None, None, True,
                                 256),
    "train_internvl_g6": (2, 1024, 1024, 48, 8, 128, None, None, True, 0),
    "train_whisper_encoder": (2, 1500, 1500, 8, 8, 64, None, None, False,
                              0),
    "train_whisper_cross": (2, 1024, 1500, 8, 8, 64, [0] * 1024, None,
                            False, 0),
    # one rank of llama3.2-3b's attention over 2 tp ranks (phase tp)
    "train_tp_rank_h12_kv4": (2, 1024, 1024, 12, 4, 128, None, None, True,
                              0),
    # one rank of whisper-base's encoder and cross-attention over 2
    "train_tp_rank_whisper_encoder_h4": (2, 1500, 1500, 4, 4, 64, None,
                                         None, False, 0),
    "train_tp_rank_whisper_cross_h4": (2, 1024, 1500, 4, 4, 64, [0] * 1024,
                                       None, False, 0),
}
#: The lse hazard cases at the training shapes of the models with a prefix
#: or an encoder, each also timed.
PREFIXED_CASES = ("train_hymba_g5", "train_hymba_g5_window256",
                  "train_internvl_g6", "train_whisper_encoder",
                  "train_whisper_cross")
#: The lse: fp32 kernel as its output (2e-5); bf16 kernel 1e-3, its
#: scores are fp32 sums of exact bf16 products in another order and its
#: exponent runs on ex2.approx.  dq, dk, dv of the Function against the
#: plain version's autograd, relative L2 per tensor: fp32 1e-4 (the
#: backward recomputes P from the kernel's lse and o); bf16 2e-2 (the
#: backward reads o as the kernel rounded it to bf16).
LSE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
GRAD_REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

#: The scan under autograd (repro_torch.models.xlstm.MLSTMScan): name: (b,
#: t, h, d, chunk, gates); log_i ~ N(0, 2) and the forget pre-activation ~
#: N(1, 2), with "input_x30" (log_i scaled by 30), "forget_minus40" (the
#: forget pre-activation shifted by -40: each step forgets nearly all) and
#: "first_gate_minus100" (every sequence opens with log_i = -100, where
#: exp(-m) is beyond float32).  The last is xlstm-350m's training shape.
MLSTM_TRAIN_HAZARDS = {
    "one_chunk_d64": (2, 64, 2, 64, 64, "normal"),
    "four_chunks_d64": (2, 256, 2, 64, 64, "normal"),
    "d512_two_chunks": (1, 512, 2, 512, 256, "normal"),
    "input_x30": (2, 256, 2, 64, 64, "input_x30"),
    "forget_minus40": (2, 256, 2, 64, 64, "forget_minus40"),
    "first_gate_minus100": (2, 128, 2, 64, 64, "first_gate_minus100"),
    "bh1_d128": (1, 256, 1, 128, 64, "normal"),
    "training_shape": (2, 1024, 4, 512, 256, "normal"),
    # one rank of xlstm-350m's over 2 tp ranks (phase tp)
    "tp_rank_training_shape": (2, 1024, 2, 512, 256, "normal"),
}

#: ``models`` train in order, each beside its timing case (its training
#: shape, or (case, layers) pairs where the layers take several shapes;
#: None: the mLSTM scan's, ``mlstm_timing_case``).  ``seq`` counts
#: positions: a prefix (meta tokens, patch embeddings) takes its share of
#: them and the text the rest (launch/specs.py); an encoder's frames come
#: beside them.  ``layers_by_model``: depth cut to fit the card (the fp32
#: train state, 16 bytes a parameter); ``steps_by_model``: fewer steps for
#: a model whose step is long; ``step1``: the dtypes a model's step 1 is
#: held in (default its compute dtype) and the depth it is held at (None:
#: its own).
TRAIN_FULL = {
    "hazards": tuple(TRAIN_HAZARDS),
    "mlstm_hazards": tuple(MLSTM_TRAIN_HAZARDS),
    "timing_cases": ("training_shape", "training_shape_d256",
                     "training_shape_gqa12") + PREFIXED_CASES,
    "mlstm_timing_case": "training_shape",
    "timing_iters": 16, "reduced": ("llama3.2-3b", "granite-moe-3b-a800m"),
    "reduced_seq": 64,
    "models": (("llama3.2-3b", "training_shape"),
               ("gemma3-1b", "training_shape_d256"),
               ("starcoder2-3b", "training_shape_gqa12"),
               ("xlstm-350m", None),
               ("hymba-1.5b", (("train_hymba_g5", 8),)),
               ("whisper-base", (("train_whisper_encoder", 6),
                                 ("train_whisper_cross", 6))),
               ("internvl2-26b", (("train_internvl_g6", 4),))),
    "model_reduced": False, "seq": 1024, "batch": 2, "steps": 4,
    "layers_by_model": {"internvl2-26b": 4, "xlstm-350m": 8,
                        "hymba-1.5b": 8},
    "steps_by_model": {"hymba-1.5b": 3, "xlstm-350m": 3},
    "step1": {"xlstm-350m": (("float32", "bfloat16"), None),
              "hymba-1.5b": (("float32",), 4)}}
TRAIN_TINY = {
    "hazards": ("gqa3_d128_odd_t", "rows_see_nothing_d64", "t1_d64",
                "t5_d256", "gqa12_t5_tail"),
    "mlstm_hazards": ("one_chunk_d64", "first_gate_minus100"),
    "timing_cases": ("t16_d128", "t5_d256", "gqa12_t5_tail"),
    "mlstm_timing_case": "one_chunk_d64", "timing_iters": 2,
    "reduced": ("llama3.2-3b", "granite-moe-3b-a800m"), "reduced_seq": 16,
    "models": (("llama3.2-3b", "t16_d128"), ("gemma3-1b", "t5_d256"),
               ("starcoder2-3b", "gqa12_t5_tail"), ("xlstm-350m", None),
               ("hymba-1.5b", (("t16_d128", 4),)),
               ("whisper-base", (("t16_d128", 2), ("gqa12_t5_tail", 2))),
               ("internvl2-26b", (("t16_d128", 2),))),
    "model_reduced": True, "seq": 32, "seq_by_model": {"xlstm-350m": 256},
    "batch": 2, "steps": 3, "layers_by_model": {"internvl2-26b": 2},
    "steps_by_model": {"hymba-1.5b": 2},
    "step1": {"xlstm-350m": (("float32", "bfloat16"), None),
              "hymba-1.5b": (("float32",), 2)}}
#: The reduced models in fp32, card against CPU: the loss (rtol 1e-5) and
#: every gradient leaf (relative L2 1e-4: the fp32 kernel is held to its
#: plain version at 2e-5); parameters after two train steps of lr 1e-3
#: within atol 1e-4, a tenth of a step (tests/test_torch_train.py).
#: llama3.2-3b at full depth in bf16, the kernels against their plain
#: versions at step 1: the loss (relative 1e-2) and every gradient leaf
#: (relative L2 5e-2, the measure and bound the serve phase holds prefill
#: logits to).
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)
FULL_GRAD_REL_L2 = 5e-2
#: llama3.2-3b trains with the reference's defaults (lr 3e-4 after 200
#: warm-up steps): at lr 1e-3 from step 1 its loss swung up and down.
FULL_OPT = {}


def _train_inputs(name, dtype, device):
    b, t, s, h, kvh, d, q_pos, kv_pos, causal, window = TRAIN_HAZARDS[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device=device, dtype=dtype)
    q, k, v, do = draw(b, t, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d), \
        draw(b, t, h, d)
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    pos = [torch.tensor(list(range(n)) if p is None else p, dtype=torch.int32,
                        device=device) for p, n in ((q_pos, t), (kv_pos, s))]
    return (q, k, v, do, *pos), dict(causal=causal, window=window)


def attention_backward_bound(q, k, qp, kp, causal, window):
    """Least time of the attention backward on the card: q, k, v, o, dO
    and the lse read once, dq, dk, dv written once, and FlashAttention-2's
    five products over the visible pairs (S recomputed, dP, dV, dQ, dK) at
    the peak of the inputs' type; also that bound on the fp32 pipe, where
    the plain backward computes."""
    ok = fa.visible(qp, kp, causal, window)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    pairs = int(ok.sum())
    nbytes = (6 * q.numel() * q.element_size()
              + 4 * b * k.shape[1] * kvh * d * k.element_size()
              + 4 * b * h * t)
    flops = 10 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, flops / PEAK_FLOPS[torch.float32] * 1e3))


def rel_or_abs(a, b):
    """Relative L2 of ``a`` against ``b``; where ``b`` is all zeros, the
    largest |a|."""
    return rel_l2(a, b) if b.any() else float(a.float().abs().max())


def _leaf_grads(*tensors):
    return [x.detach().clone().requires_grad_(True) for x in tensors]


def train_hazards(device, sizes):
    """The lse and the Function on each hazard case in fp32 and bf16: o and
    lse of the kernel against the plain version, dq, dk, dv of the
    Function against the plain version's autograd; the kernel each call
    took (never decode)."""
    worst = {}
    for name in sizes["hazards"]:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v, do, qp, kp), kw = _train_inputs(name, dtype, device)
            before = kernel_launches()
            with torch.no_grad():
                o, lse = ops.flash_attention(q, k, v, q_pos=qp, kv_pos=kp,
                                             return_lse=True, **kw)
            launched = {key: n - before[key]
                        for key, n in kernel_launches().items()}
            path = fa.plan(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                           q.shape[3], dtype, lse=True).path
            if path not in ("fp32_tc", "prefill"):
                raise AssertionError(f"lse {name} {dtype}: plan {path}")
            if device == "cuda" and (launched["flash_attention"] != 1 or
                                     launched[f"flash_attention_{path}"] != 1):
                raise AssertionError(f"lse {name} {dtype}: took {launched}, "
                                     f"not the {path} kernel")
            o_ref, lse_ref = reference_attention(q, k, v, q_pos=qp,
                                                 kv_pos=kp, return_lse=True,
                                                 **kw)
            err_o = check_close(f"lse-path o {name}", o, o_ref, dtype)
            empty = lse_ref >= 1e29
            if not torch.equal(lse >= 1e29, empty):
                raise AssertionError(f"lse {name} {dtype}: rows that see no "
                                     f"key differ")
            err_lse = float((lse - lse_ref)[~empty].abs().max()) \
                if (~empty).any() else 0.0
            if not err_lse <= LSE_TOL[dtype] * (1 + float(
                    lse_ref[~empty].abs().max() if (~empty).any() else 0)):
                raise AssertionError(f"lse {name} {dtype}: differs by "
                                     f"{err_lse} (tol {LSE_TOL[dtype]})")
            live = _leaf_grads(q, k, v)
            MF.flash_attention(*live, q_pos=qp, kv_pos=kp, **kw).backward(do)
            plain = _leaf_grads(q, k, v)
            reference_attention(*plain, q_pos=qp, kv_pos=kp,
                                **kw).backward(do)
            rel = {n: rel_or_abs(a.grad, b.grad)
                   for n, a, b in zip(("dq", "dk", "dv"), live, plain)}
            if not max(rel.values()) <= GRAD_REL_L2[dtype]:
                raise AssertionError(f"Function {name} {dtype}: gradients "
                                     f"differ from the plain version's by "
                                     f"{rel} (tol {GRAD_REL_L2[dtype]})")
            if name.startswith("rows_see_nothing") and live[0].grad[
                    :, :40].any():
                raise AssertionError(f"{name}: a row that sees no key has "
                                     f"a gradient")
            key = str(dtype).removeprefix("torch.")
            w = worst.setdefault(key, {"o": 0.0, "lse": 0.0, "grad": 0.0})
            w["o"], w["lse"] = max(w["o"], err_o), max(w["lse"], err_lse)
            w["grad"] = max(w["grad"], max(rel.values()))
            emit("train_case", case=name, dtype=key, path=path,
                 o_max_abs_err=err_o, lse_max_abs_err=err_lse,
                 grad_rel_l2=rel, tol=dict(o=TOL[dtype], lse=LSE_TOL[dtype],
                                           grad_rel_l2=GRAD_REL_L2[dtype]))
    return worst


def mlstm_train_inputs(name, dtype, device):
    """q, k, v (and dh, the output gradient) in ``dtype``, log_i and log_f
    in fp32, of MLSTM_TRAIN_HAZARDS ``name``; and its chunk."""
    b, t, h, d, chunk, gates = MLSTM_TRAIN_HAZARDS[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device)
    q, k, v, dh = (draw(b, t, h, d).to(dtype) for _ in range(4))
    li, pre_f = draw(b, t, h) * 2, draw(b, t, h) * 2 + 1
    if gates == "input_x30":
        li = li * 30
    if gates == "forget_minus40":
        pre_f = pre_f - 40
    if gates == "first_gate_minus100":
        li[:, 0] = -100.0
    return (q, k, v, li, F.logsigmoid(pre_f)), dh, chunk


def train_mlstm_hazards(device, sizes):
    """The scan's Function on each case in fp32 and bf16: h of the kernel
    forward, and dq, dk, dv, dlog_i, dlog_f of the plain backward, against
    autograd through the plain version (each at MLSTM_TOL of the dtype,
    element by element, and finite; in fp32 h and the final state by
    check_mlstm_fp32); one launch of the dtype's kernel and one backward
    call a Function call."""
    worst = {}
    for name in sizes["mlstm_hazards"]:
        for dtype in (torch.float32, torch.bfloat16):
            args, dh, chunk = mlstm_train_inputs(name, dtype, device)
            b, t, h, d = args[0].shape
            path = ms.plan(b, t, h, d, chunk, dtype).path
            outs, finals = {}, {}
            for how, fn in (("function", MX.mlstm_scan_grad),
                            ("plain", reference_mlstm_scan)):
                leaves = _leaf_grads(*args)
                before, bwd = kernel_launches(), MX.backward_calls
                out, final = fn(*leaves, chunk=chunk)
                grads = torch.autograd.grad(out, leaves, dh)
                launched = {key: n - before[key]
                            for key, n in kernel_launches().items()}
                want = (1, 1) if how == "function" else (0, 0)
                got = (launched["mlstm_scan"], MX.backward_calls - bwd)
                if device == "cuda" and (got != want or launched[
                        f"mlstm_scan_{path}"] != want[0]):
                    raise AssertionError(f"Function {name} {dtype} ({how}): "
                                         f"launches {launched}, backward "
                                         f"calls {got[1]}")
                outs[how] = (out, *grads)
                finals[how] = (out.detach(), tuple(x.detach() for x in final))
            errs, readings = {}, {}
            tol = MLSTM_TOL[dtype]
            checked = ("h", "dq", "dk", "dv", "dlog_i", "dlog_f")
            if dtype == torch.float32:
                readings, errs["h"], errs["state"] = check_mlstm_fp32(
                    f"Function {name}", finals["function"], finals["plain"],
                    args, None, chunk)
                checked = checked[1:]
            for what, g, w in zip(checked, *(o[len(o) - len(checked):]
                                             for o in outs.values())):
                err = (g.float() - w.float()).abs()
                if not (torch.isfinite(g).all() and float(
                        (err - tol["rtol"] * w.float().abs()).max())
                        <= tol["atol"]):
                    raise AssertionError(
                        f"Function {name} {dtype}: {what} differs from the "
                        f"plain version's by up to {float(err.max())} "
                        f"({tol}), or is not finite")
                errs[what] = float(err.max())
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst.get(key, 0.0), *errs.values())
            emit("train_case", kernel="mlstm_scan", case=name, dtype=key,
                 path=path, shape=f"B{b} T{t} H{h} D{d} chunk {chunk} "
                                  f"{MLSTM_TRAIN_HAZARDS[name][-1]}",
                 max_abs_err=errs, tol=tol, **readings)
    return worst


def mlstm_backward_bound(q, chunk):
    """Least time of the scan's backward on the card: q, k, v, dh and the
    two gates read once, dq, dk, dv and the two gate gradients written
    once, and three times the forward's multiply-adds (the recompute, and
    two products for each of the forward's) at the peak of q's type; also
    that bound on the fp32 pipe, where the plain backward computes."""
    macs = mlstm_bound(q, chunk, None)[3]
    b, t, h, _ = q.shape
    nbytes = 7 * q.numel() * q.element_size() + 4 * b * t * h * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * macs / PEAK_FLOPS[q.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, 6 * macs / PEAK_FLOPS[torch.float32] * 1e3))


def time_training_mlstm(device, sizes, dtype, case=None):
    """At xlstm-350m's training shape (``mlstm_timing_case``, or ``case``
    of MLSTM_TRAIN_HAZARDS): the kernel forward and its plain version
    (``graph_ms`` on the card) and the plain backward of the Function,
    recompute and autograd (``cuda_ms``: autograd cannot be captured here),
    each beside its bound, and the backward's memory beyond its inputs."""
    case = case or sizes["mlstm_timing_case"]
    args, dh, chunk = mlstm_train_inputs(case, dtype, device)
    iters = sizes["timing_iters"]
    fwd = lambda: ops.mlstm_scan(*args, chunk=chunk)  # noqa: E731
    plain = lambda: reference_mlstm_scan(*args, chunk=chunk)  # noqa: E731
    bwd = lambda: MX.mlstm_backward(*args, dh, chunk=chunk)  # noqa: E731
    timer = (lambda fn, n: graph_ms(fn, n)) if device == "cuda" else (
        lambda fn, n: wall_ms(fn, n, device))
    eager = lambda fn, n: wall_ms(fn, n, device)  # noqa: E731
    times = {"fwd_ms": timer(fwd, iters), "fwd_plain_ms": timer(plain, iters),
             "fwd_ms_repeat": timer(fwd, iters),
             "bwd_plain_ms": eager(bwd, max(iters // 4, 1)),
             "fwd_ms_eager": eager(fwd, iters)}
    fb, fb_by, fb32, macs, nbytes = mlstm_bound(args[0], chunk, None)
    if device == "cuda":  # the kernel both dtypes took before
        times["fwd_fma_ms"] = timer(lambda: fma_scan(*args, chunk=chunk),
                                    iters)
    if device == "cuda" and dtype == torch.float32:  # ROADMAP C21
        times["fwd_split_floor_ms"] = split_floor(nbytes, 2 * macs)
    bb, bb_by, bb32 = mlstm_backward_bound(args[0], chunk)
    bwd_extra_mib = None
    if device == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bwd()
        torch.cuda.synchronize()
        bwd_extra_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    b, t, h, d = args[0].shape
    key = str(dtype).removeprefix("torch.")
    return dict(case=case, dtype=key,
                path=ms.plan(b, t, h, d, chunk, dtype).path,
                shape=f"B{b} T{t} H{h} D{d} chunk {chunk} {key}", **times,
                library_ms=None, library_note=MLSTM_NO_LIBRARY,
                bwd_plain_peak_extra_mib=bwd_extra_mib, fwd_bound_ms=fb,
                fwd_bound_by=fb_by, fwd_bound_ms_fp32_pipe=fb32,
                bwd_bound_ms=bb, bwd_bound_by=bb_by,
                bwd_bound_ms_fp32_pipe=bb32)


def time_training_attention(device, sizes, case):
    """At a training shape (TRAIN_HAZARDS ``case``): the kernel forward
    with lse, its plain version and SDPA's forward (``graph_ms``), the
    plain backward (``flash_backward``) and SDPA's backward (``cuda_ms``:
    autograd cannot be captured here), beside their bounds, and the SDPA
    backend that ran the forward.  SDPA takes ``is_causal`` where the case
    is causal over aligned positions with no binding window, else the
    case's visibility as a boolean mask (none where every key is
    visible)."""
    (q, k, v, do, qp, kp), kw = _train_inputs(case, torch.bfloat16, device)
    iters = sizes["timing_iters"]
    fwd = lambda: ops.flash_attention(q, k, v, q_pos=qp, kv_pos=kp,  # noqa
                                      return_lse=True, **kw)
    plain = lambda: reference_attention(q, k, v, q_pos=qp, kv_pos=kp,  # noqa
                                        return_lse=True, **kw)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    ok = fa.visible(qp, kp, kw["causal"], kw["window"])
    aligned = qp.shape == kp.shape and torch.equal(qp, kp)
    causal_only = aligned and torch.equal(ok, torch.ones_like(ok).tril())
    mask = None if causal_only or bool(ok.all()) else ok
    sdpa_kw = dict(attn_mask=mask, is_causal=causal_only, enable_gqa=True)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, **sdpa_kw)
    o, lse = fwd()
    bwd = lambda: MF.flash_backward(q, k, v, qp, kp, o, lse, do,  # noqa
                                    **kw)
    sq, sk, sv = _leaf_grads(qs, ks, vs)
    with torch.enable_grad():
        s_out = F.scaled_dot_product_attention(sq, sk, sv, **sdpa_kw)
    s_do = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        s_out, (sq, sk, sv), s_do, retain_graph=True)
    timer = (lambda fn, n: graph_ms(fn, n)) if device == "cuda" else (
        lambda fn, n: wall_ms(fn, n, device))
    eager = lambda fn, n: wall_ms(fn, n, device)  # noqa: E731
    times = {"fwd_ms": timer(fwd, iters), "fwd_plain_ms": timer(plain, iters),
             "fwd_library_ms": timer(sdpa, iters),
             "fwd_ms_repeat": timer(fwd, iters),
             "bwd_plain_ms": timer(bwd, max(iters // 4, 1)),
             "bwd_plain_ms_eager": eager(bwd, max(iters // 4, 1)),
             "bwd_library_ms_eager": eager(sdpa_bwd, max(iters // 2, 1)),
             "fwd_ms_eager": eager(fwd, iters)}
    fb, fb_by = bound(q, k, qp, kp, kw["causal"], kw["window"])
    bb, bb_by, bb32 = attention_backward_bound(q, k, qp, kp, kw["causal"],
                                               kw["window"])
    backend = (sdpa_backend(qs, ks, vs, attn_mask=mask,
                            is_causal=causal_only)
               if device == "cuda" else None)
    # the memory one plain backward takes beyond its inputs: its (T, S)
    # blocks of 1024 x 1024 fp32 and the fp32 copies of q, k, v, o, dO
    bwd_extra_mib = None
    if device == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bwd()
        torch.cuda.synchronize()
        bwd_extra_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    b, t, h, d = q.shape
    how = ("causal" if kw["causal"] else "non-causal") + (
        f" window {kw['window']}" if kw["window"] else "") + (
        "" if aligned else " queries at " + (
            "0" if not qp.any() else "the tail"))
    return dict(case=case, shape=f"B{b} T{t} S{k.shape[1]} H{h} "
                                 f"KV{k.shape[2]} D{d} bf16 {how}", **times,
                fwd_library_backend=backend,
                bwd_plain_peak_extra_mib=bwd_extra_mib, fwd_bound_ms=fb,
                fwd_bound_by=fb_by, bwd_bound_ms=bb, bwd_bound_by=bb_by,
                bwd_bound_ms_fp32_pipe=bb32)


def _to(tree, device):
    """A copy of ``tree`` on ``device`` (train steps update in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k],
                                                       f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def train_reduced(device, sizes):
    """The reduced models in fp32 on the card against the CPU: loss and
    every gradient of loss_and_grads, then two make_train_step steps."""
    out = {}
    for arch in sizes["reduced"]:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        data = DataConfig(vocab_size=cfg.vocab_size,
                          seq_len=sizes["reduced_seq"], global_batch=2)
        state = TR.init_train_state(SEED, cfg, device="cpu")
        got = {}
        for dev in ("cpu", device):
            st = _to(state, dev)
            loss, _, grads = TR.loss_and_grads(
                st["params"], TR.on_device(host_batch(data, 0), dev), cfg)
            step = TR.make_train_step(cfg, TR.make_rules(None),
                                      OptConfig(**TRAIN_OPT))
            losses = []
            for i in range(2):
                st, m = step(st, host_batch(data, i))
                losses.append(float(m["loss"]))
            got[dev] = (float(loss), _to(grads, "cpu"), losses,
                        _to(st["params"], "cpu"))
        (l0, g0, s0, p0), (l1, g1, s1, p1) = got["cpu"], got[device]
        rel = max(rel_or_abs(a, b) for (_, a), (_, b) in zip(
            _named_leaves(g1), _named_leaves(g0)))
        dp = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
            _named_leaves(p1), _named_leaves(p0)))
        if not (abs(l1 - l0) <= 1e-5 * abs(l0) and rel <= 1e-4
                and np.allclose(s1, s0, rtol=1e-5, atol=0) and dp <= 1e-4):
            raise AssertionError(f"{arch} reduced training: card and CPU "
                                 f"differ (loss {l1} vs {l0}, gradients "
                                 f"relative L2 {rel}, losses {s1} vs {s0}, "
                                 f"parameters by {dp})")
        out[arch] = dict(loss=l1, loss_cpu=l0, grad_rel_l2_max=rel,
                         step_losses=s1, step_losses_cpu=s0,
                         params_max_abs_diff=dp)
    return out


#: The weights whose step-1 gradient must be non-zero in every layer of
#: each block kind (an encoder's layers are "attn" blocks), and outside
#: the layers where a config has them.
GRAD_LEAVES = {"attn": ("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
               "mlstm": ("wq", "wk", "wv", "w_i", "w_f"),
               "slstm": ("w_gates", "r_gates"),
               "hymba": ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "ssm/A_log", "ssm/D", "ssm/dt_bias", "ssm/conv_w"),
               "attn_cross": ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                              "xattn/wq", "xattn/wk", "xattn/wv",
                              "xattn/wo")}
#: The mLSTM's h is continuous where its denominator max(|q n|, exp(-m))
#: switches sides, but its gradient jumps there, and rounding moves a few
#: positions across: at xlstm-350m's full depth, 15 of 172,032 positions in
#: fp32 moved its step-1 gate-bias gradients by up to 0.19 against float64,
#: 0.0088 with float64's sides (``--xlstm-witness`` on an H100; PERF.md).  So
#: the kernels' step 1 takes the plain run's side wherever its own margin
#: log|q n| - log exp(-m) is within this band of 0, by compute dtype: a
#: denominator so moved changes by a factor e^band at most.
SIDE_BAND = {"float32": 1e-2}
#: In bf16 the kernels' and the plain run's forwards part by relative L2
#: 0.00045 at xlstm-350m's first layer and 0.3 at its 22nd (the plain
#: version re-chunked: 0.25), 14,462 denominator sides differ, most far from
#: the kink (median margin 0.4), and every gradient leaf differs by about 1
#: with sides matched or not (``--xlstm-witness`` on an H100; PERF.md): two
#: correct runs of a model with mLSTM layers are not comparable as a whole
#: in these dtypes, so its step 1 is held there layer by layer.
LAYERWISE = {"bfloat16"}
@contextlib.contextmanager
def patched(*patches):
    """Within: each (object, name, value) of ``patches`` set."""
    kept = [(o, n, getattr(o, n)) for o, n, _ in patches]
    for o, n, v in patches:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in reversed(kept):
            setattr(o, n, v)


class DenominatorBranches:
    """Stands in for repro_torch.models.xlstm._denominator while set.  In
    every chunkwise mLSTM scan computed under grad (the backward's
    recompute: one call a chunk, the layers in backward order) it records
    each (batch, position, head)'s margin log|q n| - log exp(-m), whose
    sign is the side of max(|q n|, exp(-m)) taken, as one (B, T, H) tensor
    a layer (``taken``).  With ``force`` (another run's ``taken``) a
    position whose own margin is within ``band`` of 0 takes that run's
    side, and ``moved`` counts by layer the positions that then change
    side; a position is never moved further from its own side than a
    factor e^band in the denominator.  Outside grad, and on other shapes,
    it is the max."""

    def __init__(self, seq, force=None, band=0.0):
        self.seq, self.force, self.band = seq, force, band
        self.taken, self.moved, self._chunks = [], [], []

    def __call__(self, dot, m):
        floor = torch.exp(torch.clamp_max(-m, MX.EXP_MAX))
        if not torch.is_grad_enabled() or dot.dim() != 3:
            return torch.maximum(dot.abs(), floor)
        margin = (torch.log(dot.abs()) - torch.clamp_max(-m, MX.EXP_MAX)
                  ).detach().to(torch.float32)
        start = sum(c.shape[1] for c in self._chunks)
        self._chunks.append(margin)
        side = margin >= 0
        if self.force is not None:
            forced = self.force[len(self.taken)][
                :, start:start + margin.shape[1]] >= 0
            side = torch.where(margin.abs() <= self.band, forced, side)
            self._moved = getattr(self, "_moved", 0) + int(
                (side != (margin >= 0)).sum())
        if start + margin.shape[1] == self.seq:
            self.taken.append(torch.cat(self._chunks, dim=1))
            self._chunks = []
            if self.force is not None:
                self.moved.append(self._moved)
                self._moved = 0
        if self.force is None:
            return torch.maximum(dot.abs(), floor)
        return torch.where(side, dot.abs(), floor)


def _step1(params, batch, cfg, **plain):
    """(loss, {leaf name: gradient}) of loss_and_grads, with the kernels or
    (``plain``: with_plain_kernels' arguments) their plain versions."""
    def run():
        return TR.loss_and_grads(params, batch, cfg)
    loss, _, grads = with_plain_kernels(run, **plain) if plain else run()
    return float(loss), dict(_named_leaves(grads))


def _grad_stats(got, want):
    """The largest and the median leaf's relative L2 of ``got`` against
    ``want``, the largest's name, and the leaves over FULL_GRAD_REL_L2."""
    rel = {n: rel_or_abs(a, want[n]) for n, a in got.items()}
    worst = max(rel, key=rel.get)
    return {"max": rel[worst], "leaf": worst,
            "median": statistics.median(rel.values()),
            "leaves_over_tol": sum(r > FULL_GRAD_REL_L2 for r in rel.values())}


def _plain_step1(params, batch, cfg, seq):
    """Step 1 with the plain versions, the mLSTM scan differentiated by
    autograd as the reference differentiates it (without MLSTMScan):
    (loss, gradients, the DenominatorBranches that recorded its sides in
    forward order, {mLSTM layer: (its input, the loss's gradient at its
    output)})."""
    sides, at = DenominatorBranches(seq), {}
    layer = TT._train_layer

    def recorded(p, x, cfg, **kw):
        y, aux = layer(p, x, cfg, **kw)
        if kw["kind"] == "mlstm":
            i = len(at)
            at[i] = [x.detach(), None]
            y.register_hook(lambda g: at[i].__setitem__(1, g.detach()))
        return y, aux
    with patched((MX, "_denominator", sides),
                 (MX, "mlstm_scan_grad", reference_mlstm_scan),
                 (TT, "_train_layer", recorded)):
        loss, grads = _step1(params, batch, cfg, mlstm_chunk=None)
    return loss, grads, sides, at


def mlstm_layers_check(params, cfg, at):
    """Each mLSTM layer of step 1 alone, at the plain run's own input and
    output gradient (``at``): the block's output, its input gradient and
    its parameters' gradients with the kernels (the scan kernel forward,
    MLSTMScan's backward) against the plain versions (the plain scan,
    differentiated by autograd), each within FULL_GRAD_REL_L2 (relative
    L2).  Both see the same inputs, so they take the same denominator
    sides.  Returns the worst leaf of each layer."""
    layers = [i for i, k in enumerate(cfg.block_pattern) if k == "mlstm"]
    worst = {}
    for i, (x, dy) in zip(layers, at.values()):
        p = TT._cast(params["layers"][i], getattr(torch, cfg.dtype))
        got = {}
        for how in ("kernels", "plain"):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            xin = x.clone().requires_grad_(True)

            def run():
                return MX.apply_mlstm_block(leaves, xin, cfg)[0]
            with torch.enable_grad():
                if how == "plain":
                    with patched((MX, "mlstm_scan_grad",
                                  reference_mlstm_scan)):
                        y = with_plain_kernels(run)
                else:
                    y = run()
                g = torch.autograd.grad(y, [xin, *leaves.values()], dy)
            got[how] = {"out": y.detach(), "d_in": g[0],
                        **dict(zip(leaves, g[1:]))}
        rel = {k: rel_or_abs(a, got["plain"][k])
               for k, a in got["kernels"].items()}
        leaf = max(rel, key=rel.get)
        worst[f"/layers/{i}"] = (leaf, rel[leaf])
        if not rel[leaf] <= FULL_GRAD_REL_L2:
            raise AssertionError(
                f"mLSTM layer {i} ({cfg.dtype}) with the kernels and with "
                f"the plain versions at the same inputs: {leaf} differs by "
                f"relative L2 {rel[leaf]} (tol {FULL_GRAD_REL_L2}); {rel}")
    return worst


def step1_check(params, batch, cfg, seq):
    """Step 1 in ``cfg.dtype`` (remat "none": on the card remat moves no
    gradient by a bit) with the kernels against the plain versions
    (_plain_step1).  The kernels' run takes the plain run's side of each
    mLSTM denominator within SIDE_BAND of the kink (DenominatorBranches:
    the plain run records its layers in forward order, the kernels'
    recompute in backward order).  The loss within relative 1e-2 and
    every gradient leaf within FULL_GRAD_REL_L2, but in the dtypes of
    LAYERWISE for a model with mLSTM layers, whose whole-model gradients
    are reported only; and each mLSTM layer alone (mlstm_layers_check).
    Returns (the kernels' gradients, their launches, the line's
    fields)."""
    cfg = dataclasses.replace(cfg, remat="none")
    loss_p, g_p, plain, at = _plain_step1(params, batch, cfg, seq)
    band = SIDE_BAND.get(cfg.dtype, 0.0)
    kernels = DenominatorBranches(seq, plain.taken[::-1] or None, band)
    with patched((MX, "_denominator", kernels)):
        reset_launches()
        loss_k, g_k = _step1(params, batch, cfg)
        launches = kernel_launches()
    if len(kernels.taken) != len(plain.taken):
        raise AssertionError(f"step 1: the kernels' run computed "
                             f"{len(kernels.taken)} mLSTM layers' sides, "
                             f"the plain run {len(plain.taken)}")
    got = _grad_stats(g_k, g_p)
    del g_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    whole = not (at and cfg.dtype in LAYERWISE)
    if not (loss_rel <= 1e-2 and (got["max"] <= FULL_GRAD_REL_L2
                                  or not whole)):
        raise AssertionError(
            f"step 1 ({cfg.dtype}) with the kernels and with the plain "
            f"versions differ: loss {loss_k} vs {loss_p}, gradient "
            f"{got['leaf']} by relative L2 {got['max']} (tol "
            f"{FULL_GRAD_REL_L2})")
    by_layer = mlstm_layers_check(params, cfg, at) if at else None
    return g_k, launches, dict(
        loss_with_kernels=loss_k, loss_plain=loss_p, loss_rel_diff=loss_rel,
        grad_rel_l2=got, whole_model_gated=whole,
        grad_tol_rel_l2=FULL_GRAD_REL_L2,
        denominator_positions=sum(t.numel() for t in plain.taken),
        denominator_sides_moved=sum(kernels.moved), side_band=band,
        mlstm_layers_worst=by_layer,
        mlstm_layers_max=max(r for _, r in by_layer.values())
        if by_layer else None, remat=cfg.remat)


def attention_layers(cfg):
    """The attention calls of one forward: a layer each for "attn" and
    "hymba" blocks and the encoder's, two for "attn_cross" (self and
    cross)."""
    kinds = cfg.block_pattern
    return (kinds.count("attn") + kinds.count("hymba")
            + 2 * kinds.count("attn_cross")
            + (cfg.encoder_layers if cfg.is_encdec else 0))


def grad_leaves(cfg):
    """The leaves whose step-1 gradient must be non-zero (GRAD_LEAVES)."""
    need = [f"/layers/{i}/{leaf}" for i, kind in enumerate(cfg.block_pattern)
            for leaf in GRAD_LEAVES[kind]]
    if cfg.is_encdec:
        need += [f"/encoder/{i}/{leaf}" for i in range(cfg.encoder_layers)
                 for leaf in GRAD_LEAVES["attn"]]
    if cfg.num_meta_tokens:
        need.append("/meta_tokens")
    return need


def train_batch(data, i, extras):
    """Step ``i``'s batch: data.host_batch's tokens and labels and the
    frames and patch embeddings of a config that takes them
    (``extras``, model_extras')."""
    return {**host_batch(data, i), **extras}


def train_full(device, sizes, arch):
    """``arch`` (full width and depth on the card, but the depth
    ``layers_by_model`` cuts; reduced on the CPU rehearsal) in bf16
    compute, fp32 parameters, remat "full": step 1's gradients with the
    kernels against the plain versions (step1_check, in the dtypes and at
    the depth ``step1`` gives), then ``steps`` steps of make_train_step,
    timed, with every count set to 0 before.  ``seq`` positions a row:
    the prefix's, and the text's (launch/specs.py), with an encoder's
    frames beside them."""
    cfg = get_config(arch)
    if sizes["model_reduced"]:
        cfg = dataclasses.replace(cfg.reduced(), remat="full")
    reduced = []
    depth = sizes.get("layers_by_model", {}).get(arch)
    if depth:
        reduced.append(f"layers {cfg.num_layers} -> {depth}")
        cfg = cut_depth(cfg, depth)
    seq = sizes.get("seq_by_model", {}).get(arch, sizes["seq"])
    steps = sizes.get("steps_by_model", {}).get(arch, sizes["steps"])
    spec = SP.train_input_specs(cfg, ShapeConfig("chip", seq, sizes["batch"],
                                                 "train"))
    text = spec["tokens"].shape[1]
    extras = model_extras(cfg, sizes["batch"], np.random.default_rng(SEED),
                          device)
    for name, x in extras.items():
        if x.shape != spec[name].shape:
            raise AssertionError(f"{name}: {tuple(x.shape)}, the spec "
                                 f"{tuple(spec[name].shape)}")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=text,
                      global_batch=sizes["batch"])
    kinds = cfg.block_pattern
    layers = {k: kinds.count(k) for k in GRAD_LEAVES}
    n_attn = attention_layers(cfg)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = TT.init_params(SEED, cfg, device=device)
    n_params = sum(a.numel() for _, a in _named_leaves(params))
    first = TR.on_device(train_batch(data, 0, extras), device)

    def check_grads(grads, dtype, need):
        finite = bool(torch.stack([torch.isfinite(a).all()
                                   for a in grads.values()]).all())
        zero = [n for n in need if n not in grads or not grads[n].any()]
        if not (finite and not zero):
            raise AssertionError(f"step 1 gradients ({dtype}): finite "
                                 f"{finite}, zero or missing {zero}")
    dtypes, step1_depth = sizes.get("step1", {}).get(arch,
                                                     ((cfg.dtype,), None))
    cfg1, params1 = cfg, params
    if step1_depth:
        cfg1 = cut_depth(cfg, step1_depth)
        params1 = dict(params, layers=params["layers"][:step1_depth])
    step1 = {}
    for dtype in dtypes:
        g_k, launched, step1[f"step1_{dtype}"] = step1_check(
            params1, first, dataclasses.replace(cfg1, dtype=dtype), text)
        check_grads(g_k, dtype, grad_leaves(cfg1))
        step1[f"step1_{dtype}"].update(launches=launched,
                                       layers=cfg1.num_layers)
        del g_k
    need = grad_leaves(cfg)
    step1.update(step1_launches=step1[f"step1_{dtypes[0]}"]["launches"],
                 weight_grads_nonzero=len(grad_leaves(cfg1)))
    del params, params1
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    state = TR.init_train_state(SEED, cfg, device=device)
    step = TR.make_train_step(cfg, TR.make_rules(None), OptConfig(**FULL_OPT))
    setup_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    MF.backward_calls = MX.backward_calls = 0
    losses, step_ms, norms = [], [], []
    want = {"flash_attention_prefill": 2 * n_attn,
            "flash_attention_decode": 0, "flash_attention_fp32_tc": 0,
            "mlstm_scan_tc": 2 * layers["mlstm"], "mlstm_scan_fma": 0,
            "mlstm_scan_tc_f32": 0}
    want_bwd = (n_attn, layers["mlstm"])
    for i in range(steps):
        before = kernel_launches()
        bwd_before = MF.backward_calls, MX.backward_calls
        if device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, train_batch(data, i, extras))
        if device == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        launched = {key: n - before[key]
                    for key, n in kernel_launches().items()}
        bwd = (MF.backward_calls - bwd_before[0],
               MX.backward_calls - bwd_before[1])
        if bwd != want_bwd or (device == "cuda" and any(
                launched[key] != n for key, n in want.items())):
            raise AssertionError(f"train step {i}: launches {launched}, "
                                 f"backward calls (attention, mLSTM) {bwd};"
                                 f" want {want} and {want_bwd}")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            raise AssertionError(f"train step {i}: loss {losses[-1]}, "
                                 f"gradient norm {norms[-1]}")
    launches = dict(kernel_launches(),
                    flash_attention_backward=MF.backward_calls,
                    mlstm_scan_backward=MX.backward_calls)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    rows, busy_us, wall_us = device_ops(
        lambda: step(state, train_batch(data, steps, extras)), device)
    if not busy_us > 0:
        raise AssertionError(f"{arch}: the profiled step shows no device time")
    # Where a step's time goes: the gradients (forward, recompute and
    # backward), timed once (the steps above warmed it up), and the AdamW
    # update on those gradients; these gradients, of the whole model at
    # its training depth, finite and non-zero on every leaf of
    # GRAD_LEAVES.
    batch = TR.on_device(train_batch(data, 0, extras), device)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = TR.loss_and_grads(state["params"], batch, cfg)[2]
    if device == "cuda":
        torch.cuda.synchronize()
    check_grads(dict(_named_leaves(grads)), f"{cfg.dtype}, after the steps",
                need)
    parts = {"loss_and_grads_ms": (time.perf_counter() - t1) * 1e3,
             "adamw_ms": wall_ms(lambda: adamw_update(
                 state["params"], grads, state["opt"],
                 OptConfig(**FULL_OPT)), 2, device)}
    del grads
    tokens = sizes["batch"] * text
    mean_ms = statistics.mean(step_ms[1:])
    # The executed-FLOPs model of the reference (launch/analytic.py): the
    # larger of its FLOPs at the bf16 peak and its HBM bytes.
    cost = analytic.train_cost(cfg, ShapeConfig("chip", seq,
                                                sizes["batch"], "train"),
                               1, remat=cfg.remat)
    a_ops = cost.exec_flops_total / PEAK_FLOPS[torch.bfloat16] * 1e3
    a_bytes = cost.hbm_bytes_per_dev / HBM_BYTES_PER_S * 1e3
    bound = dict(analytic_bound_ms=max(a_ops, a_bytes),
                 analytic_bound_by="operations" if a_ops >= a_bytes
                 else "bytes", analytic_exec_flops=cost.exec_flops_total,
                 analytic_hbm_bytes=cost.hbm_bytes_per_dev,
                 analytic_ops_ms=a_ops, analytic_bytes_ms=a_bytes)
    if layers["attn"] == len(kinds) and not (
            cfg.num_meta_tokens or cfg.num_patch_tokens or cfg.is_encdec):
        flops, nbytes = train_step_work(cfg, sizes["batch"], seq,
                                        n_params)
        t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound.update(bound_ms=t_ops + t_bytes, bound_source="train_step_work",
                     bound_flops=flops, bound_ops_ms=t_ops,
                     bound_optimizer_bytes=nbytes, bound_bytes_ms=t_bytes)
    else:
        bound.update(bound_ms=bound["analytic_bound_ms"],
                     bound_source="analytic.train_cost")
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return dict(
        model=cfg.name, layers=cfg.num_layers, blocks=layers,
        attention_layers=n_attn, reduced=reduced,
        d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
        remat=cfg.remat, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
        batch=sizes["batch"], seq=seq, text_tokens=text,
        prefix=seq - text, encoder_frames=(cfg.encoder_seq_len
                                           if cfg.is_encdec else 0),
        steps=steps, losses=losses, grad_norms=norms, **step1,
        weight_grads_nonzero_full_depth=len(need), step_ms=step_ms,
        step_ms_mean_2_on=mean_ms, tokens_per_s=tokens / mean_ms * 1e3,
        positions_per_s=sizes["batch"] * seq / mean_ms * 1e3,
        **bound, peak_memory_gb=peak_gb, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        profiled_step_wall_us=wall_us, profiled_device_busy_us=busy_us,
        device_idle_share=1 - busy_us / wall_us,
        device_idle_share_unprofiled=1 - busy_us / (mean_ms * 1e3),
        profiled_kernels=sum(c for _, _, c in rows),
        top=[{"kernel": k[:80], "us": t, "calls": c} for k, t, c in top],
        **parts, setup_s=setup_s)


def visible_pairs(seq, window):
    """(query, key) pairs a causal layer of ``seq`` aligned positions
    sees, with a sliding ``window`` (0: none): each query t sees min(t + 1,
    window) keys."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def train_step_work(cfg, batch, seq, n_params):
    """The least work of one train step: the products of the layers'
    weights forward, recomputed (remat "full") and backward (2 + 2 + 4
    FLOP a weight and token), of the unembedding forward and backward (6),
    causal attention's products over each layer's visible pairs, which its
    window bounds (gemma3-1b's local layers see 512 keys), forward twice
    and 2.5x in the backward, and AdamW's bytes: p, g, m, v read and p, m,
    v written in fp32 (28 bytes a parameter)."""
    d, f, h, kv, dh = (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    gated = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    per_layer = d * (h + 2 * kv) * dh + h * dh * d + gated * d * f
    tokens = batch * seq
    recompute = 2 if cfg.remat == "full" else 0
    weights = (6 + recompute) * cfg.num_layers * per_layer * tokens
    head = 6 * cfg.vocab_padded * d * tokens
    pairs = sum(visible_pairs(seq, w) for w in cfg.windows)
    attn = 4 * batch * h * dh * pairs * (1 + recompute / 2 + 2.5)
    return weights + head + attn, 28 * n_params


def phase_train(device="cuda", sizes=TRAIN_FULL, launched=None):
    """The training path: hazards of the lse and the attention Function and
    of the mLSTM scan's Function, attention forward and backward at the
    training shapes (head dims 128 and 256, 12 query heads a KV head), the
    mLSTM scan forward and backward at xlstm-350m's, the reduced models card
    against CPU, then the train steps of llama3.2-3b, gemma3-1b,
    starcoder2-3b and xlstm-350m.  Returns each model's train line (its
    launches: counts set to 0 just before its steps) and the timings by
    case (the mLSTM scan's by dtype); fills ``launched``, where given, with
    the launches of the hazards (``"hazards"``) and of the reduced models'
    check (``"reduced"``), counts set to 0 just before each."""
    t0 = time.perf_counter()
    launched = {} if launched is None else launched
    reset_launches()
    worst = train_hazards(device, sizes)
    worst_mlstm = train_mlstm_hazards(device, sizes)
    launched["hazards"] = kernel_launches()
    timing = {}
    for case in sizes["timing_cases"]:
        timing[case] = time_training_attention(device, sizes, case)
        emit("train_attention", device=device, **timing[case])
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).removeprefix("torch.")
        timing[f"mlstm {key}"] = time_training_mlstm(device, sizes, dtype)
        emit("train_mlstm", device=device, kernel="mlstm_scan",
             **timing[f"mlstm {key}"])
    reset_launches()
    reduced = train_reduced(device, sizes)
    launched["reduced"] = kernel_launches()
    emit("train_reduced_vs_cpu", device=device, models=reduced)
    lines = {}
    for arch, case in sizes["models"]:
        t1 = time.perf_counter()
        full = train_full(device, sizes, arch)
        if case is None:
            bwd = dict(mlstm_backward_ms_per_step=timing["mlstm bfloat16"][
                "bwd_plain_ms"] * full["blocks"]["mlstm"],
                mlstm_timed_at=timing["mlstm bfloat16"]["shape"])
        else:
            parts = (((case, full["attention_layers"]),)
                     if isinstance(case, str) else case)
            bwd = dict(attention_backward_ms_per_step=sum(
                timing[c]["bwd_plain_ms"] * n for c, n in parts),
                attention_timed_at=[f"{timing[c]['shape']} x {n} layers"
                                    for c, n in parts],
                attention_layers_untimed=full["attention_layers"] - sum(
                    n for _, n in parts))
        emit("train", device=device, hazards=dict(
            attention_cases=len(sizes["hazards"]) * 2, attention_worst=worst,
            mlstm_cases=len(sizes["mlstm_hazards"]) * 2,
            mlstm_worst=worst_mlstm), **full, **bwd,
            seconds=time.perf_counter() - t1)
        lines[arch] = full
    emit("train_phase", device=device, seconds=time.perf_counter() - t0)
    return lines, timing


#: Phase ``xlstm_sp``: the context-parallel mLSTM at xlstm-350m's width (H4,
#: D 512: its inner width 2048 over 4 heads), B2 T1024 in fp32, the
#: sequence in 4 segments of one 256-position chunk each; the tiny sizes
#: rehearse it on the CPU.  h within relative L2 SP_REL_L2 of the fp32 scan
#: kernel's over the whole sequence.
XLSTM_SP_FULL = {"b": 2, "t": 1024, "h": 4, "d": 512, "segments": 4,
                 "chunk": 256}
XLSTM_SP_TINY = {"b": 2, "t": 128, "h": 2, "d": 32, "segments": 4,
                 "chunk": 16}
SP_REL_L2 = 1e-4


def phase_xlstm_sp(device="cuda", sizes=XLSTM_SP_FULL):
    """repro_torch.models.xlstm_sp on one card: one NCCL rank a card (C9),
    so each of ``segments`` segments runs its raw chunkwise pass
    (mlstm_chunkwise_raw) on the card and the segments' states are folded
    with the module's ``_combine`` on this one rank, in place of the
    exchanges of ``distributed_exclusive_scan``; each segment is then
    corrected with its inbound state (``apply_inbound``).  h against the
    fp32 scan kernel (csrc/mlstm_scan_fp32tc.cu) over the whole sequence
    (relative L2 SP_REL_L2), and each against float64: the elements
    outside MLSTM_TOL, as the fp32 hazard lines count them (C21)."""
    t0 = time.perf_counter()
    b, t, h, d = (sizes[k] for k in ("b", "t", "h", "d"))
    n, chunk = sizes["segments"], sizes["chunk"]
    rng = np.random.default_rng(SEED)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
    args = (draw(b, t, h, d), draw(b, t, h, d), draw(b, t, h, d),
            draw(b, t, h) * 2, F.logsigmoid(draw(b, t, h) * 2 + 1))
    seg = t // n

    def context_parallel():
        parts = [[a[:, i * seg:(i + 1) * seg] for a in args]
                 for i in range(n)]
        raws = [MX.mlstm_chunkwise_raw(*p, chunk=chunk) for p in parts]
        inbound = XSP._identity_like(raws[0][4])
        out = []
        for p, raw in zip(parts, raws):
            out.append(XSP.apply_inbound(p[0], raw, inbound))
            inbound = XSP._combine(inbound, raw[4])
        return torch.cat(out, dim=1)
    with torch.no_grad():
        got = context_parallel()
        want, _ = ops.mlstm_scan(*args, None, chunk=chunk)
        exact, _ = mlstm_float64(args, None, chunk)
    rel = rel_l2(got, want)
    if not (torch.isfinite(got).all() and rel <= SP_REL_L2):
        raise AssertionError(f"xlstm_sp: h differs from the scan kernel's "
                             f"by relative L2 {rel} (tol {SP_REL_L2})")
    tol = MLSTM_TOL[torch.float32]
    timer = (lambda fn: cuda_ms(fn, 4)) if device == "cuda" else (
        lambda fn: wall_ms(fn, 1, device))
    with torch.no_grad():
        times = dict(ms=timer(context_parallel),
                     kernel_ms=timer(lambda: ops.mlstm_scan(
                         *args, None, chunk=chunk)))
    emit("xlstm_sp", device=device, shape=f"B{b} T{t} H{h} D{d} fp32",
         segments=n, chunk=chunk, rel_l2_vs_kernel=rel, tol=SP_REL_L2,
         max_abs_err_vs_kernel=float((got - want).abs().max()),
         rel_l2_vs_float64=rel_l2(got, exact),
         kernel_rel_l2_vs_float64=rel_l2(want, exact),
         outside_tol_vs_float64=ms.outside_tol(got, exact, tol),
         kernel_outside_tol_vs_float64=ms.outside_tol(want, exact, tol),
         elements=got.numel(), float64_tol=tol, **times,
         seconds=time.perf_counter() - t0)
    return rel


#: Phase ``shard``: gemma3-1b at full width with 8 of its 26 layers (0.51 B
#: fp32 parameters; cut so that chip_smoke.py keeps its time limit), B2
#: T1024 as phase ``train`` trains it, 3 sharded steps on a
#: (1, 1) mesh of a world-1 group against 3 unsharded steps from the same
#: seed and batches; the tiny sizes rehearse it on the CPU (gloo).
SHARD_FULL = {"arch": "gemma3-1b", "reduced": False, "layers": 8,
              "seq": 1024, "batch": 2, "steps": 3}
SHARD_TINY = {"arch": "gemma3-1b", "reduced": True, "seq": 32, "batch": 2,
              "steps": 3}
SHARD_LOSS_RTOL = 1e-6
SHARD_PARAM_REL_L2 = 1e-5


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def phase_shard(device="cuda", sizes=SHARD_FULL):
    """The sharded train step (runtime.sharding, make_train_step on a
    DeviceMesh with ``grad_specs=grad_accum_specs``) of gemma3-1b on a
    (1, 1) ("data", "model") mesh of a world-1 group (NCCL on the card),
    against the unsharded step: every loss within SHARD_LOSS_RTOL and every
    parameter leaf after the last step within relative L2
    SHARD_PARAM_REL_L2 of the unsharded run; one prefill launch with lse an
    attention layer a forward (two a step under remat "full"), one
    backward call a layer a step.  Then the sharded state is saved
    (CheckpointManager.save of DTensors: gathered, written by rank 0) and
    restored with ``shardings=``, equal to the bit.  The group is destroyed
    before the phase returns, also when it fails.  Returns the sharded
    steps' launches (counts set to 0 just before them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    t0 = time.perf_counter()
    cfg = get_config(sizes["arch"])
    if sizes["reduced"]:
        cfg = dataclasses.replace(cfg.reduced(), remat="full")
    if sizes.get("layers"):
        cfg = cut_depth(cfg, sizes["layers"])
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=sizes["seq"],
                      global_batch=sizes["batch"])
    batches = [host_batch(data, i) for i in range(sizes["steps"])]
    opt = OptConfig(**FULL_OPT)
    attn = cfg.block_pattern.count("attn")

    def run(state, step):
        losses, step_ms, launched = [], [], []
        for b in batches:
            before = kernel_launches()
            bwd = MF.backward_calls
            _sync(device)
            t1 = time.perf_counter()
            state, m = step(state, b)
            _sync(device)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            launched.append(({k: n - before[k]
                              for k, n in kernel_launches().items()},
                             MF.backward_calls - bwd))
        return state, losses, step_ms, launched

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    state = TR.init_train_state(SEED, cfg, device=device)
    n_params = sum(a.numel() for _, a in _named_leaves(state["params"]))
    state, plain_losses, plain_ms, _ = run(
        state, TR.make_train_step(cfg, TR.make_rules(None), opt))
    want_params = {n: a.to("cpu", copy=True)
                   for n, a in _named_leaves(state["params"])}
    del state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    tmp = tempfile.mkdtemp(prefix=".shard_ckpt_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        mesh = init_device_mesh(device, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = TR.make_rules(mesh)
        full = TR.init_train_state(SEED, cfg, device=device)
        specs = SH.state_specs(full["params"], cfg, rules)
        state = SH.shard_tree(full, specs, mesh)
        del full
        step = TR.make_train_step(cfg, rules, opt, grad_specs=(
            SH.grad_accum_specs(state["params"], cfg, rules)))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        MF.backward_calls = 0
        state, losses, step_ms, launched = run(state, step)
        launches = dict(kernel_launches(),
                        flash_attention_backward=MF.backward_calls)
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if device == "cuda" else None)
        want = {"flash_attention_prefill": 2 * attn,
                "flash_attention_decode": 0, "flash_attention_fp32_tc": 0,
                "mlstm_scan_tc": 0, "mlstm_scan_fma": 0,
                "mlstm_scan_tc_f32": 0}
        for i, (got, bwd) in enumerate(launched):
            if bwd != attn or (device == "cuda" and any(
                    got[k] != n for k, n in want.items())):
                raise AssertionError(f"sharded step {i}: launches {got}, "
                                     f"backward calls {bwd}; want {want} "
                                     f"and {attn}")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                         plain_losses)]
        if not all(math.isfinite(x) for x in losses) or \
                max(loss_rel) > SHARD_LOSS_RTOL:
            raise AssertionError(f"sharded losses {losses} against "
                                 f"{plain_losses}")
        got_params = {n: a.full_tensor().cpu()
                      for n, a in _named_leaves(state["params"])}
        rel = {n: rel_l2(got_params[n], w) if w.norm() > 0
               else float((got_params[n] - w).norm())
               for n, w in want_params.items()}
        worst = max(rel, key=rel.get)
        if rel[worst] > SHARD_PARAM_REL_L2:
            raise AssertionError(f"parameter {worst}: relative L2 "
                                 f"{rel[worst]} from the unsharded run")
        del got_params, want_params

        # one more step under FlopCounterMode, for phase dryrun's cell:
        # the step's arguments, aten FLOPs, launches and peak memory
        batch = TR.on_device(batches[0], device)
        real_cell = {"argument_bytes": sum(
            a.to_local().numel() * a.to_local().element_size()
            for a in _leaves(state)) + sum(
            b.numel() * b.element_size() for b in batch.values())}
        flops = FlopCounterMode(display=False)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = kernel_launches()
        with flops:
            state, _ = step(state, batch)
        _sync(device)
        real_cell.update(
            flops=flops.get_total_flops(),
            launches={k: n - before[k] for k, n in kernel_launches().items()},
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if device == "cuda" else None))
        del batch

        # the checkpoint: the gathered state, then restored onto the mesh
        mgr = CheckpointManager(tmp, keep=1)
        _sync(device)
        t1 = time.perf_counter()
        mgr.save(sizes["steps"], CV.train_state_to_reference(state, cfg),
                 blocking=True)
        save_s = time.perf_counter() - t1
        gc.collect()
        npz_gb = os.path.getsize(os.path.join(
            tmp, f"step_{sizes['steps']:08d}", "data.npz")) / 1e9
        like = CV.train_state_like(state, cfg)
        t1 = time.perf_counter()
        restored = CV.train_state_from_reference(mgr.restore(
            sizes["steps"], like,
            shardings=SH.checkpoint_shardings(specs, cfg, mesh)), cfg)
        _sync(device)
        restore_s = time.perf_counter() - t1
        unequal = []
        SH.spec_map(lambda path, a, b: unequal.append(path) if not (
            tuple(a.placements) == tuple(b.placements)
            and torch.equal(a.to_local(), b.to_local())) else None,
            state, restored)
        if unequal:
            raise AssertionError(f"restored leaves differ: {unequal[:4]}")
        leaves = len(_leaves(state["params"])) * 3 + 2
        del state, restored, step
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("shard", device=device, model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
         mesh={"data": 1, "model": 1}, backend=("nccl" if device == "cuda"
                                                else "gloo"),
         grad_specs="grad_accum_specs", batch=sizes["batch"],
         seq=sizes["seq"], steps=sizes["steps"], losses=losses,
         unsharded_losses=plain_losses, loss_rel_diff_max=max(loss_rel),
         param_rel_l2_max=rel[worst], param_rel_l2_worst_leaf=worst,
         step_ms=step_ms, step_ms_mean_2_on=statistics.mean(step_ms[1:]),
         unsharded_step_ms=plain_ms,
         unsharded_step_ms_mean_2_on=statistics.mean(plain_ms[1:]),
         peak_memory_gb=peak_gb, launches=launches,
         launches_per_step={k: v / sizes["steps"]
                            for k, v in launches.items()},
         checkpoint_gb=npz_gb, checkpoint_leaves=leaves, save_s=save_s,
         restore_s=restore_s, restored_equal=True,
         seconds=time.perf_counter() - t0)
    return launches, real_cell


#: Phase ``tp``: tensor-parallel compute (models/layers.py, ssm.py,
#: xlstm.py, transformer.py) over a ("model",) mesh of ``tp`` ranks, two
#: processes sharing the one card over gloo (one card hosts one NCCL rank:
#: ROADMAP C9), against the same work on one rank in this process first.
#: Four models at published width, cut in depth so that the one-rank run,
#: then both ranks, fit the card with room and the phase keeps
#: chip_smoke.py inside its time limit: llama3.2-3b (``layers`` of its 28:
#: attention and MLP), and ``blocks``: xlstm-350m (8 of 24: seven mLSTM
#: blocks, head-parallel, and the sLSTM at layer 4, whole), hymba-1.5b (4
#: of 32: the SSM channel-parallel, the MLP on its slices, the attention
#: whole, its 25 heads not splitting over 2) and whisper-base whole (the
#: encoder over 1500 frames, self- and cross-attention at H4 a rank).  Each
#: is served in fp32 and bf16 (B4, 512-token prompts behind any prefix,
#: ``decode_steps`` greedy steps, the ranks fed the one-rank run's tokens)
#: and trained in bf16 (B2, 1024 positions a row, remat "full", llama3.2-3b
#: ``train_steps`` steps, the others ``block_train_steps``: the timed run)
#: and in fp32 (``fp32_train_steps``: the parameter check), with the
#: reference's defaults (FULL_OPT, as phase train's: at lr 1e-3 from step 1
#: llama3.2-3b's loss swings).  The tiny sizes rehearse it on the CPU.
TP_FULL = {"arch": "llama3.2-3b", "reduced": False, "layers": 8, "tp": 2,
           "blocks": {"xlstm-350m": 8, "hymba-1.5b": 4, "whisper-base": 6},
           "batch": 4, "prompt": 512, "max_seq": 1024, "decode_steps": 8,
           "train_batch": 2, "train_seq": 1024, "train_steps": 3,
           "block_train_steps": 2, "fp32_train_steps": 2, "timeout_s": 900}
TP_TINY = {"arch": "llama3.2-3b", "reduced": True, "layers": 2, "tp": 2,
           "blocks": {"xlstm-350m": 4, "hymba-1.5b": 2, "whisper-base": 2},
           "batch": 2, "prompt": 16, "max_seq": 32, "decode_steps": 3,
           "train_batch": 2, "train_seq": 32, "train_steps": 3,
           "block_train_steps": 2, "fp32_train_steps": 2, "timeout_s": 300}
#: The gates, fixed before the phase's first run on the card (llama3.2-3b's
#: update bounds after a later run, below; xlstm-350m's, hymba-1.5b's and
#: whisper-base's fixed before their first run with every other gate of
#: this comment).  fp32 logits: relative L2
#: 1e-5 of the one-rank run's, and the same greedy
#: tokens (the row-parallel products, the vocabulary's gather and the
#: attention at fewer heads sum in another order: fp32 rounding, about 1e-7
#: a sum, with two orders of room for depth).  bf16 logits: the serve
#: phase's LOGITS_TOL (each all-reduce of bf16 partial products rounds once
#: more); for the stacks that amplify rounding with depth (TP_AMPLIFIED:
#: xlstm-350m, C18's model, and hymba-1.5b, C20), the larger of LOGITS_TOL
#: and the one-rank run's own bf16 prefill logits' relative L2 from its
#: fp32 ones, the size of bf16 rounding in that stack, measured in the same
#: run.  bf16 training: each step's loss and grad_norm within 1e-2 of the
#: one-rank run's (phase train's step-1 loss tolerance); for TP_AMPLIFIED,
#: within the larger of 1e-2 and the one-rank bf16 run's own largest
#: relative distance from its fp32 run over the steps both take (losses
#: and grad norms), measured in the same run.  fp32 training:
#: losses and grad_norm within 1e-5, and each parameter's update over the
#: steps (after less before) against the one-rank run's: relative L2
#: TP_FP32_UPDATE_REL_L2 over all leaves and TP_FP32_LEAF_REL_L2 on every
#: leaf (AdamW's step is lr m / (sqrt(v) + eps): on an entry whose
#: gradient is within rounding of zero, a ratio of rounding errors, where
#: a wrong gradient moves the leaf's every entry).  The two update bounds
#: were set after a run on the card (NVIDIA H100 80GB HBM3, 700 W) read,
#: sound, 3.3e-5 over all leaves and 6.3e-5 on the worst leaf, and, with
#: each ln2 scale given only its rank's MLP-slice gradient (its tp sum
#: dropped, planted in a copy of the code), 6.2e-3 and 0.94 (an ln2
#: scale): 5e-4 and 1e-2 sit 15 and 160 times above the sound readings
#: and 12 and 94 times below the fault's.  Each rank's resident
#: parameters, gradients, m and v (fp32) at most TP_RESIDENT_SHARE of the
#: one-rank run's: the layers' leaves are halved, the norms' are whole.
#: xlstm-350m's fp32 run missed four of these on its first two runs on the
#: card (NVIDIA H100 80GB HBM3, 700 W; the same numbers both times): fp32
#: logits 4.23e-5 from one rank's, step 2's grad norm 9.4e-4 apart (step
#: 1's 8.4e-6, the losses 1.7e-7), updates 1.9e-2 over all leaves and
#: 5.1e-2 on the worst leaf, /layers/3/b_f: the mLSTM's gradient jumps
#: where its denominator switches sides (ROADMAP C18), rounding moves
#: positions across, and AdamW's next step and the stack carry it on (in
#: float64 the same layers on their slices equal one device to 1e-14,
#: tests/test_torch_tensor_parallel_blocks.py).  With the output norm's
#: sum over tp turned into reduce_tp (planted in a copy of the code) its
#: grad norms moved 0.215 and its updates 0.574 over all leaves and 2.75
#: on the worst; with the SSM's x_proj sum so planted, hymba-1.5b's moved
#: 0.0786, 0.481 and 1.08.  So xlstm-350m's fp32 gates are TP_KINKED's:
#: logits 2e-4, losses and grad norms 1e-2, updates 0.1 over all leaves
#: and 0.3 on a leaf, 4.7, 10.6, 5.3 and 5.8 times above its sound
#: readings, and the last three 7.9 to 21, 4.8 to 5.7 and 3.6 to 9.2
#: times below the planted faults' (the logits read no backward).
#: On the card also: each kernel's launches on every rank and on one, a
#: prefill, a decode run and each bf16 train step, as the layers give them
#: (tp_launch_counts), and every attention call and mLSTM scan on a rank at
#: its heads (tp_rank_shapes).
TP_FP32_REL_L2 = 1e-5
TP_BF16_REL_L2 = LOGITS_TOL
TP_BF16_LOSS_RTOL = 1e-2
TP_FP32_LOSS_RTOL = 1e-5
TP_FP32_UPDATE_REL_L2 = 5e-4
TP_FP32_LEAF_REL_L2 = 1e-2
TP_RESIDENT_SHARE = 0.55
TP_AMPLIFIED = ("xlstm-350m", "hymba-1.5b")
#: xlstm-350m's fp32 gates, set after its first runs on the card missed
#: the ones above (the comment on TP_FULL): logits, losses and grad norms,
#: updates over all leaves and on the worst leaf.
TP_KINKED = {"xlstm-350m": dict(logits=2e-4, losses=1e-2, updates=0.1,
                                leaf=0.3)}
#: The lse's training case at one rank's shape of phase tp (TRAIN_HAZARDS),
#: timed alone in the parent: llama3.2-3b's, then whisper-base's encoder
#: and cross-attention at H4.
TP_RANK_CASE = "train_tp_rank_h12_kv4"
TP_WHISPER_CASES = ("train_tp_rank_whisper_encoder_h4",
                    "train_tp_rank_whisper_cross_h4")
#: The mLSTM scan's training case at one rank's shape (MLSTM_TRAIN_HAZARDS).
TP_MLSTM_CASE = "tp_rank_training_shape"


def tp_models(sizes):
    """(arch, layers, bf16 train steps) of each model phase tp runs, the
    first llama3.2-3b's."""
    return [(sizes["arch"], sizes["layers"], sizes["train_steps"])] + [
        (arch, layers, sizes["block_train_steps"])
        for arch, layers in sizes["blocks"].items()]


def tp_config(sizes, dtype="bfloat16", arch=None, layers=None):
    cfg = get_config(arch or sizes["arch"])
    cfg = cfg.reduced() if sizes["reduced"] else cfg
    return dataclasses.replace(cut_depth(cfg, layers or sizes["layers"]),
                               dtype=dtype, remat="full")


@contextlib.contextmanager
def attention_heads(seen, scans=None):
    """Adds (heads, KV heads, head dim) of every attention call (through
    ``ops.flash_attention``, the kernel's entry on the card) to ``seen``,
    and (heads, head dim) of every mLSTM scan (``ops.mlstm_scan``) to
    ``scans`` where given."""
    kept = ops.flash_attention, ops.mlstm_scan

    def spy(q, k, v, **kw):
        seen.add((q.shape[2], k.shape[2], q.shape[3]))
        return kept[0](q, k, v, **kw)

    def scan_spy(q, *args, **kw):
        scans.add((q.shape[2], q.shape[3]))
        return kept[1](q, *args, **kw)
    ops.flash_attention = spy
    if scans is not None:
        ops.mlstm_scan = scan_spy
    try:
        yield seen
    finally:
        ops.flash_attention, ops.mlstm_scan = kept


def tp_rank_shapes(cfg, tp):
    """The attention calls' (heads, KV heads, head dim) and the mLSTM
    scans' (heads, head dim) on one of ``tp`` ranks: the query heads and
    the KV heads they read over tp where the query heads split, else whole
    (the layer computes whole: hymba-1.5b's 25); the mLSTM's heads over
    tp."""
    kinds = cfg.block_pattern
    attn = set()
    if any(k in kinds for k in ("attn", "attn_cross", "hymba")):
        rules = ML.AxisRules(tp="model", mesh=TPStandIn(tp))
        split = cfg.num_heads % tp == 0
        attn.add((cfg.num_heads // tp if split else cfg.num_heads,
                  len(ML.local_kv_heads(cfg, rules)), cfg.head_dim))
    scans = set()
    if "mlstm" in kinds:
        inner = cfg.ssm_expand * cfg.d_model
        scans.add((MX.mlstm_heads(cfg, ML.AxisRules(
            tp="model", mesh=TPStandIn(tp))), inner // cfg.num_heads))
    return sorted(attn), sorted(scans)


class TPStandIn:
    """Rank 0 of a ("model",) axis of ``tp``: what the layers read of a
    mesh to size a rank's heads, no process group."""

    mesh_dim_names = ("model",)

    def __init__(self, tp):
        self.tp = tp

    def size(self, i):
        return self.tp

    def get_local_rank(self, name):
        return 0


def tp_launch_counts(cfg, sizes):
    """Each kernel's launches on one rank (every rank computes every
    layer): a bf16 prefill, the bf16 decode steps and each bf16 train step,
    as expected_launches and the train phase count them (two prefill-kernel
    launches an attention and an mLSTM layer a step, forward and
    recompute; one backward call each)."""
    pre = expected_launches(cfg, new_tokens=0)
    dec = expected_launches(cfg, new_tokens=sizes["decode_steps"])
    n_attn, n_mlstm = attention_layers(cfg), cfg.block_pattern.count("mlstm")
    return {
        "prefill": {k: pre[k] for k in ("flash_attention_prefill",
                                        "flash_attention_decode",
                                        "mlstm_scan_tc", "mlstm_scan_tc_f32")},
        "decode": {"flash_attention_prefill": 0,
                   "flash_attention_decode": dec["flash_attention_decode"],
                   "mlstm_scan_tc": 0, "mlstm_scan_tc_f32": 0},
        "train_step": {"flash_attention_prefill": 2 * n_attn,
                       "flash_attention_backward": n_attn,
                       "flash_attention_decode": 0,
                       "flash_attention_fp32_tc": 0,
                       "mlstm_scan_tc": 2 * n_mlstm,
                       "mlstm_scan_tc_f32": 0,
                       "mlstm_backward": n_mlstm}}


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def tp_work(sizes, device, mesh=None, feed=None, arch=None, layers=None,
            steps=None):
    """Phase tp's work for one model (``arch`` at ``layers``, default
    llama3.2-3b's) on one rank (``mesh`` None) or as this rank of
    ``mesh``: serving in fp32 and bf16 (prefill, then ``decode_steps``
    greedy steps, fed ``feed``'s tokens by dtype where given), bf16
    training (``steps``) and fp32 training (``fp32_train_steps``) from seed
    SEED, with launches (counts set to 0 just before each part), times,
    the heads every attention call and mLSTM scan saw, resident and peak
    memory.  Returns it all on the CPU, with each fp32 parameter's update
    over the training (this rank's shards, and their regions)."""
    rules = TR.make_rules(mesh)
    rng = np.random.default_rng(SEED)
    cfg = tp_config(sizes, "bfloat16", arch, layers)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (sizes["batch"], sizes["prompt"]))).to(device)
    prompt = {"tokens": toks, **model_extras(cfg, sizes["batch"], rng,
                                             device)}
    start = sizes["prompt"] + TT.prefix_len(cfg, prompt)
    heads, scans = set(), set()
    out = {"serve": {}, "train": {}}

    def placed(tree, specs):
        """``tree`` placed on the mesh by ``specs`` (``tree`` as it is
        without one)."""
        if mesh is None:
            return tree
        out = SH.shard_tree(tree, specs(tree), mesh)
        del tree
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        return out

    stored = placed(init_params(SEED, cfg, device=device),
                    lambda p: SH.param_specs(p, cfg, rules))
    with attention_heads(heads, scans), torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            scfg = tp_config(sizes, dtype, arch, layers)
            # the working copy once: local tensors, each rank's tp slices
            params = SH.working_copy(TT.cast_params(stored, scfg), scfg,
                                     rules)
            prefill_fn, decode_fn = TR.make_serve_steps(scfg, rules,
                                                        sizes["max_seq"])
            reset_launches()
            logits, caches = prefill_fn(params, prompt)
            _sync(device)
            launched = {"prefill": kernel_launches()}
            # the vocabulary's logits: a padding column's -1e30 would
            # swamp any norm (prefill_logits_check)
            vocab = scfg.vocab_size
            got = [logits[..., :vocab].float().cpu()]
            mine = [logits.argmax(-1).cpu()]
            reset_launches()
            for i in range(sizes["decode_steps"]):
                tok = (mine[-1] if feed is None else feed[dtype][i]).to(device)
                logits, caches = decode_fn(params, tok, caches, start + i)
                got.append(logits[..., :vocab].float().cpu())
                mine.append(logits.argmax(-1).cpu())
            _sync(device)
            launched["decode"] = kernel_launches()
            times = {}
            if device == "cuda" and dtype == "bfloat16":
                times["prefill_ms"] = cuda_ms(
                    lambda: prefill_fn(params, prompt), iters=3, warmup=1)
                pos = start + sizes["decode_steps"]
                times["decode_step_ms"] = cuda_ms(
                    lambda: decode_fn(params, tok, caches, pos), iters=8)
            out["serve"][dtype] = dict(logits=got, tokens=mine,
                                       launches=launched, **times)
            del params, caches, logits
    del stored
    for dtype, n in (("bfloat16", steps or sizes["train_steps"]),
                     ("float32", sizes["fp32_train_steps"])):
        tcfg = tp_config(sizes, dtype, arch, layers)
        state = placed(TR.init_train_state(SEED, tcfg, device=device),
                       lambda s: SH.state_specs(s["params"], tcfg, rules))
        step = TR.make_train_step(tcfg, rules, OptConfig(**FULL_OPT), **(
            {} if mesh is None else {"grad_specs": SH.grad_accum_specs(
                state["params"], tcfg, rules)}))
        # the text the prefix leaves of train_seq (launch/specs.py), and
        # an encoder's frames
        text = SP.train_input_specs(tcfg, ShapeConfig(
            "chip", sizes["train_seq"], sizes["train_batch"],
            "train"))["tokens"].shape[1]
        extras = model_extras(tcfg, sizes["train_batch"],
                              np.random.default_rng(SEED), device)
        data = DataConfig(vocab_size=tcfg.vocab_size, seq_len=text,
                          global_batch=sizes["train_batch"])
        # parameters, gradients (placed as the parameters: no dp axis), m
        # and v, fp32, this rank's shards
        resident = 4 * sum(_local(a).numel() for a in (
            _leaves(state["params"]) * 2 + _leaves(state["opt"]["m"])
            + _leaves(state["opt"]["v"])))
        # this rank's fp32 shards before the first step: the check reads
        # each leaf's update
        before = {n: _local(a).detach().clone() for n, a in _named_leaves(
            state["params"])} if dtype == "float32" else None
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, norms, step_ms, launched = [], [], [], []
        with attention_heads(heads, scans):
            for i in range(n):
                reset_launches()
                MF.backward_calls = MX.backward_calls = 0
                _sync(device)
                t1 = time.perf_counter()
                state, m = step(state, train_batch(data, i, extras))
                _sync(device)
                step_ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                launched.append(dict(kernel_launches(),
                                     flash_attention_backward=(
                                         MF.backward_calls),
                                     mlstm_backward=MX.backward_calls))
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else None)
        out["train"][dtype] = dict(losses=losses, grad_norms=norms,
                                   step_ms=step_ms, launches=launched,
                                   resident_bytes=resident,
                                   peak_memory_gb=peak, text_tokens=text)
        if dtype == "float32":
            out["updates"] = {n: (_local(a).detach() - before[n]).cpu()
                              for n, a in _named_leaves(state["params"])}
            del before
            out["regions"] = {n: [(r.start, r.stop) for r in SH.local_region(
                tuple(a.shape), a.placements, mesh)] if mesh is not None
                else None for n, a in _named_leaves(state["params"])}
        del state, step
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    out["heads"] = sorted(heads)
    out["scans"] = sorted(scans)
    return out


def tp_rank_main(rank, world, port, outdir, device, sizes):
    """One rank of phase tp (``python3 chip_smoke.py --tp-rank ...``): a
    gloo group over localhost, a ("model",) mesh of ``world``, tp_work for
    each model (tp_models) fed the one-rank run's tokens, each result saved
    to ``outdir`` as it comes.  The group is destroyed also on failure."""
    import datetime
    import faulthandler
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    faulthandler.enable()
    rank, world = int(rank), int(world)
    sizes = json.loads(sizes)
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=sizes["timeout_s"]))
    try:
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("model",))
        feed = torch.load(os.path.join(outdir, "tokens.pt"))
        for arch, layers, steps in tp_models(sizes):
            t0 = time.perf_counter()
            res = tp_work(sizes, device, mesh, feed[arch], arch, layers,
                          steps)
            print(f"rank {rank}: {arch} in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.save(res, os.path.join(outdir, f"rank{rank}_{arch}.pt"))
            del res
            gc.collect()
    finally:
        dist.destroy_process_group()


def _tp_ranks(sizes, device, feed):
    """Starts ``tp`` processes of this script as the ranks, waits for them
    (within ``timeout_s`` in all), and returns their results, a list of
    ranks' by model; every process is joined or killed and the directory
    removed, also on failure."""
    world = sizes["tp"]
    tmp = tempfile.mkdtemp(prefix=".tp_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    procs, logs = [], []
    try:
        torch.save(feed, os.path.join(tmp, "tokens.pt"))
        port = free_port()
        for r in range(world):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank",
                 str(r), str(world), str(port), tmp, device,
                 json.dumps(sizes)], stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + sizes["timeout_s"]
        failed = []
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r}: no result in {sizes['timeout_s']} s")
                continue
            if p.returncode:
                failed.append(f"rank {r}: exit {p.returncode}")
        if failed:
            tails = []
            for r in range(world):
                logs[r].flush()
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} ---\n" + f.read()[-3000:])
            raise AssertionError("phase tp: " + "; ".join(failed) + "\n"
                                 + "\n".join(tails))
        return {arch: [torch.load(os.path.join(tmp, f"rank{r}_{arch}.pt"))
                       for r in range(world)]
                for arch, _, _ in tp_models(sizes)}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def tp_check(arch, one, ranks, sizes, device):
    """Phase tp's gates (the comment on TP_FULL) for one model: the ranks'
    results against the one-rank run's.  Returns the numbers read; raises
    after reading every gate, naming each that failed."""
    fails = []
    cfg = tp_config(sizes, arch=arch, layers=dict(
        (a, n) for a, n, _ in tp_models(sizes))[arch])
    kinked = TP_KINKED.get(arch, dict(
        logits=TP_FP32_REL_L2, losses=TP_FP32_LOSS_RTOL,
        updates=TP_FP32_UPDATE_REL_L2, leaf=TP_FP32_LEAF_REL_L2))
    # serving: logits step by step, fp32 tokens
    serve = {}
    own_bf16 = rel_l2(one["serve"]["bfloat16"]["logits"][0],
                      one["serve"]["float32"]["logits"][0])
    for dtype, tol in (("float32", kinked["logits"]),
                       ("bfloat16", max(TP_BF16_REL_L2, own_bf16)
                        if arch in TP_AMPLIFIED else TP_BF16_REL_L2)):
        want = one["serve"][dtype]
        rel = [max(rel_l2(got, w) for got, w in zip(r["serve"][dtype][
            "logits"], want["logits"])) for r in ranks]
        same = [sum(bool(torch.equal(a, b)) for a, b in zip(
            r["serve"][dtype]["tokens"], want["tokens"])) for r in ranks]
        if max(rel) > tol:
            fails.append(f"tp {arch} {dtype} logits: relative L2 {rel} "
                         f"from one rank, above {tol}")
        if dtype == "float32" and min(same) != len(want["tokens"]):
            fails.append(f"tp {arch} fp32 greedy tokens: {same} of "
                         f"{len(want['tokens'])} steps equal")
        serve[dtype] = dict(logits_rel_l2_max=max(rel), gate=tol,
                            steps_with_equal_tokens=same)
    serve["bfloat16"]["one_rank_bf16_vs_fp32_prefill_rel_l2"] = own_bf16
    # training: losses and grad norms; the fp32 parameters
    own = max(abs(a - b) / abs(b) for key in ("losses", "grad_norms")
              for a, b in zip(one["train"]["bfloat16"][key],
                              one["train"]["float32"][key]))
    train = {"one_rank_bf16_vs_fp32_rel_diff_max": own}
    for dtype, tol in (("bfloat16", max(TP_BF16_LOSS_RTOL, own)
                        if arch in TP_AMPLIFIED else TP_BF16_LOSS_RTOL),
                       ("float32", kinked["losses"])):
        want = one["train"][dtype]
        diffs = [max(abs(a - b) / abs(b) for a, b in zip(
            r["train"][dtype][key], want[key]))
            for r in ranks for key in ("losses", "grad_norms")]
        if not all(math.isfinite(x) for r in ranks
                   for x in r["train"][dtype]["losses"]) or max(diffs) > tol:
            fails.append(
                f"tp {arch} {dtype} training: losses "
                f"{[r['train'][dtype]['losses'] for r in ranks]}, grad "
                f"norms {[r['train'][dtype]['grad_norms'] for r in ranks]}"
                f" against {want['losses']}, {want['grad_norms']}")
        train[dtype] = dict(rel_diff_max=max(diffs), gate=tol)
    num = den = 0.0
    worst, worst_leaf = 0.0, None
    for name, w in one["updates"].items():
        for r in ranks:
            region = r["regions"][name]
            part = (w if region is None else w[tuple(
                slice(a, b) for a, b in region)]).to(device, torch.float64)
            d2 = float((r["updates"][name].to(device, torch.float64)
                        - part).square().sum())
            n2 = float(part.square().sum())
            num, den = num + d2, den + n2
            if n2 > 0 and (d2 / n2) ** 0.5 > worst:
                worst, worst_leaf = (d2 / n2) ** 0.5, name
    update_rel = (num / den) ** 0.5
    if update_rel > kinked["updates"] or worst > kinked["leaf"]:
        fails.append(
            f"tp {arch} fp32 parameter updates: relative L2 {update_rel} "
            f"from one rank's over all leaves (bound {kinked['updates']}), "
            f"{worst} on leaf {worst_leaf} (bound {kinked['leaf']})")
    share = [r["train"]["bfloat16"]["resident_bytes"]
             / one["train"]["bfloat16"]["resident_bytes"] for r in ranks]
    if max(share) > TP_RESIDENT_SHARE:
        fails.append(f"tp {arch} resident bytes a rank: {share} of one "
                     "rank's")
    attn, scans = tp_rank_shapes(cfg, sizes["tp"])
    if device == "cuda":
        want = tp_launch_counts(cfg, sizes)
        for r, res in enumerate(ranks + [one]):
            run = res["serve"]["bfloat16"]["launches"]
            for part in ("prefill", "decode"):
                if any(run[part][k] != n for k, n in want[part].items()):
                    fails.append(f"tp {arch} run {r} {part}: launches "
                                 f"{run[part]}, want {want[part]}")
            for i, got in enumerate(res["train"]["bfloat16"]["launches"]):
                if any(got[k] != n for k, n in want["train_step"].items()):
                    fails.append(
                        f"tp {arch} run {r} train step {i}: launches "
                        f"{got}, want {want['train_step']}")
        for r in ranks:
            if r["heads"] != attn or r["scans"] != scans:
                fails.append(
                    f"tp {arch} rank attention at {r['heads']} and mLSTM "
                    f"scans at {r['scans']}, not {attn} and {scans}")
    if fails:
        raise AssertionError("; ".join(fails) + " (read: " + json.dumps(dict(
            serve=serve, train=train, update_rel_l2=update_rel,
            worst_leaf=[worst_leaf, worst])) + ")")
    return dict(cfg=cfg, serve=serve, train=train, update_rel=update_rel,
                worst=(worst_leaf, worst), share=share, attn=attn,
                scans=scans)


#: Phase ``dryrun`` (launch/dryrun.py): phase ``shard``'s cell traced on
#: fake tensors beside its real step, then base cells of the hill climb
#: (launch/hillclimb.py) on the production meshes, each as (arch, shape,
#: multi-pod).  Of its three base cells only gemma3-1b's prefill traces
#: in the phase's time: qwen3-moe-30b-a3b's train_4k on 16x16 (16
#: microbatches of 48 MoE layers, about a million fake ops) ran for more
#: than 12 minutes on the card's host, and xlstm-350m's train_4k on
#: 2x16x16 runs the sLSTM's loop over 4,096 positions under autograd;
#: ``python -m repro_torch.launch.dryrun --all`` traces both (PERF.md).
DRYRUN_FULL = {"cells": (("gemma3-1b", "prefill_32k", False),)}
#: The CPU's rehearsal: phase shard's tiny cell alone.
DRYRUN_TINY = {"cells": ()}


def phase_dryrun(device="cuda", sizes=DRYRUN_FULL, real=None,
                 shard=SHARD_FULL):
    """The dry run (repro_torch.launch.dryrun), which traces a step on fake
    tensors of ``device``'s type as rank 0 of a ``"fake"`` group and
    launches nothing.  First phase ``shard``'s cell (``shard``'s model,
    depth, batch and positions on a (1, 1) mesh), held to ``real``, the
    readings of its real step: the argument bytes equal the real state's
    and batch's, FlopCounterMode's total equals the real step's, and each
    kernel path's calls equal the real step's launches of that path; the
    peak estimate printed beside the real step's
    ``torch.cuda.max_memory_allocated``.  Then each of ``sizes["cells"]``
    on its production mesh (256 or 512 ranks): ok, its roofline terms, its
    peak bytes a rank against 80 GB, ``trace_s``.  No process group may be
    open.  Returns the records."""
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    before = kernel_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if real is not None:
            cfg = get_config(shard["arch"])
            if shard["reduced"]:
                cfg = dataclasses.replace(cfg.reduced(), remat="full")
            if shard.get("layers"):
                cfg = cut_depth(cfg, shard["layers"])
            base = get_config(shard["arch"])
            extra = {f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)
                     if getattr(cfg, f.name) != getattr(base, f.name)}
            shape = ShapeConfig(f"train_b{shard['batch']}_t{shard['seq']}",
                                shard["seq"], shard["batch"], "train")
            rec = DR.run_cell(shard["arch"], shape, False, tmp,
                              extra_cfg=extra, mesh_shape=(1, 1),
                              mesh_axes=("data", "model"), device=device)
            if not rec.get("ok"):
                raise AssertionError(f"dryrun of phase shard's cell: "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback')}")
            calls = {f"{kernel}_{path}": rec["kernel_calls"].get(
                         path, {}).get("calls", 0)
                     for kernel, mod in (("flash_attention", fa),
                                         ("mlstm_scan", ms))
                     for path in mod.launches_by_path}
            launched = {k: real["launches"][k] for k in calls}
            got = {"argument_bytes": rec["memory"]["argument_bytes"],
                   "flops": rec["flop_counter_flops"]}
            want = {"argument_bytes": real["argument_bytes"],
                    "flops": real["flops"]}
            if got != want or (device == "cuda" and calls != launched):
                raise AssertionError(f"dryrun of phase shard's cell: {got} "
                                     f"and kernel calls {calls}; the real "
                                     f"step: {want}, launches {launched}")
            peak = rec["memory"]["peak_estimate_bytes"]
            held = real["max_memory_allocated"]
            out["shard"] = rec
            emit("dryrun", cell=f"{shard['arch']} ({cfg.num_layers} layers) "
                 f"B{shard['batch']} T{shard['seq']} on (1, 1)",
                 device=device, **got, kernel_calls=calls,
                 real_launches=launched, memory=rec["memory"],
                 peak_estimate_bytes=peak, real_max_memory_allocated=held,
                 peak_over_real=peak / held if held else None,
                 trace_s=rec["trace_s"], traced_ops=rec["traced_ops"])
        for arch, shape, multi in sizes["cells"]:
            rec = DR.run_cell(arch, shape, multi, tmp, device=device)
            if not rec.get("ok"):
                raise AssertionError(f"dryrun {arch} {shape}: "
                                     f"{rec.get('error')}\n"
                                     f"{rec.get('traceback')}")
            out[f"{arch} {shape}"] = rec
            peak = rec["memory"]["peak_estimate_bytes"]
            emit("dryrun", cell=f"{arch}__{shape}__"
                 f"{'pod2x16x16' if multi else 'pod16x16'}", device=device,
                 roofline=rec["roofline"], memory=rec["memory"],
                 peak_gb_a_rank=peak / 1e9, hbm_gb=DR.HBM_BYTES / 1e9,
                 fits_hbm=rec["fits_hbm"],
                 wire_gb_a_rank=rec["collectives"][
                     "total_wire_gbytes_per_dev"],
                 collectives=rec["collectives"]["counts"],
                 kernel_calls=rec["kernel_calls"],
                 grad_accum=rec.get("grad_accum"), trace_s=rec["trace_s"],
                 traced_ops=rec["traced_ops"])
    if kernel_launches() != before:
        raise AssertionError("the dry run launched a kernel")
    emit("dryrun_phase", device=device, seconds=time.perf_counter() - t0)
    return out


def phase_tp(device="cuda", sizes=TP_FULL):
    """Tensor-parallel serving and training of each model of tp_models
    (the comment on TP_FULL says what runs, and the one on the gates what
    they hold): every model on one rank in this process first, then ``tp``
    ranks in processes of their own, each running every model; then each
    model's gates (tp_check) and lines, raising after every model's gates
    are read.  On the card also the kernels timed
    alone at a rank's shapes.  Returns rank 0's launches by model and run
    (counts set to 0 just before each part) and those timings."""
    t0 = time.perf_counter()
    one = {}
    for arch, layers, steps in tp_models(sizes):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        one[arch] = tp_work(sizes, device, arch=arch, layers=layers,
                            steps=steps)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    feed = {arch: {dtype: run["tokens"] for dtype, run in res[
        "serve"].items()} for arch, res in one.items()}
    ranks = _tp_ranks(sizes, device, feed)
    tp = sizes["tp"]
    world_note = (f"{tp} ranks sharing one card over gloo (host-staged "
                  "all-reduces), not tensor parallelism across cards")
    launches, failed = {}, []
    for arch, layers, steps in tp_models(sizes):
        try:
            got = tp_check(arch, one[arch], ranks[arch], sizes, device)
        except AssertionError as e:    # every model's gates are read first
            failed.append(str(e))
            continue
        cfg, res, r0 = got["cfg"], one[arch], ranks[arch][0]
        full = get_config(arch)
        emit("tp", device=device, model=cfg.name, layers=layers,
             reduced=(f"depth: {layers} of {full.num_layers} layers; width "
                      "as published" if layers < full.num_layers
                      else "none: width and depth as published"),
             d_model=cfg.d_model, heads=cfg.num_heads,
             kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
             vocab=cfg.vocab_size, mesh={"model": tp}, backend="gloo",
             note=world_note,
             rank_attention_shape=(list(got["attn"][0]) if got["attn"]
                                   else None),
             rank_attention_shapes=got["attn"], rank_scan_shapes=got["scans"],
             one_rank_attention_shapes=res["heads"],
             one_rank_scan_shapes=res["scans"],
             serve_batch=sizes["batch"], prompt=sizes["prompt"],
             prefix=TT.prefix_len(cfg, model_extras(
                 cfg, 1, np.random.default_rng(SEED), "cpu")),
             decode_steps=sizes["decode_steps"], serve=got["serve"],
             train_batch=sizes["train_batch"], train_seq=sizes["train_seq"],
             text_tokens=res["train"]["bfloat16"]["text_tokens"],
             train_steps=steps, fp32_train_steps=sizes["fp32_train_steps"],
             train=got["train"],
             losses={dtype: {"one_rank": res["train"][dtype]["losses"],
                             "ranks": [r["train"][dtype]["losses"]
                                       for r in ranks[arch]]}
                     for dtype in ("bfloat16", "float32")},
             grad_norms={dtype: {"one_rank": res["train"][dtype][
                 "grad_norms"], "ranks": [r["train"][dtype]["grad_norms"]
                                          for r in ranks[arch]]}
                 for dtype in ("bfloat16", "float32")},
             fp32_update_rel_l2=got["update_rel"],
             fp32_update_rel_l2_worst_leaf=list(got["worst"]),
             resident_gb={"one_rank": res["train"]["bfloat16"][
                 "resident_bytes"] / 1e9, "ranks": [
                 r["train"]["bfloat16"]["resident_bytes"] / 1e9
                 for r in ranks[arch]]}, resident_share=got["share"],
             launches_rank0={"serve_bf16": r0["serve"]["bfloat16"][
                 "launches"], "serve_fp32": r0["serve"]["float32"][
                 "launches"], "train_bf16_step": r0["train"]["bfloat16"][
                 "launches"][-1]},
             seconds=time.perf_counter() - t0)

        def times(res):
            return {"prefill_ms": {d: res["serve"][d].get("prefill_ms")
                                   for d in res["serve"]},
                    "decode_step_ms": {d: res["serve"][d].get(
                        "decode_step_ms") for d in res["serve"]},
                    "step_ms": {d: res["train"][d]["step_ms"]
                                for d in res["train"]},
                    "peak_memory_gb": {d: res["train"][d]["peak_memory_gb"]
                                       for d in res["train"]}}
        emit("tp_times", device=device, model=cfg.name, layers=layers,
             note=world_note, one_rank=times(res),
             ranks=[times(r) for r in ranks[arch]])

        def summed(*runs):
            return {k: sum(run[k] for run in runs) for k in runs[0]}
        launches[arch] = {
            "serve_bf16": summed(*r0["serve"]["bfloat16"][
                "launches"].values()),
            "serve_fp32": summed(*r0["serve"]["float32"]["launches"].values()),
            "train_bf16": summed(*r0["train"]["bfloat16"]["launches"]),
            "train_fp32": summed(*r0["train"]["float32"]["launches"])}
    if failed:
        raise AssertionError("phase tp: " + " | ".join(failed))
    if device != "cuda":
        return launches, None
    # the kernels alone at a rank's shapes: llama3.2-3b's attention,
    # xlstm-350m's mLSTM scan (serving and the training forward),
    # whisper-base's encoder, cross-attention and decode
    cfg = tp_config(sizes)
    b, h, kvh, d = sizes["batch"], *tp_rank_shapes(cfg, tp)[0][0]
    rank_tag = "tp rank"
    timing = {
        "prefill": time_attention(
            "prefill", b, sizes["prompt"], sizes["prompt"], h, kvh, d,
            None, copies=1, phase="attention",
            model=f"{cfg.name} ({rank_tag})"),
        "decode": time_attention(
            "decode", b, 1, sizes["max_seq"], h, kvh, d, [DECODE_POS],
            copies=8, phase="attention", model=f"{cfg.name} ({rank_tag})"),
        "lse": time_training_attention(device, TRAIN_FULL, TP_RANK_CASE)}
    emit("train_attention", device=device, **timing["lse"])
    xl = tp_config(sizes, arch="xlstm-350m",
                   layers=sizes["blocks"]["xlstm-350m"])
    xh, xd = tp_rank_shapes(xl, tp)[1][0]
    timing["scan"] = time_mlstm(torch.bfloat16, shape=(
        b, sizes["prompt"], xh, xd), model=f"{xl.name} ({rank_tag})")
    timing["scan_training"] = time_training_mlstm(
        device, TRAIN_FULL, torch.bfloat16, case=TP_MLSTM_CASE)
    emit("train_mlstm", device=device, model=f"{xl.name} ({rank_tag})",
         **timing["scan_training"])
    wh = tp_config(sizes, arch="whisper-base",
                   layers=sizes["blocks"]["whisper-base"])
    (wq, wkv, wd), = tp_rank_shapes(wh, tp)[0]
    s = wh.encoder_seq_len
    tags = dict(phase="attention", model=f"{wh.name} ({rank_tag})",
                causal=False)
    timing["whisper_encoder"] = time_attention(
        "encoder", b, s, s, wq, wkv, wd, None, copies=1, **tags)
    timing["whisper_cross"] = time_attention(
        "cross prefill", b, sizes["prompt"], s, wq, wkv, wd,
        [0] * sizes["prompt"], copies=1, **tags)
    timing["whisper_cross_decode"] = time_attention(
        "cross decode", b, 1, s, wq, wkv, wd, [0], copies=8, **tags)
    for case in TP_WHISPER_CASES:
        timing[case] = time_training_attention(device, TRAIN_FULL, case)
        emit("train_attention", device=device, **timing[case])
    return launches, timing


# ---------------------------------------------------------------------------
# The xlstm-350m step-1 witness (python3 chip_smoke.py --xlstm-witness):
# step 1's gradients in float64 beside the same step in fp32, with the
# kernels and with the plain versions, and mixes that compute one part in
# the other precision, each read layer by layer against float64.
# ---------------------------------------------------------------------------

_TO_F32 = torch.Tensor.float


def _float64_patches():
    """``.float()`` keeps a float64 tensor float64 and the xLSTM blocks'
    zero states are float64: a float64 model then computes in float64
    every op that computes in fp32 for bf16 and fp32 models."""
    zero, cache = MX._zero_state, MX.init_slstm_cache

    def keep64(self, *a, **kw):
        return self if self.dtype == torch.float64 else _TO_F32(self, *a, **kw)
    return [(torch.Tensor, "float", keep64),
            (MX, "_zero_state", lambda *a, **kw: tuple(
                s.double() for s in zero(*a, **kw))),
            (MX, "init_slstm_cache", lambda *a, **kw: {
                k: s.double() for k, s in cache(*a, **kw).items()})]


def _mlstm_scan_fp32_patches():
    """In a float64 model: the mLSTM scan (forward and backward) in fp32."""
    def f32_inputs(q, k, v, log_i, log_f):
        return (_TO_F32(q) / math.sqrt(q.shape[-1]), *map(_TO_F32, (
            k, v, log_i, log_f)))
    zero = MX._zero_state
    return [(MX, "_f32_inputs", f32_inputs),
            (MX, "_zero_state", lambda *a, **kw: tuple(
                _TO_F32(s) for s in zero(*a, **kw)))]


def _slstm_scan_fp32_patches():
    """In a float64 model: the sLSTM recurrence in fp32."""
    scan = MX.slstm_scan

    def slstm_fp32(wx, r, *state, nh):
        return scan(_TO_F32(wx), _TO_F32(r), *map(_TO_F32, state), nh=nh)
    return [(MX, "slstm_scan", slstm_fp32)]


def _mlstm_backward_f64_patches():
    """In an fp32 model: the mLSTM Function's backward in float64."""
    bwd = MX.mlstm_backward

    def bwd64(*args, chunk):
        with patched(*_float64_patches()):
            grads = bwd(*(a.double() for a in args), chunk=chunk)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args))
    return [(MX, "mlstm_backward", bwd64)]


def _rel64(a, b):
    """Relative L2 of ``a`` against ``b`` in float64 (the largest |a| where
    ``b`` is all zeros)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm()) if b.any() else float(
        a.abs().max())


def _witness_run(params, batch, cfg, plain, patches, branches):
    """Step 1 (remat "none") in ``cfg.dtype`` with ``patches`` and the
    DenominatorBranches ``branches`` set: the loss, the gradients by leaf
    name, each layer's output and the gradient of the loss at it, and each
    mLSTM layer's forget-gate pre-activation gradient by position (the
    terms of its ``b_f`` gradient)."""
    outs, d_outs, d_pre_f = [], {}, []
    layer = TT._train_layer

    def recorded(*a, **kw):
        x, aux = layer(*a, **kw)
        i = len(outs)
        outs.append(x.detach().double())
        x.register_hook(lambda g: d_outs.__setitem__(i, g.detach().double()))
        return x, aux

    class HookedF:
        """torch.nn.functional, but logsigmoid of the mLSTM's (B, T, H)
        forget-gate pre-activation records its gradient."""
        def __getattr__(self, name):
            return getattr(F, name)

        def logsigmoid(self, x):
            if x.dim() == 3 and x.requires_grad:
                i = len(d_pre_f)
                d_pre_f.append(None)
                x.register_hook(lambda g: d_pre_f.__setitem__(
                    i, g.detach().double()))
            return F.logsigmoid(x)
    with patched((TT, "_train_layer", recorded), (MX, "F", HookedF()),
                 (MX, "_denominator", branches), *patches):
        reset_launches()
        loss, grads = _step1(params, batch, cfg,
                             **({"mlstm_chunk": plain} if plain else {}))
        launches = kernel_launches()
    return dict(loss=loss, grads=grads, outs=outs,
                d_outs=[d_outs[i] for i in range(len(outs))],
                d_pre_f=d_pre_f, launches=launches)


#: The witness's runs: (name, compute dtype, the plain versions (their
#: mLSTM chunk; None: with the kernels), patches, the run whose
#: denominator sides it takes near the kink and the band (None: its own)).
#: The first is the float64 witness every run is read against; each run is
#: also read against its dtype's plain run ("fp32 plain", "bf16 plain").
WITNESS_RUNS = (
    ("float64", "float64", 256, _float64_patches, None),
    ("float64 re-chunked 128", "float64", 128, _float64_patches, None),
    ("fp32 plain", "float32", 256, list, None),
    ("fp32 kernels", "float32", None, list, None),
    ("fp32 plain re-chunked 128", "float32", 128, list, None),
    ("float64, mLSTM scan in fp32", "float64", 256,
     lambda: _float64_patches() + _mlstm_scan_fp32_patches(), None),
    ("float64, sLSTM recurrence in fp32", "float64", 256,
     lambda: _float64_patches() + _slstm_scan_fp32_patches(), None),
    ("fp32 plain, mLSTM backward in float64", "float32", 256,
     _mlstm_backward_f64_patches, None),
    ("fp32 kernels, mLSTM backward in float64", "float32", None,
     _mlstm_backward_f64_patches, None),
    ("fp32 plain at float64's sides", "float32", 256, list,
     ("float64", 1e-2)),
    ("fp32 kernels at float64's sides", "float32", None, list,
     ("float64", 1e-2)),
    ("fp32 kernels at fp32 plain's sides", "float32", None, list,
     ("fp32 plain", 1e-2)),
    ("fp32 plain re-chunked 128 at fp32 plain's sides", "float32", 128, list,
     ("fp32 plain", 1e-2)),
    ("bf16 plain", "bfloat16", 256, list, None),
    ("bf16 kernels", "bfloat16", None, list, None),
    ("bf16 plain re-chunked 128", "bfloat16", 128, list, None),
    *((f"bf16 kernels at bf16 plain's sides, band {band}", "bfloat16", None,
       list, ("bf16 plain", band)) for band in (0.03, 0.1, 0.3, 1.0)),
    ("bf16 plain re-chunked 128 at bf16 plain's sides, band 0.3",
     "bfloat16", 128, list, ("bf16 plain", 0.3)))


def _read(got, ref, mlstm_layers):
    """``got`` (a _witness_run) against ``ref``: the loss, every gradient
    leaf's relative L2 (largest, median, the worst, each layer's worst)
    and norm ratio, each layer's output and output gradient, and each
    mLSTM layer's forget-gate terms and ``b_f`` gradient."""
    rel = {n: _rel64(a, ref["grads"][n]) for n, a in got["grads"].items()}
    ratio = [float(a.double().norm() / ref["grads"][n].double().norm())
             for n, a in got["grads"].items() if ref["grads"][n].any()]
    by_layer = collections.defaultdict(float)
    for n, r in rel.items():
        key = "/".join(n.split("/")[:3]) if n.startswith("/layers/") else n
        by_layer[key] = max(by_layer[key], r)
    return dict(
        loss_rel_diff=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_rel_l2_max=max(rel.values()),
        grad_rel_l2_median=statistics.median(rel.values()),
        leaves_over_tol=sum(r > FULL_GRAD_REL_L2 for r in rel.values()),
        worst=sorted(rel.items(), key=lambda kv: -kv[1])[:8],
        norm_ratio_range=[min(ratio), max(ratio)],
        grad_rel_l2_by_layer=dict(by_layer),
        out_rel_l2=[_rel64(a, b) for a, b in zip(got["outs"], ref["outs"])],
        d_out_rel_l2=[_rel64(a, b) for a, b in zip(got["d_outs"],
                                                    ref["d_outs"])],
        d_pre_f_rel_l2={f"layer {i}": _rel64(a, b) for i, a, b in zip(
            mlstm_layers, got["d_pre_f"], ref["d_pre_f"])},
        b_f_rel_l2={f"layer {i}": rel[f"/layers/{i}/b_f"]
                    for i in mlstm_layers})


def _sides(taken, ref):
    """Positions whose denominator side differs from ``ref``'s, by layer,
    and quantiles of their own |margin|."""
    differ = [(t >= 0) != (r >= 0) for t, r in zip(taken, ref)]
    far = torch.cat([t[d].abs() for t, d in zip(taken, differ)])
    q = (far.quantile(torch.tensor([0.5, 0.9, 0.99, 1.0], device=far.device))
         .tolist() if far.numel() else None)
    return dict(by_layer=[int(d.sum()) for d in differ],
                total=int(sum(d.sum() for d in differ)),
                own_margin_q50_q90_q99_max=q)


#: What each witness line prints (the rest goes to its JSON file).
_WITNESS_PRINTED = ("loss_rel_diff", "grad_rel_l2_max", "grad_rel_l2_median",
                    "leaves_over_tol", "worst", "norm_ratio_range")


def xlstm_witness(device="cuda", reduced=False, seq=1024, batch=2,
                  out=None):
    """xlstm-350m's step 1 (the train phase's first batch) in each of
    WITNESS_RUNS, read against float64 and against its dtype's plain run
    (``_read``), with where its denominator sides differ from theirs
    (``_sides``); float64's own line gives the loss's gradient norm at
    each layer's output and each mLSTM layer's forget-gate terms: their
    sum (the ``b_f`` gradient) and its cancellation |sum| / sum |term| by
    head."""
    cfg = get_config("xlstm-350m")
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    params32 = TT.init_params(SEED, cfg, device=device)
    first = TR.on_device(host_batch(data, 0), device)
    mlstm_layers = [i for i, k in enumerate(cfg.block_pattern)
                    if k == "mlstm"]
    refs, sides, lines = {}, {}, []
    for name, dtype, plain, patches, forced in WITNESS_RUNS:
        t0 = time.perf_counter()
        params = (_cast_tree(params32, torch.float64) if dtype == "float64"
                  else params32)
        branches = DenominatorBranches(
            seq, *((sides[forced[0]], forced[1]) if forced else ()))
        got = _witness_run(params, first, dataclasses.replace(
            cfg, dtype=dtype), plain, patches(), branches)
        del params
        sides[name] = branches.taken
        line = dict(run=name, loss=got["loss"],
                    seconds=time.perf_counter() - t0,
                    launches={k: v for k, v in got["launches"].items() if v},
                    floor_side_share=[float((t < 0).float().mean())
                                      for t in branches.taken],
                    sides_moved_by_force=branches.moved or None)
        if not refs:
            line.update(
                d_out_norm=[float(g.norm()) for g in got["d_outs"]],
                b_f_terms={f"layer {i}": dict(
                    sum=g.sum(dim=(0, 1)).tolist(),
                    cancellation=(g.sum(dim=(0, 1)).abs() / g.abs().sum(
                        dim=(0, 1))).tolist())
                    for i, g in zip(mlstm_layers, got["d_pre_f"])})
        own = {"float32": "fp32 plain",
               "bfloat16": "bf16 plain"}.get(dtype)
        for ref in ("float64", own):
            if ref in refs and ref != name:
                line[f"vs {ref}"] = dict(_read(got, refs[ref], mlstm_layers),
                                         sides=_sides(sides[name],
                                                      sides[ref]))
        if name in ("float64", own):
            refs[name] = got
        del got
        lines.append(line)
        emit("xlstm_witness", device=device, model=cfg.name,
             layers=cfg.num_layers, seq=seq, batch=batch, run=name,
             loss=line["loss"], seconds=line["seconds"],
             **{ref: {k: v[k] for k in _WITNESS_PRINTED}
                for ref, v in line.items() if ref.startswith("vs ")})
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    if out:
        with open(out, "w") as f:
            json.dump(lines, f, indent=1)
    return lines


# ---------------------------------------------------------------------------
# The activation A/Bs (python3 chip_smoke.py --gelu-ab, --silu-ab): a
# model's prefill, decode step and train step with each way of computing
# its MLP's activation.
# ---------------------------------------------------------------------------

def _gelu_constants_each_call(x):
    """layers.gelu_tanh as first written: each constant made as a tensor
    on x's device at every call."""
    def const(c):
        return torch.tensor(c, dtype=x.dtype, device=x.device)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


#: name: (the layers function the dense and MoE MLPs call, its variants,
#: the models and whether each takes train steps)
ACTIVATION_AB = {
    "gelu": ("gelu_tanh", {
        "F.gelu": lambda x: F.gelu(x, approximate="tanh"),
        "op by op, constants made each call": _gelu_constants_each_call,
        "op by op, scalar constants": ML.gelu_tanh},
        (("gemma3-1b", True),)),
    "silu": ("silu", {"F.silu": F.silu, "op by op": ML.silu_op_by_op},
             (("llama3.2-3b", True), ("granite-moe-3b-a800m", False)))}


def activation_ab(which, steps=4, rounds=4):
    """Each model of ACTIVATION_AB[which] at full width and depth with each
    variant in turn, ``rounds`` times in the order A B .. B A: prefill ms
    (B4 T512, bf16, mean of 10), decode step ms at fill DECODE_POS (mean
    of 50), and where it trains the mean train step ms (B2 T1024, remat
    "full", after one step's warm-up); every reading, and each variant's
    median; then each variant's kernels and device busy time in one
    prefill and one decode step (torch.profiler); one line a model."""
    name, variants, models = ACTIVATION_AB[which]
    for arch, train in models:
        cfg = get_config(arch)
        params = TT.cast_params(init_params(SEED, cfg, device="cuda"), cfg)
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (len(PROMPTS), max(PROMPTS)))
        batch = {"tokens": torch.from_numpy(toks).cuda()}
        logits, caches = TT.prefill(params, batch, cfg, MAX_SEQ)
        nxt = logits.argmax(-1)
        if train:
            state = TR.init_train_state(SEED, cfg, device="cuda")
            step = TR.make_train_step(cfg, TR.make_rules(None),
                                      OptConfig(**FULL_OPT))
            data = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                              global_batch=2)
        order = [*variants, *reversed(variants)] * rounds
        got = collections.defaultdict(list)
        for variant in order:
            fn = variants[variant]
            with patched((ML, name, fn), (TM, name, fn)):
                reading = dict(
                    prefill_ms=cuda_ms(
                        lambda: TT.prefill(params, batch, cfg, MAX_SEQ),
                        iters=10, warmup=1),
                    decode_step_ms=cuda_ms(
                        lambda: TT.decode_step(params, nxt, caches,
                                               DECODE_POS, cfg, MAX_SEQ),
                        iters=50))
                if train:
                    ms = []
                    for i in range(steps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, _ = step(state, host_batch(data, i))
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    reading["train_step_ms"] = statistics.mean(ms[1:])
            got[variant].append(reading)
        median = {v: {k: statistics.median(r[k] for r in runs)
                      for k in runs[0]} for v, runs in got.items()}
        device = {}
        for variant, fn in variants.items():
            with patched((ML, name, fn), (TM, name, fn)):
                for what, call in (
                        ("prefill", lambda: TT.prefill(params, batch, cfg,
                                                       MAX_SEQ)),
                        ("decode_step", lambda: TT.decode_step(
                            params, nxt, caches, DECODE_POS, cfg, MAX_SEQ))):
                    rows, busy_us, _ = device_ops(call, "cuda")
                    device[f"{variant}: {what}"] = dict(
                        kernels=sum(c for _, _, c in rows), busy_us=busy_us)
        emit(f"{which}_ab", model=cfg.name, order=order, median=median,
             readings=dict(got), device=device,
             prefill_shape=f"B{len(PROMPTS)} T{max(PROMPTS)}",
             decode_at=DECODE_POS,
             train_shape="B2 T1024 remat full" if train else None,
             train_steps_averaged=steps - 1 if train else None)
        del params, caches, logits, nxt
        if train:
            del state, step
        gc.collect()
        torch.cuda.empty_cache()


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# Extraction (repro_torch.workload.extract): a training step's collectives,
# recorded as the step posts them, lowered into a phased Workload and
# replayed on the card, on the CPU and on the numpy oracle.  One card hosts
# one NCCL rank, so the full-width steps run as rank 0 of an 8-rank
# recording group (torch's "fake" backend): every call is posted with its
# real shape and order, no data moves, and the step's outputs are not
# results.
# ---------------------------------------------------------------------------

#: granite's MoE layer at published width (B4 T512 a rank, 48 stored
#: experts over 8 EP ranks: 6 a rank, capacity 512) and llama3.2-3b's
#: manual-DP step at published width and depth (B8 T1024, B1 a rank);
#: ``cli`` are the reference-size extractions as processes of their own:
#: (step, devices, phases, packets, ideal = completion cycles).  The
#: pipeline's 84 packets and 26 cycles are the port's bf16 shift; the
#: reference's CPU HLO widens it to f32, 144 and 46
#: (tests/test_torch_extract.py).
EXTRACT_FULL = {
    "moe": {"arch": "granite-moe-3b-a800m", "reduced": False, "devices": 8,
            "batch": 4, "seq": 512, "bytes_per_packet": 65536, "iters": 10},
    "dp": {"arch": "llama3.2-3b", "reduced": False, "devices": 8,
           "batch": 8, "seq": 1024, "bytes_per_packet": 1048576},
    "cli": (("moe", 8, 14, 896, 112), ("dp", 8, 182, 3360, 420),
            ("pipeline", 4, 11, 84, 26)),
    "serving": {"n": 16, "cycles": 64, "packets_per_request": 4,
                "slo": 40.0}}
#: The same phase at a size the CPU runs in seconds.
EXTRACT_TINY = dict(
    EXTRACT_FULL,
    moe=dict(EXTRACT_FULL["moe"], reduced=True, seq=16, bytes_per_packet=256,
             iters=1),
    dp=dict(EXTRACT_FULL["dp"], reduced=True, seq=32, bytes_per_packet=256))


def replay_three(w, n, device):
    """``w`` replayed on CIN-xor-``n`` on the card, the CPU and the numpy
    oracle: completion and every phase's cycles equal, completion at
    least the bound; the cycles and each replay's wall seconds."""
    topo = S.cin_topology("xor", n)
    runs, wall = {}, {}
    for name, kw in (("card", dict(backend="torch", device=device)),
                     ("cpu", dict(backend="torch", device="cpu")),
                     ("oracle", dict(backend="numpy"))):
        t0 = time.perf_counter()
        runs[name] = S.replay(topo, "minimal", w, **kw)
        wall[name] = time.perf_counter() - t0
    a = runs["oracle"]
    for name, st in runs.items():
        if (st.completion_cycles != a.completion_cycles
                or list(st.phase_cycles) != list(a.phase_cycles)):
            raise AssertionError(f"{w.name}: the {name} replay differs from "
                                 f"the oracle's ({st.completion_cycles} vs "
                                 f"{a.completion_cycles} cycles)")
    if not a.completion_cycles >= a.ideal_cycles == w.ideal_cycles:
        raise AssertionError(f"{w.name}: completion {a.completion_cycles} "
                             f"below the bound {a.ideal_cycles}")
    return {"phases": w.num_phases, "packets": w.num_packets,
            "ideal_cycles": a.ideal_cycles,
            "completion_cycles": a.completion_cycles,
            "replay_wall_s": wall}


def lower(ops, n, bpp, name):
    t0 = time.perf_counter()
    w = XT.workload_from_ops(ops, ("xor", n), bytes_per_packet=bpp,
                             name=name)
    return w, time.perf_counter() - t0


def extract_moe(device, sizes):
    """granite's MoE layer forward as rank 0 of the EP group: 2(N-1)
    permutes of one rank's dispatch bucket (e_loc x capacity x d_model)."""
    cfg = get_config(sizes["arch"])
    if sizes["reduced"]:
        cfg = cfg.reduced()
    n, b, t = sizes["devices"], sizes["batch"], sizes["seq"]
    e_loc = TM.expert_store_count(cfg) // n
    cap = TM._capacity(b * t, cfg)
    chunk = e_loc * cap * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    with XT.recording_group(n):
        run = XT.moe_step(n, cfg=cfg, batch=b, seq=t, device=device)
        t0 = time.perf_counter()
        ops = XT.record(run)
        if device == "cuda":
            torch.cuda.synchronize()
        record_s = time.perf_counter() - t0
        layer_ms = wall_ms(run, sizes["iters"], device)
    want = [("collective-permute", chunk, n)] * (2 * (n - 1))
    if [(o.kind, o.raw_bytes, o.group_size) for o in ops] != want:
        raise AssertionError(f"moe: recorded {ops[:3]}..., not "
                             f"{2 * (n - 1)} permutes of {chunk} B")
    w, lower_s = lower(ops, n, sizes["bytes_per_packet"], f"{cfg.name}-moe")
    ideal = 2 * (n - 1) * math.ceil(chunk / sizes["bytes_per_packet"])
    out = replay_three(w, n, device)
    if out["ideal_cycles"] != ideal:
        raise AssertionError(f"moe: ideal {out['ideal_cycles']}, not {ideal}")
    return dict(model=cfg.name, d_model=cfg.d_model, experts=cfg.num_experts,
                experts_stored=TM.expert_store_count(cfg), experts_a_rank=e_loc,
                top_k=cfg.top_k, capacity=cap, dtype=cfg.dtype,
                tokens_a_rank=b * t, ops=len(ops), permute_bytes=chunk,
                bytes_per_packet=sizes["bytes_per_packet"],
                messages_a_pair=math.ceil(chunk / sizes["bytes_per_packet"]),
                record_host_s=record_s, layer_ms=layer_ms, lower_s=lower_s,
                **out)


def extract_dp(device, sizes):
    """llama3.2-3b's manual-DP train step as rank 0 of the DP group: the
    LACIN gradient all-reduce, 2(N-1) permutes a leaf, and the loss's one
    library all-reduce; the step's kernel launches (counts set to 0 just
    before it)."""
    cfg = get_config(sizes["arch"])
    if sizes["reduced"]:
        cfg = dataclasses.replace(cfg.reduced(), remat="full")
    n = sizes["devices"]
    data = host_batch(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=sizes["seq"],
                                 global_batch=sizes["batch"]), 0)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with XT.recording_group(n):
        run = XT.dp_step(n, cfg=cfg, data=data, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        reset_launches()
        MF.backward_calls = 0
        t0 = time.perf_counter()
        ops = XT.record(run)
        if device == "cuda":
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernel_launches(),
                        flash_attention_backward=MF.backward_calls)
        del run
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    attn_layers = cfg.block_pattern.count("attn")
    if device == "cuda" and (launches["flash_attention_prefill"]
                             != 2 * attn_layers
                             or launches["flash_attention_decode"]
                             or launches["flash_attention_fp32_tc"]):
        raise AssertionError(f"dp step: launches {launches}; want "
                             f"{2 * attn_layers} prefill, no other")
    reduces = [o for o in ops if o.kind != "collective-permute"]
    permutes = [o for o in ops if o.kind == "collective-permute"]
    if ([(o.kind, o.raw_bytes, o.group_size) for o in reduces]
            != [("all-reduce", 4, n)] or not permutes
            or len(permutes) % (2 * (n - 1))
            or any(len(o.pairs) != n or o.group_size != n
                   for o in permutes)):
        raise AssertionError(f"dp step: recorded {len(permutes)} permutes "
                             f"and {reduces}")
    w, lower_s = lower(ops, n, sizes["bytes_per_packet"], f"{cfg.name}-dp")
    out = replay_three(w, n, device)
    reduced_params = (sum(o.raw_bytes for o in permutes) * n
                      // (2 * (n - 1) * 4))
    return launches, dict(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        batch=sizes["batch"], batch_a_rank=sizes["batch"] // n,
        seq=sizes["seq"], remat=cfg.remat, dtype=cfg.dtype,
        param_dtype=cfg.param_dtype, ops=len(ops),
        permutes=len(permutes), leaves=len(permutes) // (2 * (n - 1)),
        parameters_reduced_with_padding=reduced_params,
        loss_all_reduce_bytes=reduces[0].raw_bytes,
        bytes_per_packet=sizes["bytes_per_packet"], launches=launches,
        step_ms_not_a_result=step_ms, peak_memory_gb=peak_gb,
        lower_s=lower_s, **out)


def extract_arrivals(device, trace, cfg):
    """The serving engine's arrival trace as serving traffic on CIN-xor-n,
    swept drained on the card and on the CPU, record for record."""
    n = cfg["n"]
    topo = S.cin_topology("xor", n)

    def tf(load, seed):
        return W.serving_traffic(trace, n, cycles=cfg["cycles"], load=load,
                                 packets_per_request=cfg[
                                     "packets_per_request"],
                                 slo=cfg["slo"], seed=seed)
    grids, wall = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        grids[dev] = S.sweep(topo, "minimal", tf, [1.0], seeds=(0,),
                             cycles=cfg["cycles"], warmup=0, drain=True,
                             device=dev)
        wall[dev] = time.perf_counter() - t0
    check_same_grid("arrival trace sweep against the CPU", grids[device],
                    grids["cpu"])
    st = grids[device][0][0]
    if st.request_count != len(trace.times):
        raise AssertionError(f"the trace's {len(trace.times)} requests gave "
                             f"{st.request_count}")
    return dict(times=list(trace.times), switches=n, cycles=cfg["cycles"],
                packets=int(st.packets_generated),
                **{f: getattr(st, f) for f in SERVING_FIELDS},
                wall_s=wall[device], cpu_wall_s=wall["cpu"])


def phase_extract(device="cuda", sizes=EXTRACT_FULL, trace=None, card=None):
    """The extraction path: the reference-size steps through ``python -m
    repro_torch.workload extract`` and ``replay --backend both`` as
    processes of their own (started first, waited for last), granite's
    MoE layer and llama3.2-3b's DP step at full width as rank 0 of the
    recording group, each lowered and replayed card = CPU = oracle, and
    ``trace`` (the serving engine's arrivals) swept card against CPU.
    ``card`` (nvidia-smi's name and power limit) stands in every line.
    Returns the DP step's kernel launches."""
    t0 = time.perf_counter()
    flags = [] if device == "cuda" else ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="extract-")
    paths = {step: os.path.join(tmp, f"{step}{n}.json")
             for step, n, *_ in sizes["cli"]}
    started = [cli_start("repro_torch.workload", "extract", "--step", step,
                         "--devices", str(n), "--bytes-per-packet", "256",
                         "-o", paths[step], *flags)
               for step, n, *_ in sizes["cli"]]
    moe = extract_moe(device, sizes["moe"])
    emit("extract", what="moe layer forward", device=device, card=card,
         recording_group="fake", **moe)
    cli = {}
    for (step, n, phases, packets, ideal), st in zip(sizes["cli"], started):
        done, seconds = cli_wait(st)
        want = (f"wrote {paths[step]}: workload 'cin-xor-{n}-ops', {n} "
                f"switches, {phases} phases, {packets} packets")
        if done.stdout.strip().splitlines()[-1] != want:
            raise AssertionError(f"extract {step}: {done.stdout!r}, not "
                                 f"{want!r}")
        cli[step] = {"devices": n, "phases": phases, "packets": packets,
                     "extract_wall_s": seconds}
    started = [cli_start("repro_torch.workload", "replay", paths[step],
                         "--backend", "both", *flags)
               for step, *_ in sizes["cli"]]
    launches, dp = extract_dp(device, sizes["dp"])
    emit("extract", what="manual-DP train step", device=device, card=card,
         recording_group="fake", **dp)
    for (step, n, phases, packets, ideal), st in zip(sizes["cli"], started):
        done, seconds = cli_wait(st)
        want = [f"numpy: completion={ideal} ideal={ideal} ratio=1.000",
                f"torch: completion={ideal} ideal={ideal} ratio=1.000",
                "cross-engine replay agrees exactly"]
        if done.stdout.strip().splitlines() != want:
            raise AssertionError(f"replay {step}: {done.stdout!r}")
        cli[step].update(ideal_cycles=ideal, completion_cycles=ideal,
                         replay_wall_s=seconds)
    emit("extract", what="reference-size steps (CLI)", device=device,
         card=card, recording_group="fake", bytes_per_packet=256, steps=cli)
    if trace is not None:
        emit("extract", what="serving arrival trace", device=device,
             card=card, **extract_arrivals(device, trace, sizes["serving"]))
    for path in paths.values():
        os.remove(path)
    os.rmdir(tmp)
    emit("extract_phase", device=device, card=card,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# The simulator's main path (repro_torch.sim): no hand-written kernel, the
# cycle step as a CUDA graph, held bit for bit to the same engine on the CPU
# (which tests/test_torch_xengine.py holds to the JAX reference).
# ---------------------------------------------------------------------------

#: The reference's two speed workloads of its cycle engine, at full size:
#: ``sim_speed`` (benchmarks/bench_simulation.py:136-150) and ``xl_scale``
#: (benchmarks/bench_compile.py:161-200); ``exact`` are the cross-checks.
#: ``xl_scale`` is held to the CPU on the same fabric and traffic over
#: ``check_cycles`` (the whole run: about 6 s on 8 CPU cores).
#: ``dragonfly`` is (a, p, h, g).
SIM_FULL = {
    "sim_speed": {"n": 16, "terminals": 12, "loads": (0.5, 0.7, 0.9),
                  "seeds": tuple(range(31, 39)), "cycles": 1600,
                  "warmup": 400},
    "xl_scale": {"dragonfly": (16, 8, 8, 65), "load": 0.05, "seed": 0,
                 "cycles": 256, "warmup": 64, "check_cycles": 256},
    "exact": {"a2a_n": 16, "a2a_terminals": 4, "dragonfly": (6, 3, 2, 12),
              "load": 0.5, "cycles": 60, "warmup": 15, "seeds": (1, 2),
              "adaptive": {"threshold": 0.5, "weight": 1.3}},
    "blocks": {"n": 16, "terminals": 4, "loads": (0.3, 0.7),
               "seeds": (0, 1), "cycles": 400, "warmup": 100,
               "replay_seeds": (0, 1, 2, 3), "message_size": 2},
}
#: The same phase at a size the CPU runs in seconds (tests/test_torch_sim_smoke.py).
SIM_TINY = {
    "sim_speed": {"n": 8, "terminals": 2, "loads": (0.5, 0.9),
                  "seeds": (31, 32), "cycles": 48, "warmup": 12},
    "xl_scale": {"dragonfly": (4, 2, 2, 9), "load": 0.05, "seed": 0,
                 "cycles": 40, "warmup": 10, "check_cycles": 8},
    "exact": {"a2a_n": 8, "a2a_terminals": 2, "dragonfly": (4, 2, 2, 5),
              "load": 0.5, "cycles": 20, "warmup": 5, "seeds": (1, 2),
              "adaptive": {"threshold": 0.5, "weight": 1.3}},
    "blocks": {"n": 8, "terminals": 2, "loads": (0.3, 0.7),
               "seeds": (0, 1), "cycles": 40, "warmup": 10,
               "replay_seeds": (0, 1, 2, 3), "message_size": 1},
}


def stats_diff(a, b):
    """The RunStats fields, all but ``timing``/``trace``, on which two runs
    differ (NaN equals NaN)."""
    bad = []
    for f in dataclasses.fields(a):
        if f.name in ("timing", "trace"):
            continue
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            bad.append(f.name)
    return bad


def check_same_grid(what, got, want):
    """Card against CPU, point for point, every RunStats field."""
    pairs = [(a, b) for ra, rb in zip(got, want) for a, b in zip(ra, rb)]
    if len(pairs) != sum(len(r) for r in want) or not pairs:
        raise AssertionError(f"{what}: grids of different shapes")
    for i, (a, b) in enumerate(pairs):
        bad = stats_diff(a, b)
        if bad:
            raise AssertionError(f"{what}: point {i} differs from the CPU "
                                 f"on {bad}")
    return len(pairs)


def wall_ms(fn, iters, device, warmup=1):
    """Mean time of ``fn`` over ``iters`` calls: by CUDA events on the
    card, by the host clock on the CPU."""
    if device == "cuda":
        return cuda_ms(fn, iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ops(fn, device, calls=1):
    """``fn`` called ``calls`` times under torch.profiler: the rows that ran
    on ``device`` (CUDA: kernels, memsets and copies; CPU: operators),
    their busy time and the wall time of the window.  On the card only the
    CUDA activity is recorded: the host's operator records (several a
    kernel) are never read, and at xlstm-350m's 325 k kernels a train step
    they kept the profiler busy for minutes.  The CUDA rows are summed by
    name from the profiler's raw records (a device record has no
    children, so its duration is its self time): ``key_averages()`` builds
    an event tree first, which on the CPU took 40 s for 500 k records
    where summing the raw records took 0.9 s."""
    from torch.profiler import ProfilerActivity, profile
    kind, acts = ((torch.autograd.DeviceType.CUDA, [ProfilerActivity.CUDA])
                  if device == "cuda" else
                  (torch.autograd.DeviceType.CPU, [ProfilerActivity.CPU]))
    if device == "cuda":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        if device == "cuda":
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if device == "cuda":
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == kind:
                row = by_name[e.name()]
                row[0] += e.duration_ns() / 1e3
                row[1] += 1
        rows = [(k, t, c) for k, (t, c) in by_name.items()]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count)
                for e in prof.key_averages() if e.device_type == kind]
    return rows, sum(t for _, t, _ in rows), wall_us


def step_profile(prep, device):
    """The cycle step of a prepared sweep (repro_torch.sim.xengine) on its
    own: device ms per cycle as the CUDA graph replays a block and as the
    same block runs eagerly, kernels per cycle (the nodes of the block's
    captured graph, see kernels_per_cycle), and the device's busy
    share and top operations per cycle over two graph replays.  Runs
    real cycles from cycle 0 (9 blocks), so the horizon should hold them."""
    spec, tb, pkt, k = prep.spec, prep.tb, prep.pkt, XE._BLOCK
    state = XE._init_state(spec, tb, pkt)
    pred = torch.ones((), dtype=torch.bool, device=device)

    def eager():
        XE._block(spec, tb, pkt, state, pred, k)
    out = {"block_cycles": k, "kernels_per_cycle": kernels_per_cycle(
        prep, device)}
    out["eager_ms_per_cycle"] = wall_ms(eager, 2, device) / k
    if device != "cuda":
        out["graph_ms_per_cycle"] = None          # no CUDA graph on the CPU
        return out
    t0 = time.perf_counter()
    graph = XE._capture(spec, tb, pkt, state, pred, k)
    torch.cuda.synchronize()
    out["capture_s"] = time.perf_counter() - t0
    out["graph_ms_per_cycle"] = wall_ms(graph.replay, 2, device) / k
    replays = 2
    rows, busy_us, wall_us = device_ops(graph.replay, device, replays)
    cycles = replays * k
    # The threefry draw of a block alone, as its own graph: its share of
    # the block's device time is what a fused RNG kernel could save.
    bits = torch.cuda.CUDAGraph()
    cycle = state.cycle.clone()
    XE._block_bits(spec, tb, pkt, cycle, k)
    with torch.cuda.graph(bits):
        XE._block_bits(spec, tb, pkt, cycle, k)
    rng_ms = wall_ms(bits.replay, 3, device) / k
    out["threefry_ms_per_cycle"] = rng_ms
    out["threefry_share_of_cycle"] = rng_ms / out["graph_ms_per_cycle"]
    out["graph_profile"] = {
        "cycles": cycles, "wall_us": wall_us, "device_busy_us": busy_us,
        "device_busy_share": busy_us / wall_us if wall_us else None,
        "device_busy_share_unprofiled":
            busy_us / cycles / (out["graph_ms_per_cycle"] * 1e3),
        "kernels_per_cycle": sum(c for _, _, c in rows) / cycles,
        "top_per_cycle": [
            {"op": key[:80], "us": t / cycles, "calls": c / cycles}
            for key, t, c in sorted(rows, key=lambda r: -r[1])[:10]]}
    del graph, bits
    return out


def run_sim_speed(cfg, device):
    """The headline speed workload: CIN xor n=16, uniform traffic, minimal
    routing, 3 loads x 8 seeds as one sweep (24 fabric copies)."""
    n = cfg["n"]
    topo = S.cin_topology("xor", n)

    def tf(load, seed):
        return S.uniform(n, offered=load, cycles=cfg["cycles"],
                         terminals=cfg["terminals"], seed=seed)
    kw = dict(seeds=cfg["seeds"], terminals=cfg["terminals"],
              cycles=cfg["cycles"], warmup=cfg["warmup"])

    def run(dev):
        t0 = time.perf_counter()
        grid = S.sweep(topo, "minimal", tf, cfg["loads"], device=dev, **kw)
        return grid, time.perf_counter() - t0
    cold, cold_s = run(device)
    warm, warm_s = run(device)
    ref, cpu_s = run("cpu")
    points = check_same_grid("sim_speed", warm, ref)
    check_same_grid("sim_speed (cold)", cold, ref)
    lane_cycles = len(cfg["loads"]) * len(cfg["seeds"]) * cfg["cycles"]
    prep = XE._prepare(topo, "minimal", tf, cfg["loads"], device=device, **kw)
    out = {
        "copies": points, "cycles": cfg["cycles"],
        "lane_cycles_per_s_warm": lane_cycles / warm_s,
        "lane_cycles_per_s_cold": lane_cycles / cold_s,
        "wall_s_warm": warm_s, "wall_s_cold": cold_s, "wall_s_cpu": cpu_s,
        "timing_warm": warm[0][0].timing, "timing_cold": cold[0][0].timing,
        "accepted_by_load": [float(np.mean([r.accepted for r in row]))
                             for row in warm],
        "step": step_profile(prep, device)}
    emit("sim_speed", device=device, **out)
    return out


def run_xl_scale(cfg, device):
    """The largest cycle-engine fabric: Dragonfly a=16 p=8 h=8 g=65 (1040
    switches, 8320 terminals), uniform load 0.05, minimal routing; the card
    against the CPU on the same fabric and traffic over ``check_cycles``."""
    a, p, h, g = cfg["dragonfly"]
    dcfg = DragonflyConfig(group_size=a, terminals_per_switch=p,
                           global_ports_per_switch=h, num_groups=g)
    t0 = time.perf_counter()
    topo = S.dragonfly_topology(dcfg)
    topo.minimal_port_table()
    table_s = time.perf_counter() - t0
    n = topo.num_switches

    def tf(load, seed):
        return S.uniform(n, offered=load, cycles=cfg["cycles"], terminals=p,
                         seed=seed)

    def run(dev, cycles):
        t0 = time.perf_counter()
        grid = S.sweep(topo, "minimal", tf, [cfg["load"]],
                       seeds=(cfg["seed"],), terminals=p, cycles=cycles,
                       warmup=cfg["warmup"] if cycles == cfg["cycles"]
                       else cycles // 4, device=dev)
        return grid, time.perf_counter() - t0
    cold, cold_s = run(device, cfg["cycles"])
    if device == "cuda":
        held = torch.cuda.memory_allocated()   # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
    warm, warm_s = run(device, cfg["cycles"])
    peak = (torch.cuda.max_memory_allocated() - held if device == "cuda"
            else None)
    if warm[0][0].packets_delivered <= 0:
        raise AssertionError("xl_scale delivered no packets")
    check_same_grid("xl_scale", warm, cold)
    ref, cpu_s = run("cpu", cfg["check_cycles"])
    short = (warm if cfg["check_cycles"] == cfg["cycles"]
             else run(device, cfg["check_cycles"])[0])
    check_same_grid(f"xl_scale at {cfg['check_cycles']} cycles", short, ref)
    prep = XE._prepare(topo, "minimal", tf, [cfg["load"]],
                       seeds=(cfg["seed"],), terminals=p,
                       cycles=cfg["cycles"], warmup=cfg["warmup"],
                       device=device)
    out = {
        "switches": n, "terminals": n * p, "cycles": cfg["cycles"],
        "cycles_per_s_warm": cfg["cycles"] / warm_s,
        "cycles_per_s_cold": cfg["cycles"] / cold_s,
        "wall_s_warm": warm_s, "wall_s_cold": cold_s,
        "packets_delivered": int(warm[0][0].packets_delivered),
        "minimal_port_table_host_s": table_s,
        "timing_warm": warm[0][0].timing, "timing_cold": cold[0][0].timing,
        "max_memory_allocated_by_run": peak,
        "cpu_check_cycles": cfg["check_cycles"], "cpu_check_wall_s": cpu_s,
        "step": step_profile(prep, device)}
    emit("xl_scale", device=device, **out)
    return out


def run_sim_exact(cfg, device):
    """Drained runs on the device: the one-shot all-to-all on CIN xor
    against the closed form (core.simulate.cin_link_loads), and uniform
    sweeps with Valiant and adaptive routing on a small Dragonfly against
    the CPU."""
    n = cfg["a2a_n"]
    topo = S.cin_topology("xor", n)
    st = S.simulate_torch(topo, "minimal", S.one_shot_all_to_all(n),
                          terminals=cfg["a2a_terminals"], device=device)
    counter = S.LinkLoadCounter(S.LinkTable.for_topology(topo, 1))
    counter.total = st.link_loads
    if st.packets_delivered != n * (n - 1) or \
            counter.by_switch_pair() != cin_link_loads("xor", n):
        raise AssertionError("one-shot all-to-all: link loads differ from "
                             "the closed form")
    a, p, h, g = cfg["dragonfly"]
    df = S.dragonfly_topology(DragonflyConfig(
        group_size=a, terminals_per_switch=p, global_ports_per_switch=h,
        num_groups=g))
    m = df.num_switches

    def tf(load, seed):
        return S.uniform(m, offered=load, cycles=cfg["cycles"], terminals=p,
                         seed=seed)
    checked = {}
    for policy in (S.ValiantPolicy(), S.AdaptivePolicy(**cfg["adaptive"])):
        grids = [S.sweep(df, policy, tf, [cfg["load"]], seeds=cfg["seeds"],
                         terminals=p, cycles=cfg["cycles"],
                         warmup=cfg["warmup"], drain=True, device=dev)
                 for dev in (device, "cpu")]
        check_same_grid(f"drained {policy.name}", *grids)
        checked[policy.name] = [r.packets_delivered for r in grids[0][0]]
    out = {"a2a_packets": st.packets_delivered, "a2a_links": len(
        counter.by_switch_pair()), "dragonfly_switches": m,
        "drained_delivered": checked,
        "adaptive": cfg["adaptive"]}
    emit("sim_exact", device=device, **out)
    return out


def run_sim_blocks(cfg, device):
    """The copies split over devices (``sweep(devices=)``): ``"auto"`` (every
    visible card of ``device``'s type) against one program, and the split
    run as two blocks on the same device (``xengine._block_sweep``, the
    code ``devices=2`` runs on two cards) against one program, each to the
    bit, on a uniform sweep of 4 points and on a collective replay of 4
    copies (a drained run); wall seconds of one program and of the two
    blocks, which on one device run one after the other."""
    n = cfg["n"]
    fab = make_fabric("xor", n)
    topo = fab.sim_topology()

    def uniform(load, seed):
        return S.uniform(n, offered=load, cycles=cfg["cycles"],
                         terminals=cfg["terminals"], seed=seed)
    work = collective_workload(fab, "all_to_all",
                               message_size=cfg["message_size"])
    grids = {"uniform": (uniform, cfg["loads"], dict(
                 seeds=cfg["seeds"], terminals=cfg["terminals"],
                 cycles=cfg["cycles"], warmup=cfg["warmup"])),
             "replay": (lambda load, seed: work.traffic(), [0.0], dict(
                 seeds=cfg["replay_seeds"]))}
    out = {"devices_auto": XE._resolve_devices("auto", torch.device(device))}
    for name, (tf, loads, kw) in grids.items():
        S.sweep(topo, "minimal", tf, loads, device=device, **kw)  # warm-up
        t0 = time.perf_counter()
        one = S.sweep(topo, "minimal", tf, loads, device=device, **kw)
        one_s = time.perf_counter() - t0
        auto = S.sweep(topo, "minimal", tf, loads, devices="auto",
                       device=device, **kw)
        check_same_grid(f"blocks {name}: devices='auto' against one program",
                        auto, one)
        XE._block_sweep([device] * 2, topo, "minimal", tf, loads, **kw)
        t0 = time.perf_counter()
        two = XE._block_sweep([device] * 2, topo, "minimal", tf, loads, **kw)
        two_s = time.perf_counter() - t0
        points = check_same_grid(
            f"blocks {name}: two blocks on one device against one program",
            two, one)
        out[name] = {"points": points, "wall_s_one_program": one_s,
                     "wall_s_two_blocks_one_device": two_s,
                     "delivered": [r.packets_delivered for r in one[0]]}
    emit("sim_blocks", device=device, **out)
    return out


def phase_sim(device="cuda", sizes=SIM_FULL):
    """The simulator's main path: ``sim_speed``, ``xl_scale``, the
    exactness checks and the copies split over devices, each raising on a
    difference.  The port's kernels' launch counts are set to 0 before
    and read after: this path runs none of them."""
    t0 = time.perf_counter()
    reset_launches()
    out = {"sim_speed": run_sim_speed(sizes["sim_speed"], device),
           "xl_scale": run_xl_scale(sizes["xl_scale"], device),
           "exact": run_sim_exact(sizes["exact"], device),
           "blocks": run_sim_blocks(sizes["blocks"], device)}
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the simulator launched a model kernel: "
                             f"{launched}")
    emit("sim", device=device, seconds=time.perf_counter() - t0,
         launches=launched)
    return out


#: The studies phase: the bundled specs at their own sizes.  ``replay`` is
#: run through the CLI; ``replay_expect`` is (completion, ideal) of the
#: minimal arms (BENCH ``collective_replay``); ``oracle_knees`` is held to
#: the numpy oracle's knees, and ``cpu_check`` is one experiment held to
#: the CPU record for record.
STUDIES_FULL = {
    "replay": "collective_replay",
    "replay_expect": {"cin-xor-16/replay-all_to_all/minimal": (30, 30),
                      "hyperx-16x16-xor/replay-all_to_all/minimal": (60, 60),
                      "dragonfly-a6h2g12/replay-all_to_all/minimal":
                          (142, 32)},
    "saturation": ("cin16_saturation", "hyperx256_uniform",
                   "dragonfly72_uniform"),
    "oracle_knees": "cin16_saturation",
    "cpu_check": ("cin16_saturation", "cin-xor-16/uniform/minimal"),
}
#: The same phase at a size the CPU runs in seconds
#: (tests/test_torch_sim_smoke.py): CIN-8 replays, the smoke spec.
STUDIES_TINY = {
    "replay": [{"fabric": {"kind": "cin",
                           "params": {"instance": "xor", "n": 8}},
                "traffic": {"pattern": "workload",
                            "params": {"collective": "all_to_all",
                                       "message_size": 2}},
                "routing": {"policy": policy},
                "sweep": {"loads": [0.0], "seeds": [0]}}
               for policy in ("minimal", "adaptive")],
    "replay_expect": {"cin-xor-8/replay-all_to_all/minimal": (14, 14)},
    "saturation": ("studies_smoke",),
    "oracle_knees": "studies_smoke",
    "cpu_check": ("studies_smoke", "cin-xor-8/uniform/minimal"),
}


def record_fields(result):
    """A stored record without what names the run (provenance: host,
    versions, timings)."""
    return {k: v for k, v in result.record().items() if k != "provenance"}


def check_same_records(what, got, want):
    """Two lists of study records, key for key and field for field."""
    if [r.key for r in got] != [r.key for r in want]:
        raise AssertionError(f"{what}: different grid points")
    for a, b in zip(got, want):
        if record_fields(a) != record_fields(b):
            bad = sorted(k for k in record_fields(a)
                         if record_fields(a)[k] != record_fields(b).get(k))
            raise AssertionError(f"{what}: {a.key} differs on {bad}")
    return len(got)


def timed_study(source, device, backend="torch"):
    t0 = time.perf_counter()
    out = ST.Study(source, backend=backend, device=device).run()
    return out, time.perf_counter() - t0


def study_line(name, device, cold, cold_s, warm, warm_s):
    """The numbers of one spec: its points, cold and warm wall seconds of
    ``Study.run()``, simulated lane-cycles (each point's cycles) a second,
    and the timings of the warm run summed over its experiments (one
    sweep, one shared timing record, each)."""
    check_same_records(f"{name}: warm against cold", warm.results,
                       cold.results)
    timing = {}
    for r in warm.results:
        timing.setdefault(r.experiment, r.stats.timing)
    lane_cycles = sum(r.cycles for r in warm.results)
    return {
        "spec": name, "device": device, "experiments": len(timing),
        "points": len(warm.results), "wall_s_cold": cold_s,
        "wall_s_warm": warm_s, "lane_cycles": lane_cycles,
        "lane_cycles_per_s_warm": lane_cycles / warm_s,
        **{f"{k}_sum": sum(t.get(k, 0.0) for t in timing.values())
           for k in ("compile_s", "execute_s", "host_s")}}


def cli_start(module, *argv):
    """``python -m <module> *argv`` started as its own process, with this
    checkout's ``src`` on its path; :func:`cli_wait` finishes it."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter(), f"{module} {' '.join(argv[:2])}"


def cli_wait(started):
    """The finished process of :func:`cli_start` (a CompletedProcess) and
    its wall seconds from its start; raises when it exits non-zero."""
    proc, t0, what = started
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI ({what}) exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    return subprocess.CompletedProcess(proc.args, 0, out, err), seconds


def studies_cli(*argv):
    """``python -m repro_torch.studies *argv`` as its own process: the
    finished process and its wall seconds; raises when it exits
    non-zero."""
    return cli_wait(cli_start("repro_torch.studies", *argv))


def run_replay_study(cfg, device, tmp):
    """``python -m repro_torch.studies run <replay spec>`` on ``device`` as
    its own process, the store read back: the minimal arms' completions
    against ``replay_expect``, every record against the same Study on the
    CPU; then the spec's cold and warm ``Study.run()`` in this process."""
    src = cfg["replay"]
    if not isinstance(src, str):
        src = os.path.join(tmp, "replay_spec.json")
        ST.dump_specs(ST.load_specs(cfg["replay"]), src)
    store = os.path.join(tmp, "replay.results.jsonl")
    proc, cli_s = studies_cli("run", src, "--backend", "torch", "--device",
                              device, "--store", store)
    path = ST.resolve_spec_source(src)
    specs = ST.load_specs(path)
    stored = ST.JsonlStore(store).load()
    keys = [e.key(*p) for e in specs for p in e.points()]
    if sorted(stored) != sorted(keys):
        raise AssertionError(f"the CLI stored {sorted(stored)}, not {keys}")
    cli_records = [stored[k] for k in keys]
    if {r.backend for r in cli_records} != {"torch"} or any(
            (r.provenance or {}).get("timings", {}).get("backend") != "torch"
            for r in cli_records):
        raise AssertionError("the CLI's records did not come from the torch "
                             "engine")
    replays = {r.experiment: [r.completion_cycles, r.ideal_cycles]
               for r in cli_records}
    for name, want in cfg["replay_expect"].items():
        if tuple(replays.get(name, ())) != tuple(want):
            raise AssertionError(f"{name}: completion/ideal "
                                 f"{replays.get(name)}, expected {want}")
    cpu, cpu_s = timed_study(path, "cpu")
    check_same_records("replays: CLI on the device against the CPU",
                       cli_records, cpu.results)
    cold, cold_s = timed_study(path, device)
    warm, warm_s = timed_study(path, device)
    check_same_records("replays: Study on the device against the CPU",
                       warm.results, cpu.results)
    out = study_line(os.path.splitext(os.path.basename(path))[0], device,
                     cold, cold_s, warm, warm_s)
    out.update(cli_wall_s=cli_s, cpu_wall_s=cpu_s,
               completion_vs_ideal=replays,
               cli_says=[ln for ln in proc.stdout.splitlines()
                         if ln.startswith("ran ")])
    emit("study", **out)
    return out


def run_saturation_study(name, cfg, device):
    """A bundled saturation spec through ``Study.run()`` on ``device``, cold
    and warm: its knees; against the numpy oracle's knees (``oracle_knees``)
    and one experiment against the CPU (``cpu_check``)."""
    src = ST.bundled_spec_path(name)
    cold, cold_s = timed_study(src, device)
    warm, warm_s = timed_study(src, device)
    out = study_line(name, device, cold, cold_s, warm, warm_s)
    out["knees"] = warm.saturation_points()
    if name == cfg["oracle_knees"]:
        oracle, oracle_s = timed_study(src, None, backend="numpy")
        out.update(oracle_knees=oracle.saturation_points(),
                   oracle_wall_s=oracle_s)
        if out["knees"] != out["oracle_knees"]:
            raise AssertionError(f"{name}: knees {out['knees']} differ from "
                                 f"the numpy oracle's {out['oracle_knees']}")
    if name == cfg["cpu_check"][0]:
        exp = [e for e in ST.load_specs(src) if e.name == cfg["cpu_check"][1]]
        cpu, cpu_s = timed_study(exp, "cpu")
        n = check_same_records(
            f"{exp[0].name} against the CPU",
            [r for r in warm.results if r.experiment == exp[0].name],
            cpu.results)
        out.update(cpu_check=exp[0].name, cpu_check_points=n,
                   cpu_check_wall_s=cpu_s)
    emit("study", **out)
    return out


def phase_studies(device="cuda", sizes=STUDIES_FULL):
    """The studies path on ``device``: the replay spec through the CLI, then
    the saturation specs through ``Study.run()``, each raising on a failed
    check.  The port's kernels' launch counts are set to 0 before and read
    after: this path runs none of them."""
    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"replay": run_replay_study(sizes, device, tmp)}
    for name in sizes["saturation"]:
        out[name] = run_saturation_study(name, sizes, device)
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the studies launched a model kernel: "
                             f"{launched}")
    emit("studies", device=device, seconds=time.perf_counter() - t0,
         launches=launched)
    return out


# ---------------------------------------------------------------------------
# Degraded fabrics, the flow tier and cycle traces: repro_torch.faults,
# repro_torch.flow and the trace ring buffers of repro_torch.sim.xengine,
# through the studies path on the card.  No hand-written kernel runs here.
# ---------------------------------------------------------------------------

#: The faults phase: ``failure_sweep`` at its own size.  Its f0 experiments
#: are held to the pristine grids of the ``pristine`` specs (same name but
#: the ``/f0``; records where the grid is the same, knees everywhere), the
#: experiments named ``cpu_check``* to the CPU record for record, and the
#: degraded knees of those named ``oracle_knees``* to the numpy oracle's
#: on the same degraded fabric.
FAULTS_FULL = {
    "spec": "failure_sweep",
    "pristine": ("cin16_saturation", "hyperx256_uniform",
                 "dragonfly72_uniform"),
    "cpu_check": "cin-xor-16/",
    "oracle_knees": "cin-xor-16/",
}


def _tiny_cin8(policy, name, failures=None):
    exp = {"fabric": {"kind": "cin", "params": {"instance": "xor", "n": 8}},
           "traffic": {"pattern": "uniform", "params": {"seed": 21}},
           "routing": {"policy": policy},
           "sweep": {"loads": [0.2, 0.5, 0.8], "seeds": [23], "cycles": 120,
                     "warmup": 30},
           "terminals": 4, "name": name}
    if failures is not None:
        exp["failures"] = failures
    return exp


#: The same phase at a size the CPU runs in seconds
#: (tests/test_torch_sim_smoke.py): CIN-8 at 0 and 10% link failure.
FAULTS_TINY = {
    "spec": [_tiny_cin8(policy, f"cin-xor-8/uniform/{policy}/{tag}", f)
             for policy in ("minimal", "valiant")
             for tag, f in (("f0", None),
                            ("f0.1", {"link_fraction": 0.1, "seed": 3}))],
    "pristine": ([_tiny_cin8(policy, f"cin-xor-8/uniform/{policy}")
                  for policy in ("minimal", "valiant")],),
    "cpu_check": "cin-xor-8/",
    "oracle_knees": "cin-xor-8/",
}


def load_spec_source(src):
    """A bundled spec's name, or a list of experiment dicts."""
    return ST.load_specs(ST.bundled_spec_path(src) if isinstance(src, str)
                         else src)


def point_fields(result):
    """A stored record without what names its experiment (the name is
    part of the key and of the spec digest) or the run."""
    return {k: v for k, v in result.record().items()
            if k not in ("key", "experiment", "spec_digest", "provenance")}


def knee_order(value):
    return math.inf if value is None else value


def phase_faults(device="cuda", sizes=FAULTS_FULL):
    """``failure_sweep`` through ``Study.run()`` on ``device``, cold and
    warm: the f0 experiments against the pristine grids, the CIN-16
    experiments against the CPU, the degraded CIN-16 knees against the
    numpy oracle on the same degraded fabric, and every knee curve
    non-increasing in the failure rate; the degraded tables' host time.
    The port's kernels' launch counts are set to 0 before and read after:
    this path runs none of them."""
    t0 = time.perf_counter()
    reset_launches()
    specs = load_spec_source(sizes["spec"])
    tables = {}
    for exp in specs:
        key = f"{exp.fabric.label}+{exp.failures.label}" if exp.failures \
            else None
        if key is None or key in tables:
            continue
        topo = exp.fabric.resolve_topology()
        t1 = time.perf_counter()
        topo.degrade(exp.failures)
        tables[key] = time.perf_counter() - t1
    cold, cold_s = timed_study(specs, device)
    warm, warm_s = timed_study(specs, device)
    name = sizes["spec"] if isinstance(sizes["spec"], str) else "faults"
    out = study_line(name, device, cold, cold_s, warm, warm_s)
    knees = warm.saturation_points()

    # An f0 experiment that is its pristine grid but for the name must give
    # its records; one whose spec fixes another traffic seed or fewer
    # seeds (HyperX-256, Dragonfly-72 in failure_sweep) its knee.
    by_name = {e.name: e for src in sizes["pristine"]
               for e in load_spec_source(src)}
    f0 = {e.name: by_name[e.name.rsplit("/", 1)[0]]
          for e in specs if e.failures is None}
    pristine, pristine_s = timed_study(list(f0.values()), device)
    same_grid = [e for e in specs if e.name in f0 and dataclasses.replace(
        f0[e.name], name=e.name) == e]
    got = [r for e in same_grid for r in warm.results
           if r.experiment == e.name]
    want = [r for e in same_grid for r in pristine.results
            if r.experiment == f0[e.name].name]
    if not got or [point_fields(r) for r in got] != \
            [point_fields(r) for r in want]:
        raise AssertionError("faults: f0 records differ from the pristine "
                             "grids'")
    pristine_knees = pristine.saturation_points()
    f0_knees = {name: (knees[name], pristine_knees[p.name])
                for name, p in f0.items()}
    if any(a != b for a, b in f0_knees.values()):
        raise AssertionError(f"faults: f0 knees differ from the pristine "
                             f"grids' (f0, pristine): {f0_knees}")

    cpu_exps = [e for e in specs if e.name.startswith(sizes["cpu_check"])]
    cpu, cpu_s = timed_study(cpu_exps, "cpu")
    n_cpu = check_same_records(
        "faults: against the CPU",
        [r for r in warm.results if r.experiment.startswith(
            sizes["cpu_check"])], cpu.results)

    degraded = [e for e in specs if e.failures is not None
                and e.name.startswith(sizes["oracle_knees"])]
    oracle, oracle_s = timed_study(degraded, None, backend="numpy")
    oracle_knees = oracle.saturation_points()
    if {e.name: knees[e.name] for e in degraded} != oracle_knees:
        raise AssertionError(f"faults: degraded knees "
                             f"{ {e.name: knees[e.name] for e in degraded} } "
                             f"differ from the numpy oracle's "
                             f"{oracle_knees}")

    curves = {}
    for exp in specs:
        rate = exp.failures.link_fraction if exp.failures else 0.0
        curves.setdefault(exp.name.rsplit("/", 1)[0], []).append(
            (rate, knees[exp.name]))
    for family, curve in curves.items():
        curve.sort()
        ks = [knee_order(k) for _, k in curve]
        if any(b > a for a, b in zip(ks, ks[1:])):
            raise AssertionError(f"faults: {family} knees rise with the "
                                 f"failure rate: {curve}")
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the fault studies launched a model kernel: "
                             f"{launched}")
    out.update(knees=knees, knee_curves=curves, oracle_knees=oracle_knees,
               oracle_wall_s=oracle_s, f0_points=len(got),
               f0_knees=f0_knees, pristine_wall_s=pristine_s, cpu_check_points=n_cpu,
               cpu_check_wall_s=cpu_s, degrade_host_s=tables,
               degrade_host_s_sum=sum(tables.values()),
               seconds=time.perf_counter() - t0, launches=launched)
    emit("faults", **out)
    return out


#: The flow phase: ``spec`` through the CLI with ``backend`` (``auto``
#: escalates ``flow_scale_smoke``'s 4096 switches to the flow tier), held
#: to the CLI on the CPU and to the numpy solver; then ``cycle_check``'s
#: flow knees against its cycle knees on the card
#: (tests/test_flow.py:379's cross-fidelity check).
FLOW_FULL = {"spec": "flow_scale_smoke", "backend": "auto",
             "cycle_check": "cin16_saturation"}
#: The same phase at a size the CPU runs in seconds: a CIN-16 grid on the
#: flow backend, the smoke spec's knees.
FLOW_TINY = {
    "spec": [{"fabric": {"kind": "cin", "params": {"instance": "xor",
                                                   "n": 16}},
              "traffic": {"pattern": "uniform"},
              "routing": {"policy": policy},
              "sweep": {"loads": [0.3, 0.9], "seeds": [0], "cycles": 200,
                        "warmup": 50},
              "terminals": 12} for policy in ("minimal", "valiant")],
    "backend": "flow", "cycle_check": "studies_smoke"}


def close_records(what, got, want, rtol):
    """Two records, numbers within ``rtol`` (exact elsewhere)."""
    for k, b in want.items():
        a = got.get(k)
        if isinstance(b, float) or isinstance(a, float):
            if not math.isclose(a, b, rel_tol=rtol, abs_tol=0.0):
                raise AssertionError(f"{what}: {k} {a} against {b}")
        elif isinstance(b, list) and b and isinstance(b[0], float):
            if not np.allclose(a, b, rtol=rtol, atol=0.0):
                raise AssertionError(f"{what}: {k} differs")
        elif a != b:
            raise AssertionError(f"{what}: {k} {a} against {b}")


def flow_breakdown(exp, topo, load, device):
    """One flow grid point step by step, on the host clock: the demand
    matrix, the route tracing and problem assembly, capacities, the upload
    of the CSR incidence, the solver (its iterations, CUDA-event ms and the
    profiler's device busy time) and the RunStats.  The topology is built
    before (``topology_s`` of the phase)."""
    from repro_torch.flow import adapters as FA
    from repro_torch.flow import model as FM
    from repro_torch.flow import solver as FS
    params = FM.FlowParams(detour_weight=float(
        (exp.routing.params or {}).get("weight", 2.0)))
    terminals = exp.terminals if exp.terminals is not None else 1
    routing = exp.routing.label
    clock = []

    def tick():
        if device == "cuda":
            torch.cuda.synchronize()
        clock.append(time.perf_counter())
    tick()
    src, dst, rate = FA.pattern_demands(topo, exp.traffic.pattern, load,
                                        terminals, params,
                                        dict(exp.traffic.params))
    tick()
    problem = {"minimal": lambda: FA._minimal_problem(topo, src, dst, rate),
               "valiant": lambda: FA._valiant_problem(topo, src, dst, rate,
                                                      params),
               "adaptive": lambda: FA._adaptive_problem(topo, src, dst, rate,
                                                        params)}[routing]()
    tick()
    capacity = FM.link_capacities(topo, problem, params)
    tick()
    args = FS.upload_problem(problem.demand, problem.link_ids,
                             problem.flow_ptr, capacity, device)
    tick()
    rates, iters = FS._torch_core(*args, params.max_iters)
    tick()
    sol = FA.FlowSolution(topo=topo, routing=routing, problem=problem,
                          capacity=capacity, rates=rates.cpu().numpy(),
                          params=params)
    cycles = exp.sweep.cycles or 1
    FA._stats_from_solution(sol, policy=routing, traffic=exp.traffic.label,
                            offered=load, cycles=cycles,
                            warmup=exp.sweep.warmup or 0,
                            terminals=terminals)
    tick()
    solver_ms = wall_ms(lambda: FS._torch_core(*args, params.max_iters), 3,
                        device)
    rows, busy_us, wall_us = device_ops(
        lambda: FS._torch_core(*args, params.max_iters), device)
    steps = np.diff(clock)
    return {"load": load, "flows": int(problem.num_flows),
            "nnz": int(problem.link_ids.size), "links": int(capacity.size),
            "iterations": iters, "demands_s": steps[0], "routes_s": steps[1],
            "capacities_s": steps[2], "upload_s": steps[3],
            "solve_s_first": steps[4], "runstats_s": steps[5],
            "solver_ms": solver_ms, "solver_device_busy_ms": busy_us / 1e3,
            "solver_device_busy_share": busy_us / wall_us if wall_us
            else None, "solver_ops": sum(c for _, _, c in rows)}


def phase_flow(device="cuda", sizes=FLOW_FULL):
    """The flow tier on ``device``: ``python -m repro_torch.studies run
    <spec>`` as a subprocess (``auto`` escalating to the flow model),
    its store equal to the same command's with ``--device cpu`` and within
    rtol 1e-12 of the numpy solver; where a grid point's time goes; and
    ``cycle_check``'s flow knees equal to its cycle knees on the card."""
    from repro_torch.flow import FlowParams, study_point_stats
    t0 = time.perf_counter()
    reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = sizes["spec"]
        if not isinstance(src, str):
            src = os.path.join(tmp, "flow_spec.json")
            ST.dump_specs(ST.load_specs(sizes["spec"]), src)
        stores = {}
        for run, dev in (("device", device), ("cpu", "cpu")):
            stores[run] = os.path.join(tmp, f"flow.{run}.jsonl")
            proc, secs = studies_cli("run", src, "--backend",
                                     sizes["backend"], "--device", dev,
                                     "--store", stores[run])
            out[f"cli_wall_s_{run}"] = secs
            out[f"cli_says_{run}"] = [ln for ln in proc.stdout.splitlines()
                                      if ln.startswith("ran ")]
        specs = ST.load_specs(ST.resolve_spec_source(src))
        got, cpu = (ST.JsonlStore(stores[r]).load() for r in ("device", "cpu"))
    keys = [e.key(*p) for e in specs for p in e.points()]
    if sorted(got) != sorted(keys) or sorted(cpu) != sorted(keys):
        raise AssertionError(f"flow: the CLI stored {sorted(got)}, not "
                             f"{keys}")
    got = [got[k] for k in keys]
    check_same_records("flow: the CLI on the device against the CPU", got,
                       [cpu[k] for k in keys])
    if {(r.backend, r.fidelity) for r in got} != {("flow", "flow")} or not \
            any("backend=flow" in ln for ln in out["cli_says_device"]):
        raise AssertionError("flow: the CLI's records did not come from the "
                             "flow tier")
    study = ST.Study(specs, device=device)
    breakdown, topology_s = [], {}
    for exp in specs:
        t1 = time.perf_counter()
        topo, tf = study._resolve(exp)
        topology_s[exp.name] = time.perf_counter() - t1
        w = float((exp.routing.params or {}).get("weight", 2.0))
        for load, seed in exp.points():
            stats = study_point_stats(exp, topo, tf, load, seed,
                                      params=FlowParams(detour_weight=w,
                                                        solver="numpy"),
                                      device=device)
            want = ST.Result.from_stats(
                stats, key=exp.key(load, seed), experiment=exp.name,
                load=load, seed=seed, backend="flow",
                spec_digest=exp.digest(), fidelity="flow")
            rec = got[keys.index(exp.key(load, seed))]
            close_records(f"flow: {rec.key} against the numpy solver",
                          record_fields(rec), record_fields(want), 1e-12)
        breakdown += [flow_breakdown(exp, topo, load, device)
                      for load in exp.sweep.loads]
    out.update(points=len(got), accepted={r.key: r.accepted for r in got},
               topology_s=topology_s, breakdown=breakdown)

    check = sizes["cycle_check"]
    flow, flow_s = timed_study(ST.bundled_spec_path(check), device,
                               backend="flow")
    cycle, cycle_s = timed_study(ST.bundled_spec_path(check), device)
    if flow.saturation_points(fidelity="flow") != \
            cycle.saturation_points():
        raise AssertionError(
            f"flow: {check} flow knees "
            f"{flow.saturation_points(fidelity='flow')} differ from the "
            f"cycle knees {cycle.saturation_points()}")
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the flow tier launched a model kernel: "
                             f"{launched}")
    out.update(cycle_check=check,
               flow_knees=flow.saturation_points(fidelity="flow"),
               cycle_knees=cycle.saturation_points(), flow_wall_s=flow_s,
               cycle_wall_s=cycle_s, seconds=time.perf_counter() - t0,
               launches=launched)
    emit("flow", device=device, **out)
    return out


#: The trace phase: every experiment of ``spec`` as a traced sweep on the
#: card against the same sweep on the CPU, and ``export`` through ``trace
#: export`` (both engines).
TRACE_FULL = {"spec": "collective_replay",
              "export": "cin-xor-16/replay-all_to_all/minimal"}
TRACE_TINY = {"spec": STUDIES_TINY["replay"],
              "export": "cin-xor-8/replay-all_to_all/minimal"}


#: CUgraphNodeType values (cuda.h) of the nodes that run on the device.
_DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(graph):
    """The device nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by type, read through the driver API: exactly
    what every replay of the graph launches."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)),
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
          "cuGraphGetNodes")
    kinds = collections.Counter()
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
              "cuGraphNodeGetType")
        kinds[_DEVICE_NODES.get(kind.value, "other")] += 1
    return dict(kinds)


def kernels_per_cycle(prep, device):
    """Device operations of one block of a prepared sweep, per cycle.  On
    CUDA: the kernel, memset and copy nodes of the block's captured graph,
    which every replay runs (a profiler window may drop records, so the
    graph itself is read).  On the CPU: the operators of one eager block
    under the profiler."""
    spec, tb, pkt, k = prep.spec, prep.tb, prep.pkt, XE._BLOCK
    state = XE._init_state(spec, tb, pkt)
    pred = torch.ones((), dtype=torch.bool, device=device)
    if device != "cuda":
        rows, _, _ = device_ops(
            lambda: XE._block(spec, tb, pkt, state, pred, k), device)
        return sum(c for _, _, c in rows) / k
    graph = XE._capture(spec, tb, pkt, state, pred, k, keep_graph=True)
    kinds = graph_nodes(graph)
    del graph
    return sum(v for kind, v in kinds.items() if kind != "other") / k


def phase_trace(device="cuda", sizes=TRACE_FULL):
    """Traced sweeps of the replay spec on ``device``: every trace array
    and RunStats field equal to the CPU's, the RunStats equal to the
    untraced run's; kernels per cycle untraced and traced; then ``python
    -m repro_torch.studies trace export --backend both`` on ``device`` and
    its JSON validated."""
    from repro_torch.obs import validate_trace_events
    t0 = time.perf_counter()
    reset_launches()
    specs = load_spec_source(sizes["spec"])
    study = ST.Study(specs, device=device)
    runs = []
    for exp in specs:
        topo, tf = study._resolve(exp)
        kw = dict(seeds=exp.sweep.seeds, terminals=exp.terminals,
                  cycles=exp.sweep.cycles, warmup=exp.sweep.warmup,
                  **dict(exp.engine))

        def sweep(dev, trace):
            t1 = time.perf_counter()
            grid = S.sweep(topo, exp.routing.make(), tf, exp.sweep.loads,
                           trace=trace, device=dev, **kw)
            return grid, time.perf_counter() - t1
        traced, traced_s = sweep(device, True)
        plain, plain_s = sweep(device, None)
        cpu, _ = sweep("cpu", True)
        check_same_grid(f"trace: {exp.name} traced against untraced",
                        traced, plain)
        check_same_grid(f"trace: {exp.name} against the CPU", traced, cpu)
        for a, b in zip(traced[0], cpu[0]):
            if not a.trace.equals(b.trace) or a.trace.meta != b.trace.meta:
                raise AssertionError(f"trace: {exp.name}: "
                                     f"{a.trace.diff_summary(b.trace)}")
        line = {"experiment": exp.name,
                "samples": int(traced[0][0].trace.num_samples),
                "completion_cycles": traced[0][0].completion_cycles,
                "wall_s_traced": traced_s, "wall_s_untraced": plain_s}
        if exp.name == sizes["export"]:
            line["kernels_per_cycle"] = {
                "untraced": kernels_per_cycle(XE._prepare(
                    topo, exp.routing.make(), tf, exp.sweep.loads,
                    device=device, **kw), device),
                "traced": kernels_per_cycle(XE._prepare(
                    topo, exp.routing.make(), tf, exp.sweep.loads,
                    trace=True, device=device, **kw), device)}
        runs.append(line)
    with tempfile.TemporaryDirectory() as tmp:
        src = sizes["spec"]
        if not isinstance(src, str):
            src = os.path.join(tmp, "trace_spec.json")
            ST.dump_specs(specs, src)
        path = os.path.join(tmp, "trace.json")
        proc, cli_s = studies_cli("trace", "export", src, "--experiment",
                                  sizes["export"], "--backend", "both",
                                  "--device", device, "--packets", "4",
                                  "--out", path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    validate_trace_events(events)
    if "cross-engine traces agree exactly" not in proc.stdout:
        raise AssertionError(f"trace export: {proc.stdout[-2000:]}")
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the traced sweeps launched a model kernel: "
                             f"{launched}")
    out = {"runs": runs, "export_events": len(events),
           "export_cli_wall_s": cli_s,
           "export_says": [ln for ln in proc.stdout.splitlines()
                           if ln.startswith(("completion", "cross"))],
           "seconds": time.perf_counter() - t0, "launches": launched}
    emit("trace", device=device, **out)
    return out

# ---------------------------------------------------------------------------
# Serving traffic and SLO capacity (repro_torch.workload, the engine's
# request metrics) and graphs kept across calls (shape bucketing, the
# graph cache).  No hand-written kernel runs here.
# ---------------------------------------------------------------------------

#: The serving phase: ``spec`` through the studies CLI against the CPU,
#: its ``oracle`` experiments against the numpy oracle on request count
#: and attainment (ROADMAP C2); ``slo`` (Study.slo_capacity's arguments,
#: empty for the CLI's defaults) of every experiment through the workload
#: CLI against the same search on the CPU (``search`` also in this process,
#: where its time goes); ``sweep``, MMPP serving traffic
#: on ``xl_scale``'s 1040-switch Dragonfly (bench_compile.py:161-200),
#: drained, against the CPU; ``cache``: two ``sim_speed`` sweeps and the
#: ``replay`` spec's Study through the graph cache.
SERVING_FULL = {
    "spec": "serving_slo",
    "oracle": ("cin-xor-16/serving-poisson-r0.05/minimal",
               "cin-xor-16/serving-mmpp-r0.03-b6/minimal"),
    "slo": {},
    "search": "cin-xor-16/serving-mmpp-r0.03-b6/minimal",
    "sweep": {"dragonfly": (16, 8, 8, 65), "load": 1.0, "seed": 0,
              "arrival": {"kind": "mmpp", "rate": 0.02, "burst": 6.0,
                          "p_on": 0.05, "p_off": 0.2},
              "packets_per_request": 4, "slo": 40.0, "cycles": 256},
    "cache": {"sim_speed": SIM_FULL["sim_speed"],
              "replay": STUDIES_FULL["replay"]},
}
#: The same phase at a size the CPU runs in seconds
#: (tests/test_torch_sim_smoke.py): CIN-8 serving experiments, a
#: 36-switch Dragonfly sweep.
SERVING_TINY = {
    "spec": [{"fabric": {"kind": "cin", "params": {"instance": "xor",
                                                   "n": 8}},
              "traffic": {"pattern": "serving",
                          "params": {"arrival": arrival,
                                     "packets_per_request": 2, "slo": 12}},
              "routing": {"policy": "minimal"},
              "sweep": {"loads": [0.5, 1.0], "seeds": [7], "cycles": 120,
                        "warmup": 0},
              "terminals": 1, "engine": {"drain": True}}
             for arrival in ({"kind": "poisson", "rate": 0.05},
                             {"kind": "mmpp", "rate": 0.03, "burst": 6.0,
                              "p_on": 0.05, "p_off": 0.2})],
    "oracle": ("cin-xor-8/serving-poisson-r0.05/minimal",),
    "slo": {"hi": 4.0, "tol": 0.5},
    "search": "cin-xor-8/serving-mmpp-r0.03-b6/minimal",
    "sweep": {"dragonfly": (4, 2, 2, 9), "load": 1.0, "seed": 0,
              "arrival": {"kind": "mmpp", "rate": 0.02, "burst": 6.0,
                          "p_on": 0.05, "p_off": 0.2},
              "packets_per_request": 4, "slo": 40.0, "cycles": 40},
    "cache": {"sim_speed": SIM_TINY["sim_speed"],
              "replay": STUDIES_TINY["replay"]},
}
SERVING_FIELDS = ("request_count", "request_latency_p50",
                  "request_latency_p95", "request_latency_p99",
                  "slo_target", "slo_attainment")


def sim_speed_sweep(cfg, device, **kw):
    """One ``sim_speed`` sweep (run_sim_speed's) and its wall seconds."""
    n = cfg["n"]

    def tf(load, seed):
        return S.uniform(n, offered=load, cycles=cfg["cycles"],
                         terminals=cfg["terminals"], seed=seed)
    args = (S.cin_topology("xor", n), "minimal", tf, cfg["loads"])
    kw = dict(seeds=cfg["seeds"], terminals=cfg["terminals"],
              cycles=cfg["cycles"], warmup=cfg["warmup"], device=device, **kw)
    t0 = time.perf_counter()
    grid = S.sweep(*args, **kw)
    return grid, time.perf_counter() - t0, args, kw


def serving_cache(cfg, device):
    """The graph cache, from empty: ``sim_speed`` twice (a capture, then a
    hit equal to it), kernels per cycle and blocks run per call with and
    without bucketing, then the replay spec's Study twice (the second all
    hits), with its capture seconds."""
    telemetry.clear_caches()
    telemetry.reset_cache_stats()
    first, first_s, args, kw = sim_speed_sweep(cfg["sim_speed"], device)
    second, second_s, _, _ = sim_speed_sweep(cfg["sim_speed"], device)
    t1, t2 = first[0][0].timing, second[0][0].timing
    if t1["compile_cached"] is not False or \
            t2["compile_cached"] != "memory":
        raise AssertionError(f"sim_speed: compile_cached {t1} then {t2}, "
                             f"expected a capture then a memory hit")
    check_same_grid("sim_speed: the kept graph against the first call",
                    second, first)
    by_bucket = {}
    for bucket in (True, False):
        prep = XE._prepare(*args, bucket=bucket, **kw)
        before = XE.block_runs
        S.sweep(*args, bucket=bucket, **kw)
        by_bucket[str(bucket)] = {
            "kernels_per_cycle": kernels_per_cycle(prep, device),
            "blocks_per_call": XE.block_runs - before,
            "static_horizon": prep.spec.horizon,
            "packet_slots": int(prep.pkt["src"].numel()),
            "log_entries": (prep.spec.horizon * int(prep.tb["sw_local"]
                                                    .numel())
                            if prep.spec.log_deliveries else 0)}
    kb, ke = by_bucket["True"], by_bucket["False"]
    if (kb["kernels_per_cycle"], kb["blocks_per_call"]) != \
            (ke["kernels_per_cycle"], ke["blocks_per_call"]):
        raise AssertionError(f"bucketing changed the step: {by_bucket}")
    replay = load_spec_source(cfg["replay"])
    cold, cold_s = timed_study(replay, device)
    hits = telemetry.cache_stats()["memory_hits"]
    warm, warm_s = timed_study(replay, device)
    line = study_line("replay", device, cold, cold_s, warm, warm_s)
    if telemetry.cache_stats()["memory_hits"] - hits != line["experiments"]:
        raise AssertionError("the warm replay study captured a graph")
    out = {"sim_speed_first": {"wall_s": first_s, "timing": t1},
           "sim_speed_second": {"wall_s": second_s, "timing": t2},
           "bucketing": by_bucket,
           "replay_study": {k: line[k] for k in (
               "experiments", "wall_s_cold", "wall_s_warm",
               "compile_s_sum", "execute_s_sum", "host_s_sum")},
           "replay_cold_compile_s_sum": sum(
               t["compile_s"] for t in {r.experiment: r.stats.timing
                                        for r in cold.results}.values()),
           "counters": telemetry.cache_stats()}
    emit("serving_cache", device=device, **out)
    return out


def serving_sweep(cfg, device):
    """MMPP serving traffic on a Dragonfly, drained, on ``device`` and on
    the CPU: every RunStats field, the request metrics included, equal;
    the host seconds of the request attachment (attach_serving)."""
    a, p, h, g = cfg["dragonfly"]
    topo = S.dragonfly_topology(DragonflyConfig(
        group_size=a, terminals_per_switch=p, global_ports_per_switch=h,
        num_groups=g))
    topo.minimal_port_table()
    n = topo.num_switches
    arrival = W.ArrivalSpec(**cfg["arrival"])

    def tf(load, seed):
        return W.serving_traffic(arrival, n, cycles=cfg["cycles"], load=load,
                                 terminals=p,
                                 packets_per_request=cfg[
                                     "packets_per_request"],
                                 slo=cfg["slo"], seed=seed)
    inner = XE.attach_serving
    spent = []

    def attach(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    def run(dev):
        t0 = time.perf_counter()
        grid = S.sweep(topo, "minimal", tf, [cfg["load"]],
                       seeds=(cfg["seed"],), terminals=p,
                       cycles=cfg["cycles"], warmup=0, drain=True,
                       device=dev)
        return grid, time.perf_counter() - t0
    XE.attach_serving = attach
    try:
        got, wall_s = run(device)
        want, cpu_s = run("cpu")
    finally:
        XE.attach_serving = inner
    check_same_grid("serving sweep against the CPU", got, want)
    st = got[0][0]
    if not st.request_count or st.slo_attainment is None:
        raise AssertionError("the serving sweep reported no requests")
    out = {"switches": n, "terminals": n * p, "cycles": cfg["cycles"],
           "packets": int(st.packets_generated),
           **{f: getattr(st, f) for f in SERVING_FIELDS},
           "wall_s": wall_s,
           "cpu_wall_s": cpu_s, "timing": st.timing,
           "attach_serving_host_s": spent[0]}
    emit("serving_sweep", device=device, **out)
    return out


def sweep_timings(fn):
    """``fn()`` and the timing records of every sweep it ran."""
    inner = XE._collect
    seen = []

    def collect(run, out, timing):
        seen.append(timing)
        return inner(run, out, timing)
    XE._collect = collect
    try:
        return fn(), seen
    finally:
        XE._collect = inner


def serving_time(specs, cfg, device):
    """Where a serving study's and an SLO search's time goes, in this
    process on ``device``: the spec's ``Study.run()`` cold and warm (its
    captures, replays and host work), then the ``search`` experiment's
    ``slo_capacity``: wall seconds, probes, captures and memory hits, and
    the probes' summed capture, replay and host seconds."""
    cold, cold_s = timed_study(specs, device)
    warm, warm_s = timed_study(specs, device)
    study = study_line(cfg["spec"] if isinstance(cfg["spec"], str)
                       else "serving", device, cold, cold_s, warm, warm_s)
    before = telemetry.cache_stats()
    t0 = time.perf_counter()
    cap, timings = sweep_timings(lambda: ST.Study(
        specs, device=device).slo_capacity(cfg["search"], **cfg["slo"]))
    after = telemetry.cache_stats()
    search = {"experiment": cfg["search"], "wall_s": time.perf_counter() - t0,
              "probes": len(cap["probes"]), "capacity": cap["capacity"],
              "captures": after["misses"] - before["misses"],
              "memory_hits": after["memory_hits"] - before["memory_hits"],
              **{f"{k}_sum": sum(t[k] for t in timings)
                 for k in ("compile_s", "execute_s", "host_s")}}
    emit("serving_time", device=device, study=study, search=search)
    return {"study": study, "search": search, "cap": cap}


def slo_lines(cap):
    """The lines ``python -m repro_torch.workload slo`` prints for a
    search's result, the cache line aside."""
    return ([f"experiment: {cap['experiment']}",
             f"slo: p{cap['percentile']:g} <= {cap['slo']} cycles"]
            + [f"  probe load={load}: attainment={att}"
               for load, att in cap["probes"]]
            + [f"capacity: {cap['capacity']}"])


def phase_serving(device="cuda", sizes=SERVING_FULL):
    """Serving studies on ``device``: the graph cache, then where a serving
    study's and a search's time goes (both timed alone), then the studies
    CLI on the serving spec and the workload CLI's SLO
    search of every experiment, as processes of their own and all at once,
    while this process runs the deployment-size serving sweep and the CPU
    and numpy runs they are held to.  On the CPU (the rehearsal) runs keep
    their buffers in the graph cache as the card's do."""
    t0 = time.perf_counter()
    reset_launches()
    kept = XE._CACHE_DEVICES
    if device == "cpu":
        XE._CACHE_DEVICES = ("cuda", "cpu")
    try:
        cache = serving_cache(sizes["cache"], device)
        specs = load_spec_source(sizes["spec"])
        spent = serving_time(specs, sizes, device)
        with tempfile.TemporaryDirectory() as tmp:
            src = sizes["spec"]
            if not isinstance(src, str):
                src = os.path.join(tmp, "serving_spec.json")
                ST.dump_specs(specs, src)
            store = os.path.join(tmp, "serving.results.jsonl")
            slo_args = [a for k, v in sizes["slo"].items()
                        for a in (f"--{k}", str(v))]
            run = cli_start("repro_torch.studies", "run", src, "--backend",
                            "torch", "--device", device, "--store", store)
            slos = {e.name: cli_start("repro_torch.workload", "slo", src,
                                      "--experiment", e.name, "--device",
                                      device, *slo_args) for e in specs}
            sweep = serving_sweep(sizes["sweep"], device)
            cpu, cpu_s = timed_study(specs, "cpu")
            oracle, oracle_s = timed_study(
                [e for e in specs if e.name in sizes["oracle"]], None,
                backend="numpy")
            cpu_caps = {}
            for name in slos:
                t1 = time.perf_counter()
                cap = ST.Study(specs, device="cpu").slo_capacity(
                    name, **sizes["slo"])
                cpu_caps[name] = (cap, time.perf_counter() - t1)
            if cpu_caps[sizes["search"]][0] != spent["cap"]:
                raise AssertionError(f"slo {sizes['search']}: the search on "
                                     f"the device differs from the CPU's")
            proc, cli_s = cli_wait(run)
            stored = ST.JsonlStore(store).load()
            done = {name: cli_wait(started) for name, started in slos.items()}
        keys = [e.key(*pt) for e in specs for pt in e.points()]
        if sorted(stored) != sorted(keys):
            raise AssertionError(f"the CLI stored {sorted(stored)}, not "
                                 f"{keys}")
        records = [stored[k] for k in keys]
        if {r.backend for r in records} != {"torch"}:
            raise AssertionError("the serving CLI's records did not come "
                                 "from the torch engine")
        check_same_records("serving: CLI on the device against the CPU",
                           records, cpu.results)
        for r in oracle.results:
            got = stored[r.key]
            if (got.request_count, got.slo_attainment) != \
                    (r.request_count, r.slo_attainment):
                raise AssertionError(f"{r.key}: requests/attainment "
                                     f"{got.request_count}/"
                                     f"{got.slo_attainment}, numpy "
                                     f"{r.request_count}/{r.slo_attainment}")
        searches = []
        for name, (sproc, s_wall) in done.items():
            lines = sproc.stdout.strip().splitlines()
            cap, c_s = cpu_caps[name]
            if lines[:-1] != slo_lines(cap):
                raise AssertionError(f"slo {name}: the card's search\n"
                                     f"{lines}\ndiffers from the CPU's\n"
                                     f"{slo_lines(cap)}")
            counters = dict(kv.split("=") for kv in lines[-1].split()[2:])
            searches.append({"experiment": name, "probes": cap["probes"],
                             "capacity": cap["capacity"],
                             "cli_wall_s": s_wall, "cpu_wall_s": c_s,
                             "captures": int(counters["captures"]),
                             "memory_hits": int(counters["memory_hits"])})
    finally:
        XE._CACHE_DEVICES = kept
    for line in searches:
        emit("serving_slo", device=device, **line)
    launched = kernel_launches()
    if any(launched.values()):
        raise AssertionError(f"the serving phase launched a model kernel: "
                             f"{launched}")
    out = {"cache": cache, "sweep": sweep, "searches": searches,
           "time": {k: spent[k] for k in ("study", "search")},
           "study": {"points": len(records), "cli_wall_s": cli_s,
                     "cpu_wall_s": cpu_s, "oracle_wall_s": oracle_s,
                     "oracle_checked": len(oracle.results),
                     "serving_points": cpu.serving_points(),
                     "cli_says": [ln for ln in proc.stdout.splitlines()
                                  if ln.startswith("ran ")]},
           "memory_allocated_with_cache": (torch.cuda.memory_allocated()
                                           if device == "cuda" else None),
           "memory_reserved_with_cache": (torch.cuda.memory_reserved()
                                          if device == "cuda" else None),
           "graphs_kept": len(telemetry._CACHE),
           "seconds": time.perf_counter() - t0, "launches": launched}
    emit("serving", device=device, **out)
    return out


def main():
    smi = phase_device()
    phase_build()
    phase_hazards()
    b, h, kvh, d = len(PROMPTS), 24, 8, 128
    serving = (b, max(PROMPTS), max(PROMPTS), h, kvh, d, None)
    pre = time_attention("prefill", *serving, copies=1)
    dec = time_attention("decode", b, 1, MAX_SEQ, h, kvh, d, [DECODE_POS],
                         copies=8)
    fp32 = time_attention("prefill", *serving, copies=1, dtype=torch.float32)
    # fp32 decode steps take the tensor-core kernel too: it and the FMA
    # kernel at llama3.2-3b's decode shape
    dec32 = time_attention("decode", b, 1, MAX_SEQ, h, kvh, d, [DECODE_POS],
                           copies=8, dtype=torch.float32)
    # granite-moe-3b-a800m's attention: D = 64 (G = 24/8 = 3)
    phase_hazards(head_dim=64)
    g = get_config("granite-moe-3b-a800m")
    gserving = (b, max(PROMPTS), max(PROMPTS), g.num_heads, g.num_kv_heads,
                g.head_dim, None)
    gpre = time_attention("prefill", *gserving, copies=1, phase="attention",
                          model=g.name)
    gdec = time_attention("decode", b, 1, MAX_SEQ, g.num_heads,
                          g.num_kv_heads, g.head_dim, [DECODE_POS], copies=8,
                          phase="attention", model=g.name)
    # gemma3-1b's attention: D = 256 (G = 4/1 = 4)
    phase_hazards(head_dim=256)
    m = get_config("gemma3-1b")
    mserving = (b, max(PROMPTS), max(PROMPTS), m.num_heads, m.num_kv_heads,
                m.head_dim, None)
    mpre = time_attention("prefill", *mserving, copies=1, phase="attention",
                          model=m.name)
    mdec = time_attention("decode", b, 1, MAX_SEQ, m.num_heads,
                          m.num_kv_heads, m.head_dim, [DECODE_POS], copies=8,
                          phase="attention", model=m.name)
    mfp32 = time_attention("prefill", *mserving, copies=1,
                           dtype=torch.float32, phase="attention",
                           model=m.name)
    mdec32 = time_attention("decode", b, 1, MAX_SEQ, m.num_heads,
                            m.num_kv_heads, m.head_dim, [DECODE_POS],
                            copies=8, dtype=torch.float32, phase="attention",
                            model=m.name)
    # starcoder2-3b's attention: G = 24/2 = 12 (its hazards are in HAZARDS)
    c = get_config("starcoder2-3b")
    cpre = time_attention("prefill", b, max(PROMPTS), max(PROMPTS),
                          c.num_heads, c.num_kv_heads, c.head_dim, None,
                          copies=1, phase="attention", model=c.name)
    cdec = time_attention("decode", b, 1, MAX_SEQ, c.num_heads,
                          c.num_kv_heads, c.head_dim, [DECODE_POS], copies=8,
                          phase="attention", model=c.name)
    # hymba-1.5b's attention: G = 25/5 = 5, 128 meta tokens before the
    # prompt (its windows of 1024 do not bind at 640 positions)
    y = get_config("hymba-1.5b")
    ypos = y.num_meta_tokens + max(PROMPTS)
    ypre = time_attention("prefill", b, ypos, ypos, y.num_heads,
                          y.num_kv_heads, y.head_dim, None, copies=1,
                          phase="attention", model=y.name)
    ydec = time_attention("decode", b, 1, MAX_SEQ, y.num_heads,
                          y.num_kv_heads, y.head_dim,
                          [DECODE_POS + y.num_meta_tokens], copies=8,
                          phase="attention", model=y.name)
    # and in fp32, the shape of its fp32 prefill check (32 calls a check)
    ypre32 = time_attention("prefill", b, ypos, ypos, y.num_heads,
                            y.num_kv_heads, y.head_dim, None, copies=1,
                            dtype=torch.float32, phase="attention",
                            model=y.name)
    # internvl2-26b's: G = 48/8 = 6, 256 patch embeddings before the prompt
    iv = get_config("internvl2-26b")
    ipos = iv.num_patch_tokens + max(PROMPTS)
    ipre = time_attention("prefill", b, ipos, ipos, iv.num_heads,
                          iv.num_kv_heads, iv.head_dim, None, copies=1,
                          phase="attention", model=iv.name)
    # qwen3-moe-30b-a3b's: G = 32/4 = 8 (prefill blocks of 24 positions x
    # 8 heads: 192 rows); nemotron-4-15b's is internvl2-26b's (G 6)
    q3 = get_config("qwen3-moe-30b-a3b")
    q3shape = (q3.num_heads, q3.num_kv_heads, q3.head_dim)
    qpre = time_attention("prefill", b, max(PROMPTS), max(PROMPTS),
                          *q3shape, None, copies=1, phase="attention",
                          model=q3.name)
    qdec = time_attention("decode", b, 1, MAX_SEQ, *q3shape, [DECODE_POS],
                          copies=8, phase="attention", model=q3.name)
    # whisper-base's: the encoder (non-causal over 1500 frames), and
    # cross-attention from position 0 against them at prefill and decode
    w = get_config("whisper-base")
    wshape = (w.num_heads, w.num_kv_heads, w.head_dim)
    wenc = time_attention("encoder", b, w.encoder_seq_len, w.encoder_seq_len,
                          *wshape, None, copies=1, causal=False,
                          phase="attention", model=w.name)
    wx = time_attention("cross prefill", b, max(PROMPTS), w.encoder_seq_len,
                        *wshape, [0] * max(PROMPTS), copies=1, causal=False,
                        phase="attention", model=w.name)
    wxd = time_attention("cross decode", b, 1, w.encoder_seq_len, *wshape,
                         [0], copies=8, causal=False, phase="attention",
                         model=w.name)
    hazard_launches = phase_mlstm_hazards()
    scan = time_mlstm(torch.bfloat16)
    scan32 = time_mlstm(torch.float32)
    small = phase_small_model()
    llama, llama_trace, _ = phase_serve("llama3.2-3b")
    xlstm, _, xlstm_check = phase_serve("xlstm-350m")
    granite, _, _ = phase_serve("granite-moe-3b-a800m")
    gemma, _, _ = phase_serve("gemma3-1b")
    starcoder, _, _ = phase_serve("starcoder2-3b")
    hymba, _, hymba_check = phase_serve("hymba-1.5b")
    whisper, _, _ = phase_serve("whisper-base")
    nemotron, _, _ = phase_serve("nemotron-4-15b")
    qwen3, _, _ = phase_serve("qwen3-moe-30b-a3b")
    vlm = phase_vlm_prefill()
    phase_moe()
    train_launched = {}
    train_lines, train_timing = phase_train(launched=train_launched)
    train = {arch: line["launches"] for arch, line in train_lines.items()}
    phase_xlstm_sp()
    shard, shard_cell = phase_shard()
    phase_dryrun(real=shard_cell)
    tp_launches, tp_timing = phase_tp()
    extract_dp_launches = phase_extract(trace=llama_trace, card=smi)
    phase_sim()
    phase_studies()
    phase_faults()
    phase_flow()
    phase_trace()
    phase_serving()

    def entry(kernel, path, source, replaces, timing, runs, keys=(),
              **more):
        """One kernel; ``runs`` are the launch counts of the runs that drive
        its path."""
        key = f"{kernel}_{path}"
        return {
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": sum(run[key] for run in runs.values()),
            "launches_by_run": {name: run[key] for name, run in runs.items()},
            "calls_by_run": {name: run[kernel] for name, run in runs.items()},
            **{k: timing[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "shape", *keys)}, **more}
    serve_runs = {"llama3.2-3b": llama,
                  f"xlstm-350m ({SERVE_LAYERS['xlstm-350m']} layers)": xlstm,
                  f"hymba-1.5b ({SERVE_LAYERS['hymba-1.5b']} layers)": hymba,
                  "granite-moe-3b-a800m": granite, "gemma3-1b": gemma,
                  "starcoder2-3b": starcoder, "whisper-base": whisper,
                  f"nemotron-4-15b ({SERVE_LAYERS['nemotron-4-15b']} layers)":
                      nemotron,
                  f"qwen3-moe-30b-a3b ({SERVE_LAYERS['qwen3-moe-30b-a3b']} "
                  "layers)": qwen3}
    train_runs = {f"train {arch}": run for arch, run in train.items()}
    tp_runs = {f"tp {arch} ({layers} layers) rank 0": tp_launches[arch]
               for arch, layers, _ in tp_models(TP_FULL)}
    for tp_run, runs in tp_runs.items():
        serve_runs[f"{tp_run} serve bf16"] = runs["serve_bf16"]
        train_runs[f"{tp_run} train bf16"] = runs["train_bf16"]
    prefill_runs = dict(serve_runs, **train_runs,
                        **{"extract dp llama3.2-3b": extract_dp_launches,
                           f"shard {SHARD_FULL['arch']}": shard,
                           f"prefill {VLM['arch']} ({VLM['layers']} layers)":
                               vlm})
    # Every run that drives the fp32 kernels: the serve phase's fp32
    # prefill checks, the training hazards (the lse and the Functions in
    # fp32 and bf16), the reduced models' training check in fp32, xlstm-350m's
    # fp32 step 1, the reduced models in fp32.
    fp32_runs = {"reduced models in fp32": small,
                 "serve check hymba-1.5b (fp32 prefill)": hymba_check,
                 "serve check xlstm-350m (fp32 prefill)": xlstm_check,
                 "train hazards": train_launched["hazards"],
                 "train reduced models (fp32)": train_launched["reduced"],
                 "train xlstm-350m step 1 (fp32)": train_lines[
                     "xlstm-350m"]["step1_launches"],
                 "train hymba-1.5b step 1 (fp32, "
                 f"{TRAIN_FULL['step1']['hymba-1.5b'][1]} layers)":
                     train_lines["hymba-1.5b"]["step1_launches"],
                 **{f"{tp_run} {part.replace('_', ' ')}": runs[part]
                    for tp_run, runs in tp_runs.items()
                    for part in ("serve_fp32", "train_fp32")}}
    attn = "src/repro/kernels/flash_attention.py:39"
    scan_keys = ("state_max_abs_err", "library_note", "ms_eager",
                 "plain_ms_eager", "bound_ms_fp32_pipe")
    at = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
          "library_backend", "bound_ms", "bound_by")
    at32 = at + ("split_floor_ms",)

    def replaced(kernel, path, source, runs, **times):
        """The FMA kernel a tensor-core path replaced: its launches by run
        (none: no plan() gives it these calls) and its times in this run
        at the new path's shapes."""
        key = f"{kernel}_{path}"
        by_run = {name: run.get(key, 0) for name, run in runs.items()}
        return {"name": key, "source": f"src/repro_torch/kernels/csrc/{source}",
                "launches": sum(by_run.values()), "launches_by_run": by_run,
                **times}

    def with_lse(case, t=None):
        t = t or train_timing[case]
        return dict(shape=t["shape"], ms=t["fwd_ms"],
                    plain_ms=t["fwd_plain_ms"],
                    library_ms=t["fwd_library_ms"],
                    library_backend=t["fwd_library_backend"],
                    bound_ms=t["fwd_bound_ms"], bound_by=t["fwd_bound_by"])
    def scan_at_training(dtype):
        t = train_timing[f"mlstm {dtype}"]
        return dict(shape=t["shape"], ms=t["fwd_ms"],
                    plain_ms=t["fwd_plain_ms"], library_ms=None,
                    bound_ms=t["fwd_bound_ms"], bound_by=t["fwd_bound_by"],
                    plain_backward_ms=t["bwd_plain_ms"],
                    plain_backward_bound_ms=t["bwd_bound_ms"],
                    plain_backward_bound_by=t["bwd_bound_by"])
    kernels = [
        entry("flash_attention", "prefill", "flash_attention_prefill.cu",
              attn, pre, prefill_runs, at_d64={k: gpre[k] for k in at},
              at_d256={k: mpre[k] for k in at},
              at_training_shape_with_lse=with_lse("training_shape"),
              at_training_shape_with_lse_d256=with_lse(
                  "training_shape_d256"),
              at_gqa12={k: cpre[k] for k in at},
              at_training_shape_with_lse_gqa12=with_lse(
                  "training_shape_gqa12"),
              at_gqa5={k: ypre[k] for k in at},
              at_gqa6={k: ipre[k] for k in at},
              at_gqa8={k: qpre[k] for k in at},
              at_cross_s1500={k: wx[k] for k in at},
              at_encoder_t1500={k: wenc[k] for k in at},
              **{f"at_{case}_with_lse": with_lse(case)
                 for case in PREFIXED_CASES},
              at_tp_rank_h12_kv4={k: tp_timing["prefill"][k] for k in at},
              at_tp_rank_training_shape_with_lse=with_lse(
                  TP_RANK_CASE, tp_timing["lse"]),
              at_tp_rank_whisper_encoder_h4={
                  k: tp_timing["whisper_encoder"][k] for k in at},
              at_tp_rank_whisper_cross_h4={
                  k: tp_timing["whisper_cross"][k] for k in at},
              **{f"at_{case}_with_lse": with_lse(case, tp_timing[case])
                 for case in TP_WHISPER_CASES}),
        entry("flash_attention", "decode", "flash_attention_decode.cu", attn,
              dec, serve_runs, at_d64={k: gdec[k] for k in at},
              at_d256={k: mdec[k] for k in at},
              at_gqa12={k: cdec[k] for k in at},
              at_gqa5={k: ydec[k] for k in at},
              at_gqa8={k: qdec[k] for k in at},
              at_cross_s1500={k: wxd[k] for k in at},
              at_tp_rank_h12_kv4={k: tp_timing["decode"][k] for k in at},
              at_tp_rank_whisper_cross_h4={
                  k: tp_timing["whisper_cross_decode"][k] for k in at}),
        entry("flash_attention", "fp32_tc", "flash_attention_fp32tc.cu", attn,
              fp32, fp32_runs, ("split_floor_ms",),
              at_d256={k: mfp32[k] for k in at32},
              at_gqa5={k: ypre32[k] for k in at32},
              at_decode={k: dec32[k] for k in at32},
              at_decode_d256={k: mdec32[k] for k in at32}),
        entry("mlstm_scan", "tc", "mlstm_scan_tc.cu",
              "src/repro/kernels/mlstm_scan.py:32", scan,
              dict(serve_runs, **train_runs), scan_keys + ("fma_ms",),
              at_training_shape=scan_at_training("bfloat16"),
              at_tp_rank_h2={k: tp_timing["scan"][k] for k in (
                  "shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                  "bound_ms", "bound_by")},
              at_tp_rank_training_shape=dict(
                  shape=tp_timing["scan_training"]["shape"],
                  ms=tp_timing["scan_training"]["fwd_ms"],
                  plain_ms=tp_timing["scan_training"]["fwd_plain_ms"],
                  library_ms=None,
                  bound_ms=tp_timing["scan_training"]["fwd_bound_ms"],
                  bound_by=tp_timing["scan_training"]["fwd_bound_by"])),
        entry("mlstm_scan", "tc_f32", "mlstm_scan_fp32tc.cu",
              "src/repro/kernels/mlstm_scan.py:32", scan32, fp32_runs,
              scan_keys + ("split_floor_ms", "fma_ms", "held_to",
                           "outside_tol_vs_float64",
                           "plain_outside_tol_vs_float64",
                           "row_outside_vs_float64"),
              at_training_shape=dict(
                  scan_at_training("float32"),
                  split_floor_ms=train_timing["mlstm float32"][
                      "fwd_split_floor_ms"],
                  fma_ms=train_timing["mlstm float32"]["fwd_fma_ms"]),
              replaced=replaced(
                  "mlstm_scan", "fma", "mlstm_scan.cu", fp32_runs,
                  ms=scan32["fma_ms"],
                  at_training_shape_ms=train_timing["mlstm float32"][
                      "fwd_fma_ms"])),
        # The FMA kernel keeps the calls whose chunk is not a multiple of
        # 16 (chunk24_bf16, in both dtypes); timed at the fp32 serving
        # shape, which it took before the split kernel.
        entry("mlstm_scan", "fma", "mlstm_scan.cu",
              "src/repro/kernels/mlstm_scan.py:32",
              dict(scan32, ms=scan32["fma_ms"],
                   ms_eager=scan32["fma_ms_eager"],
                   max_abs_err=scan32["fma_max_abs_err"]),
              {"mlstm hazards": hazard_launches},
              scan_keys[1:] + ("split_floor_ms",))]
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels of the path that no run launched: "
                             f"{idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--xlstm-witness"]:
        if not torch.cuda.is_available():
            raise SystemExit("the witness needs a CUDA device")
        phase_device()
        xlstm_witness(out=sys.argv[2] if len(sys.argv) > 2 else None)
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(*sys.argv[2:])
    elif sys.argv[1:2] in (["--gelu-ab"], ["--silu-ab"]):
        phase_device()
        activation_ab(sys.argv[1][2:6])
    else:
        main()
