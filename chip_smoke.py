#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the script with a
non-zero exit code:

1. card: the GPU's name and power limit (``nvidia-smi``); TF32 off.
2. build: every kernel library (``src/repro_torch/kernels/*/csrc``: the
   flash backward and the 16-bit grouped kernels among them), one
   ``nvcc`` each, all started together, timed.
3. kernels: each kernel against its plain PyTorch version, with the
   kernel, plain and library times and the card's bound: the two
   dequant-matmul kernels (int8 with the policy's outlier rows, 1% of K,
   its outlier product in the same launch, beside the parent's path of
   the kernel and a separate product, ``separate_ms``) and the fp16
   kernel (float16's weights converted to bf16 in registers, beside
   ``torch.matmul`` on a bf16 copy and on ``w.to(bfloat16)``) at the
   llama-3.1-8b projection shapes (M in {1, 4, 8, 464, 512}, four (K, N);
   fp16 also the LM head (4096, 128256) at M in {1, 2, 4}) and at every
   other 2-D projection
   that a serve cell runs in int8 or nf4 (qwen3-moe-30b-a3b's and
   granite-moe-1b-a400m's attention, command-r-35b's seven, mamba2-2.7b's
   w_in (2560, 10576) and w_out (5120, 2560) in nf4, zamba2-1.2b's w_in
   (2048, 8384), w_out (4096, 2048) and shared block in int8,
   seamless-m4t-large-v2's (1024, 1024), (1024, 8192) and (8192, 1024)
   in int8), at the rows the serve gives it (1 and 4 at decode, 512 at
   prefill; for the Model runs the rows their prefills, encoders and
   decode pair give them), in bf16, each row naming the loop
   that ran: "decode" for M <= 8 (the TMA + tensor-core loop of
   ``qmm_wgmma.cuh`` at 8 rows of x, its K steps split evenly over one
   block per SM and the split tiles merged in the same launch), "wgmma"
   for prefill; at the headline decode shape (M = 4, w_gate) one call of
   either, captured in a CUDA graph, must be one kernel node and nothing
   else; flash attention at llama-3.1-8b's
   heads (B, S) in {(1, 81), (2, 256), (1, 2048)} causal, one windowed
   cell and one at qwen2.5-0.5b's heads, and at head_dim 120
   (h2o-danube-3-4b: (2, 256) causal and a window of 4096 over S = 4608)
   and 96 (phi-3-vision-4.2b: (2, 256) causal, and (2, 576 + 256)), and
   (2, 256) at the
   heads of qwen3-moe-30b-a3b (32/4/64), stablelm-1.6b (32/32/64, also
   zamba2-1.2b's shared block), command-r-35b (64/8/128),
   granite-moe-1b-a400m (16/8/64) and seamless-m4t-large-v2 (16/16/64);
   paged attention at
   llama-3.1-8b's heads for B in {1, 4, 8} and ring lengths W in {261,
   512, 4096}, at the other seven heads for B = 4
   over W = 512, in three cases at each cell: ragged lengths and an
   unassigned page; the same over int8 pages and their f32 scales (the
   port's ``quantize_kv`` of the cell's caches; the library call reads
   them dequantized beforehand); and the position test (``slot_pos``,
   ``pos``, ``window``: pad slots inside a prefix, a window narrower
   than the ring, a row with no valid slot, which must be exactly 0,
   ``slot_positions``); and all three at every shape the
   Model runs (phase 8) give them (``model_attention_cells``, derived
   from the runs' own padding and rings): flash causal over each
   prefill (phi-3-vision: 576 patches and the padded prompt, S = 784 to
   824; seamless's decoder, S = 208 to 248), unmasked over seamless's
   encoder (64 over 64 frames) and cross-attention (the padded prompt
   over 64 frames), paged over each decoded pair's ring (phi-3-vision
   832 and 896, seamless 256 and 320) and seamless's encoder K/V (64,
   one page a row); the
   attention cells in bf16 and
   f32, each checked row by row and beside a control (the plain version
   with its mask edge moved by one key) that the check must see. At each
   cell one call of either attention kernel, captured in a CUDA graph,
   must be one kernel node and nothing else (paged attention merges its
   splits in the same launch). The grouped launch of every grouped entry
   point (every expert of an MoE projection in one launch: the int8 and
   nf4 kernels, and ``bf16_matmul_grouped`` and ``fp16_matmul_grouped``
   for 16-bit expert stacks) at
   qwen3-moe-30b-a3b's expert shapes (E = 128; (K, N) = (2048, 768) and
   (768, 2048); C = 8 rows an expert at decode, 40 at prefill) in all
   four, and at every (E, C, K, N) that a serve cell's grouped
   products run (qwen3's and granite-moe-1b-a400m's, E = 32 over (1024,
   512) and (512, 1024), under the configs' capacity factor and the
   no-drop one of the logit pair, at decode, a request's own prefill and
   a batched prefill: C up to 512) in the formats the cell serves,
   against its plain version, each call one kernel node, beside
   ``torch.bmm`` on the weights already dequantized to bf16 (for bf16
   experts the product the kernel replaced; fp16's also with its cast,
   ``library_cast_ms``) and a Python loop of the 2-D kernel over the
   experts (none for bf16), in three occupancy cases:
   (a) every row kept (rows=None, timed: ``kernel_ms``); (b) the kept
   rows of a seeded top-8 routing of the cell's tokens through the
   port's dispatch (``dispatch``: its active experts, kernel time and
   bound over their weights); (c) no expert kept (``none_kept``). Past
   the counts the output must be exact zeros, and the first kept
   expert's rows the same bits alone, among the others and with
   rows=None. Then one qwen3-moe-30b-a3b MoE layer at full width, batch-4
   decode, int8, nf4 and bf16, must give the same bits with the dispatch's
   counts and with rows=None (the ``moe_layer_rows`` line). Every
   attention geometry a serve cell runs must be among the flash and
   paged cells. Then the fused kernels (``kernels/fused``, phase
   "fused"): ``rms_norm``, ``rope_qk`` and ``silu_mul`` at every call the
   runs make (``fused_cells``: each run's rows over d_model and the SSM
   gate norm's d_inner, each format's activation and gamma dtypes; RoPE
   over every causal flash cell and every paged cell's lanes, at every
   served head_dim; the gated activation over d_ff and every MoE expert
   stack of the grouped cells, whose rows past C / 2 are zeros that must
   stay zeros) against their plain versions (the eager ops they replace):
   ``rope_qk`` and ``silu_mul`` bit for bit, ``rms_norm`` within 1e-2
   (bf16) and 1e-5 (f32), one counted launch and one kernel
   node a call, with kernel, plain and, for the norm,
   ``torch.nn.functional.rms_norm`` times; then the Mamba2 decode step's
   ``ssm_conv_step`` and ``ssd_step`` at every SSM and hybrid serve
   cell's width (mamba2-2.7b, zamba2-1.2b), batch 1 to 4, in each
   format's activation and parameter dtypes and in f32, against their
   plain versions on clones of the same conv cache and state: the
   output, the conv cache and the state within the same tolerances.
4. serve: llama-3.1-8b at full width (random weights from
   ``torch.Generator(device="cuda").manual_seed(0)``) under each of the
   five formats, and in bfloat16 with an int8 KV cache (``kv_quant``: 32
   paged launches a step, each over int8 pages, and a teacher-forced
   check of 8 decode steps through the kernel against the same steps
   through its plain version, within TEACHER_TOL): a continuous run of 8 requests through
   ``repro_torch.launch.serve.serve``, the launch counts of the kernels
   in that run (one flash launch per layer and prefill phase, one paged
   launch per layer and decode step, each with the position test; under
   int8, nf4 and float16 (the fp16 kernel; its LM head one more
   decode-loop launch a phase) one wgmma-loop
   launch per projection, layer and prefill phase, one decode-loop
   launch per projection, layer and decode step, and no tile-loop
   launch, in the sequential run too), and each request's prefill logits
   against its own sequential run. Per format it prints the host wall
   times of the run's phases (``PhaseResult.wall_s``), the analytic
   report of the H100 SXM energy model (J/token, total J, the analytic
   clock, mean batch) and, labelled measured, the card's power draw
   sampled by ``nvidia-smi`` every 100 ms over the continuous run, with
   the J/token it integrates to. Every decode step of the run after its
   first replays the backend's CUDA graph (``ExecutedBackend.
   decode_graph``), and the line's ``decode_graph`` holds its check
   (``graph_check``): GRAPH_STEPS further steps, each through
   ``Model.decode_step`` eagerly on a copy of the cache and through a
   replay, logits, tokens and cache bit for bit, each step's launch
   counts equal, the graph's kernel nodes by function name equal to the
   eager step's launches (32 paged and 224 quant for llama in int8; 65
   rms_norm, 32 rope_qk and 32 silu_mul for llama, and a Mamba layer's
   ssm_conv_step and ssd_step a decode step: ``fused_launches``,
   checked per run and per step), and
   the host time to enqueue a step and its device time from CUDA events,
   eager and replayed.
5. moe: qwen3-moe-30b-a3b at full width and depth (48 layers, 128
   experts, top 8) in bfloat16, int8 and nf4, and granite-moe-1b-a400m
   (24 layers, 32 experts) in int8 and float16, with llama's traffic and
   checks: the
   timed continuous run keeps the config's capacity factor (1.25) and
   prints the layer-mean dropped fraction of each prefill; the prefill
   logit check runs a continuous and a sequential run under a capacity
   that drops nothing (E / top_k), since capacity drops depend on the
   number of tokens routed together. Under int8, nf4 and float16 each
   layer makes 4 attention projections and, in every format, 3 grouped
   expert products a phase (bfloat16's through ``bf16_matmul_grouped``,
   float16's through ``fp16_matmul_grouped``: qwen3 bf16 144 a decode
   step), each on the loop its rows choose (decode for at most 8, wgmma
   above).
6. dense: stablelm-1.6b, minitron-8b and h2o-danube-3-4b in bfloat16
   and command-r-35b in int8, at full width and depth, 4 requests of 8
   new tokens, the same checks (h2o-danube's windowed decode takes the
   paged kernel too, 24 launches a step, with the teacher-forced check,
   and a second one from a prefill of two prompts of 200 and 137 tokens
   into a ring of 128 slots, past the ring: pad slots inside it).
7. families: with the dense cells' traffic and checks, at full width and
   depth, phi-3-vision-4.2b in bfloat16 (text only, as the reference
   serves it: 32 flash launches a prefill, 32 paged a step), mamba2-2.7b
   in bfloat16 and nf4 (no attention; 2 quant launches a layer and
   phase, 128) and zamba2-1.2b in bfloat16 and int8 (the shared block at
   6 sites: 6 flash launches a prefill and 6 paged a step; 2 quant
   launches a Mamba layer and 7 a site, 118 a phase).
8. model: phi-3-vision-4.2b in bfloat16 with 576 seeded patch embeddings
   a request, and seamless-m4t-large-v2 in bfloat16 and int8 with 64
   seeded frame embeddings a request (no serving path carries frames: the
   reference's backend passes only tokens), through ``Model.prefill`` and
   ``Model.decode_step``: the dense cells' 4 prompts, two at a time,
   right-padded with ``lengths``, a prefill and 8 greedy decode steps on
   a ring that holds the prefill; the launches counted over that run
   (seamless: 72 flash launches a prefill, its encoder's 24, the
   decoder's 24 and the cross-attention's 24; 48 paged a step, self and
   cross; under int8 432 quant launches a prefill and 216 a step), and
   each request's batched prefill logits against its own prefill. Prints
   a model line of host wall times, tokens/s and peak memory.
9. arrival: llama-3.1-8b at full width and depth in bfloat16 and int8,
   12 requests of the paper's prompts (``paper_requests``: 200-4000
   tokens, outputs cut to 10-64) through ``ServeEngine`` on the
   ``ExecutedBackend`` with ``SlotCountPolicy(max_batch=8,
   max_prefill_batch=4)`` over rings of 4096 slots: bf16 in a burst,
   every 50 ms, Poisson at 20/s, the burst under
   ``PacedScheduler(rate_per_s=10)`` and the 50 ms pattern under
   ``ChunkedPrefillPolicy(chunk_tokens=1024)``; int8 in a burst and every
   50 ms (``ARRIVAL_RUNS``). Each run's launch checks count executed
   prefills (a chunk before a prompt's last runs no model); every
   request is done; its prefills, report, per-request times and energies
   and power trace equal those of the analytic engine on the same
   requests (``arrival_plan``, from which the kernel phase's cells at
   these runs' shapes are derived: ``arrival_cells``) float for float,
   and the trace covers the report's energy. The bf16 burst's and 50 ms
   run's first-token logits are held against each request's own prefill.
   Prints an arrival line a run: host wall ms per executed prefill and
   decode step, peak memory, and the analytic J/request, idle and gated
   energy and mean batch beside the analytic naive sequential
   J/request of the same requests (the idle gaps are simulated, not
   slept: no energy of this phase is measured).
10. orchestration: llama-3.1-8b at full width and depth, weights from
   seed 0, ``SlotCountPolicy(max_batch=8, max_prefill_batch=4)`` and
   rings of 4096 slots on every replica (``ORCH_RUNS``): an
   ``agent_loop`` workflow with prefix reuse (bf16) and a ``fan_out``
   one (int8) on one engine; 2-replica clusters behind ``round_robin``
   (Poisson 20/s), ``energy_aware_gated`` (every 100 ms) and
   ``least_loaded`` with the agent workflow; a crash with backoff
   retries on one engine (bf16) and of replica 1 for good on a cluster
   (int8); an MPC controller on one engine. Replicas of a run share one
   model, each with its own ``ExecutedBackend``. Each run's compared
   fields (reports, per-request records, task reports, control
   telemetry), power trace and each replica's prefill shapes must equal
   its analytic twin's (``orch_plan``: the same engines on the analytic
   backend, from which the kernel phase's cells are derived:
   ``orch_cells``) float for float; launches are checked per executed
   prefill and decode step summed over the run's backends; the fault
   runs satisfy ``check_run_invariants``; the agent run's children
   extend their parents' prompts and generations, and its first-token
   logits match each request's own prefill. Prints an orchestration
   line a run: host wall ms per executed prefill and decode step, peak
   memory, the analytic J/request with idle, gated and wasted energy,
   requests and utilisation per replica, prefix-reused tokens and task
   latencies (energies analytic: gaps and downtime are simulated).
11. api: llama-3.1-8b at full width and depth through the port's public
   surface only, with ``torch_device="cuda"`` (``API_RUNS``): one
   ``repro_torch.sweep`` over ``fmt`` in bfloat16 and int8
   (``cache=False``, ``workers=1``) of an executed spec of 8 requests
   arriving at once (prompts 200-960 tokens, outputs 8-32, 8 lanes,
   rings of 1024 slots), and the same spec as a vectorized fleet
   (``fleet="vector"``) of two executed replicas sharing one model
   behind ``round_robin``, Poisson at 20/s, through
   ``ExperimentSpec.run``. Each record must equal its analytic twin's
   (``spec.derive(backend="analytic")``, computed on the CPU too by
   ``api_plan``, from which the kernel phase's cells are derived:
   ``api_cells``) on every field but ``spec_hash``; every request
   generates its max_new_tokens ids in the vocabulary; the prefills the
   model runs and the decode steps are the twin's, with one flash launch
   a layer and prefill, one paged a layer and step and, under int8, 224
   quant launches a phase on the loop its rows choose (summed over the
   fleet's replicas). Each spec's window opens where it draws its
   weights (``repro_torch.api.executed_params``, observed by
   ``_ApiWindows``). Prints an api line a run: host wall, the weights'
   draw, peak memory and the analytic J/request (energies analytic).
12. train: the flash backward kernel
   (``flash_attention_bwd.cu``; bf16 on the TMA + wgmma passes of
   ``flash_bwd_wgmma.cuh``) against
   ``flash_attention_backward_plain`` on the forward kernel's own output
   and logsumexp (``BWD_CELLS``: stablelm-1.6b's (4, 1024) at 32/32/64,
   granite-moe-1b-a400m's 16/8/64 at (4, 1024), h2o-danube-3-4b's
   32/8/120 at (2, 1024) plain and with a window of 256, and an unmasked
   (2, 256) over 64 keys; bf16 and f32), each of dq, dk, dv within
   ``BWD_REL_TOL``, the forward's output with the logsumexp kept equal
   to its output without, three CUDA kernels a call, with the kernel,
   forward + backward, plain, SDPA forward + backward and SDPA backward
   alone times and the bound (five products); one
   train step of stablelm-1.6b cut to 2 layers at full width, B = 4,
   S = 1024, through the kernels against the same step with attention
   through the plain versions (bf16 and f32, each grad leaf within
   ``STEP_GRAD_TOL``), with ``remat=True`` (grads equal bit for bit, 2
   forward launches a layer, flash's and the fused kernels') and one
   whole f32 step; then stablelm-1.6b
   at full width and depth trained in bf16 on ``SyntheticLM`` through
   ``repro_torch.training.train`` for 20 steps (``TRAIN``) under the
   power sampler: per step the loss, grad norm, host ms and launches
   (exactly 24 flash forward and 24 backward, 49 rms_norm, 24 rope_qk
   and 24 silu_mul, nothing else: the fused kernels' backward reruns
   their plain ops), finite
   losses whose last 5 average below step 0's, peak memory and mean W;
   the trained params saved by ``save_checkpoint``, loaded by
   ``load_checkpoint`` and served (2 prompts, 8 greedy tokens, flash
   and paged) to the tokens of the params in memory; and ``python -m
   repro_torch.launch.train --arch granite-moe-1b-a400m --steps 5
   --device cuda`` as a subprocess.
13. dryrun: the launch analysis (``repro_torch.launch.dryrun``, PR 24).
   The reference's default sweep: every ARCH_IDS config at every
   INPUT_SHAPES shape (40 records) on the 16 x 16 mesh (a fake process
   group), bf16,
   every tensor on the meta device, in DRY_WORKERS spawned processes;
   one line a record (per-GPU GB = arguments + the peak of live
   intermediates, fits, bottleneck, the three roofline terms priced on
   the H100 SXM, useful-FLOP ratio, seconds), each ok with FLOPs and
   bytes counted. Then two cells the card runs, each dry-run on a
   one-rank mesh and run on the card (``_dry_cell``): stablelm-1.6b's
   train step (B 4, S 1024, remat) and llama-3.1-8b's bf16 decode
   (batch 4, a full ring of 512): the bytes of the tree the card holds
   must equal the dry run's argument bytes, the counted FLOPs be within
   2x of ``core/workload.py``'s estimate, and the step's kernel
   launches equal the dry run's kernel calls (the kernels' meta
   branches); the line prints the measured peak beside argument + temp
   and the host-wall step beside the roofline's step time. Last, one
   MoE layer of granite-moe-1b-a400m at full width (bf16, 2048 tokens)
   through ``expert_parallel`` on a one-rank NCCL group against
   ``moe_ffn``'s local path, within 1e-2 relative (``ep_check``); the
   group is destroyed before the phase ends.

After each phase from 3 on, a ``phase_wall`` line gives its host wall
and the script's so far. The line before the last holds the card's name
and power limit, the one
before it the ``kernels`` summary, and the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is visible.

Cuts: qwen3-moe-30b-a3b runs no float32 (120 GB of weights, more than
the card's 80 GB) and no float16 (it stores the same 16-bit bytes as
bfloat16; granite-moe-1b-a400m's float16 cell runs the fp16 kernels, 2-D
and grouped, end to end); the dense ARCH_IDS configs run
one format each, 4 requests of 8 new tokens; the families' cells run one
or two formats each, with the same traffic. Weights are random.
"""
from __future__ import annotations

import collections
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM3 bytes/s, bf16 tensor-core FLOP/s and
# f32 FLOP/s outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20

SHAPES_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# 1: a sequential decode step; 4: the serve phase's decode batch
# (max_batch); 8: the widest decode tile; 464: the serve phase's first
# prefill (two prompts, the longer 228 tokens rounded up to 232); 512: a
# prefill of two 256-token prompts
SHAPES_M = [1, 4, 8, 464, 512]
HEADLINE = (4, 4096, 14336)     # the serve phase's decode, w_gate
# kernel vs plain, bf16 output: both round one f32 sum to bf16 (2^-8
# relative), after summing K products in different orders
KERNEL_REL_TOL = 1e-2
FORMATS = ("float32", "float16", "bfloat16", "int8", "nf4")
# quantized projections of a llama layer: wq, wk, wv, wo, w_gate, w_up,
# w_down (the LM head stays in bf16)
QUANT_PROJECTIONS = 7
# the 2-D kernel of each format's projections: int8 and nf4's dequant
# kernels, and float16's fp16 kernel (the LM head too: the whole model is
# stored in fp16)
QUANT_ENTRY = {"int8": "int8_matmul", "nf4": "nf4_matmul",
               "float16": "fp16_matmul"}
# the grouped kernel of each format's MoE expert stacks: the quant formats'
# and the 16-bit ones' (bf16 weights as they are, float16 converted to
# bf16 in registers)
GROUPED_ENTRY = {"int8": "int8_matmul_grouped", "nf4": "nf4_matmul_grouped",
                 "float16": "fp16_matmul_grouped",
                 "bfloat16": "bf16_matmul_grouped"}
# the 16-bit expert product's reference: no Pallas kernel
REPLACES_16 = ("none: the reference's 16-bit expert product, jax.vmap of "
               "linear_apply over the experts (src/repro/models/moe.py:147 "
               "_expert_dense), jnp.einsum(x.astype(cd), w.astype(cd)) "
               "(src/repro/quant/apply.py:68-69), has no Pallas kernel")
# int8's outlier rows, the policy's (core/precision.py): 1% of K
OUTLIER_FRACTION = 0.01
# batched prefill vs the request's own prefill: the same arithmetic at
# other M and padding, so only the order of f32 sums differs; through 32
# layers that moves f32 logits by ~1e-6 of their range and 16-bit
# activations by a few bf16 ulps
PREFILL_LOGIT_TOL = {"float32": 1e-3, "float16": 5e-2, "bfloat16": 5e-2,
                     "int8": 5e-2, "nf4": 5e-2}
REPLACES = {
    "int8_matmul": "src/repro/kernels/quant_matmul/kernel.py:55",
    "fp16_matmul": "none: the reference's float16 product, "
                   "jnp.einsum(x.astype(cd), w.astype(cd)) over an fp16 "
                   "weight (src/repro/quant/apply.py:68-69), has no Pallas "
                   "kernel",
    "nf4_matmul": "src/repro/kernels/quant_matmul/kernel.py:112",
    "int8_matmul_grouped": "src/repro/kernels/quant_matmul/kernel.py:55",
    "nf4_matmul_grouped": "src/repro/kernels/quant_matmul/kernel.py:112",
    "bf16_matmul_grouped": REPLACES_16,
    "fp16_matmul_grouped": REPLACES_16,
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:71",
}
# attention kernel vs plain, row by row (one query token and head): the
# worst row's max |kernel - plain| over its max |plain|. f32 is the same
# arithmetic with sums in other orders. In bf16 p and the output are each
# rounded once to bf16: an output that lands across a rounding boundary
# is one ulp away, at most 2^-7 (0.0078) of its row's largest value, and
# p rounded against other running maxima moves a row by about 1e-3. Each
# cell also reads a control, the plain version with the mask edge moved
# by one key (the diagonal key of flash's second half of the rows, the
# last key of every paged row), which must read above the tolerance.
ATTN_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ATTN_DTYPES = ("bfloat16", "float32")
# the serve cells' grouped expert products under the reference's capacity
# dispatch (moe.py, _expert_dense), in both formats: (arch, E, C, tokens,
# K, N) of qwen3-moe-30b-a3b's w_gate/w_up and w_down at decode (C = 8
# rows an expert: 4 tokens, top 8 of 128 experts, capacity factor 1.25,
# at least 8) and at prefill (C = 40: 512 tokens), and
# granite-moe-1b-a400m's (32 experts: C = 8 and 160, two row tiles).
# quant_cells adds every other capacity the serve cells run, with the
# tokens that give it.
GROUPED_SHAPES = [("qwen3-moe-30b-a3b", 128, C, T, Kd, N)
                  for C, T in ((8, 4), (40, 512))
                  for Kd, N in ((2048, 768), (768, 2048))] \
    + [("granite-moe-1b-a400m", 32, C, T, Kd, N)
       for C, T in ((8, 4), (160, 512))
       for Kd, N in ((1024, 512), (512, 1024))]
# both MoE configs route each token to its top 8 experts
GROUPED_TOP_K = 8
HEADLINE_GROUPED = (128, 8, 2048, 768)
LLAMA_HEADS = (32, 8, 128)          # H, Kv, head_dim
QWEN_HEADS = (14, 2, 64)            # qwen2.5-0.5b
H2O_HEADS = (32, 8, 120)            # h2o-danube-3-4b: 3840 / 32
PHI3V_HEADS = (32, 32, 96)          # phi-3-vision-4.2b: 3072 / 32
QWEN3_HEADS = (32, 4, 64)           # qwen3-moe-30b-a3b
STABLELM_HEADS = (32, 32, 64)       # stablelm-1.6b (MHA)
COMMAND_R_HEADS = (64, 8, 128)      # command-r-35b
GRANITE_HEADS = (16, 8, 64)         # granite-moe-1b-a400m
SEAMLESS_HEADS = (16, 16, 64)       # seamless-m4t-large-v2 (MHA)
# zamba2-1.2b's shared block is 32/32/64, stablelm's heads
# audio frames a request of the Model runs: fixed, so that a request's
# encoder input does not depend on its batch
T_ENC = 64
# (B, S, heads, window): causal self-attention. (2, 576 + 256) at
# phi-3-vision's heads: 576 patches and a prompt of 256, 13 full key tiles
FLASH_CELLS = [(1, 81, LLAMA_HEADS, None), (2, 256, LLAMA_HEADS, None),
               (1, 2048, LLAMA_HEADS, None), (1, 2048, LLAMA_HEADS, 512),
               (2, 256, QWEN_HEADS, None), (2, 256, H2O_HEADS, None),
               (1, 4608, H2O_HEADS, 4096), (2, 256, PHI3V_HEADS, None),
               (2, 256, QWEN3_HEADS, None), (2, 256, STABLELM_HEADS, None),
               (2, 256, COMMAND_R_HEADS, None),
               (2, 256, GRANITE_HEADS, None),
               (2, 256, SEAMLESS_HEADS, None),
               (2, 576 + 256, PHI3V_HEADS, None)]
# 261: the sequential path's ring for a 228-token prompt (one page);
# 512: the serve phase's buf_len; 4096: a long context. (B, W, heads)
PAGED_CELLS = [(B, W, LLAMA_HEADS) for B in (1, 4, 8)
               for W in (261, 512, 4096)] \
    + [(4, 512, h) for h in (H2O_HEADS, PHI3V_HEADS, QWEN3_HEADS,
                             STABLELM_HEADS, COMMAND_R_HEADS,
                             GRANITE_HEADS, SEAMLESS_HEADS)]
# the Model runs' attention calls join these at the shapes they run:
# model_attention_cells
# the card's power draw in W, one line every 100 ms, over the serve runs
POWER_SAMPLER = ["nvidia-smi", "--query-gpu=power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"]
# the cells the kernels line reports: the serve phase's prefill of two
# prompts and its decode batch over its 512-slot ring
# where the headline (bf16) kernel of each attention module lives
ATTN_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_wgmma.cuh",
    "paged_attention": "src/repro_torch/kernels/paged_attention/csrc/"
                       "paged_attention.cu",
}
# calls of the attention plain versions timed a round (3 rounds after a
# warm-up): their slowest calls (flash at S = 4608, paged over 4096 slots)
# take 0.05-0.2 s each, 70 s of a run at 3 a round; they repeat the
# kernels' arithmetic and are no yardstick of speed
PLAIN_REPS = 1
# the paged kernel's optional parts, reported as their own rows of the
# kernels line (PERF.md section 6)
PAGED_ROWS = {"int8_pages": "3q", "slot_positions": "3m"}
HEADLINE_ATTN = {
    "flash_attention": {"dtype": "bfloat16", "B": 2, "S": 256, "H": 32,
                        "d": 128, "window": None},
    "paged_attention": {"dtype": "bfloat16", "B": 4, "W": 512, "d": 128,
                        "case": "base"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, arg_sets, reps: int = 10,
             graph: bool = True) -> float:
    """Device time of ``fn`` per call, over 3 * ``reps`` calls cycling
    through ``arg_sets`` (so that consecutive calls read different
    weights), between CUDA events. With ``graph`` the calls are captured
    in a CUDA graph and replayed, which takes the host's launch cost out
    of the reading; the plain versions copy the codebook from the host,
    which a capture refuses, and are timed from eager launches."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(3):
        if graph:
            g.replay()
        else:
            for i in range(reps):
                fn(*arg_sets[(r * reps + i) % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def serve_projections(cfg) -> list:
    """(K, N) of each 2-D projection a layer of ``cfg`` quantizes: wq,
    wk and wv, wo, and for a dense layer w_gate and w_up, w_down (an MoE
    layer's experts take the grouped launch; an audio layer's
    cross-attention and its encoder's layers have the same shapes); a
    Mamba layer's w_in and w_out, and for hybrid the shared block's."""
    D = cfg.d_model
    kn = []
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.ssm import ssm_dims
        dims = ssm_dims(cfg)
        kn += [(D, dims["d_in_proj"]), (dims["d_inner"], D)]
    if not cfg.has_attention:
        return kn
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    kn += [(D, q), (D, kv), (q, D)]
    if not cfg.is_moe:
        kn += [(D, cfg.d_ff), (cfg.d_ff, D)]
    return kn


def served_rows(configs) -> list:
    """(arch, formats, traffic or None, rows) of every run: the rows of x
    its layers take (a token a row): each SERVE_CELLS config at 1 row (a
    sequential decode step), max_batch rows (a continuous one) and
    max_prefill_batch times the longest prompt (a batched prefill); each
    MODEL_CELLS config at the rows its run gives them
    (:func:`model_prefills`: each prefill's rows times its padded length,
    stubs included, an audio encoder's rows times T_ENC, and a decoded
    pair's rows); the arrival, orchestration and api runs' rows
    (:func:`arrival_cells`, :func:`orch_cells`, :func:`api_cells`), by
    format."""
    cells = [(arch, formats, kw, [1, kw["max_batch"],
                                  kw["max_prefill_batch"]
                                  * kw["prompt_len"][1]])
             for arch, formats, kw in SERVE_CELLS]
    for arch, formats in MODEL_CELLS:
        runs = model_prefills(configs[arch])
        audio = configs[arch].family == "audio"
        rows = sorted({B * (prefix + pad) for B, pad, prefix, _, _ in runs}
                      | {B * T_ENC for B, *_ in runs if audio}
                      | {B for B, *_, decoded in runs if decoded})
        cells.append((arch, formats, None, rows))
    for fmt, rows in arrival_cells()[2].items():
        cells.append((ARRIVAL_ARCH, (fmt,), None, sorted(rows)))
    for fmt, rows in orch_cells()[2].items():
        cells.append((ORCH_ARCH, (fmt,), None, sorted(rows)))
    for fmt, rows in api_cells()[2].items():
        cells.append((API_BASE["model"], (fmt,), None, sorted(rows)))
    return cells


def quant_cells(configs) -> tuple:
    """The quant kernel calls of the kernel phase: llama-3.1-8b's
    SHAPES_KN x SHAPES_M, GROUPED_SHAPES through every grouped entry point
    (GROUPED_ENTRY), and the calls
    every SERVE_CELLS
    config makes in each quantized format it serves: its 2-D projections
    at 1 row (a sequential decode step), max_batch rows (a continuous
    one) and max_prefill_batch times the longest prompt (a batched
    prefill); every MODEL_CELLS config's at the rows its run gives them
    (:func:`model_prefills`: each prefill's rows times its padded length,
    stubs included, an audio encoder's rows times T_ENC, and a decoded
    pair's rows); llama-3.1-8b's at the rows of each quantized arrival
    run (:func:`arrival_cells`) and orchestration run
    (:func:`orch_cells`); under float16 the fp16 kernel's calls at the
    same rows, and the LM head at a step's lanes and a prefill's rows;
    and for MoE its grouped expert products in the format's grouped entry
    point (bfloat16's and float16's too)
    (E, C, K, N) at the
    capacity C of a decode step, a request's own prefill and a batched
    prefill, under the config's capacity factor and the no-drop one (E /
    top_k) of the logit pair (the rows: :func:`served_rows`). ``configs``
    maps an arch to its config.
    Returns ({(name, K, N): {M: [arch, ...]}}, {(name, E, K, N): {C:
    {arch: tokens routed}}})."""
    from repro_torch.models.moe import expert_capacity
    two_d, grouped = {}, {}

    def add(table, key, rows, arch):
        for r in rows:
            table.setdefault(key, {}).setdefault(r, [])
            if arch not in table[key][r]:
                table[key][r].append(arch)

    for Kd, N in SHAPES_KN:
        for name in QUANT_ENTRY.values():
            add(two_d, (name, Kd, N), SHAPES_M, "llama-3.1-8b")
    def add_grouped(key, C, arch, tokens):
        grouped.setdefault(key, {}).setdefault(C, {}).setdefault(arch,
                                                                 tokens)

    for arch, E, C, T, Kd, N in GROUPED_SHAPES:
        for entry in GROUPED_ENTRY.values():
            add_grouped((entry, E, Kd, N), C, arch, T)
    for arch, formats, kw, rows in served_rows(configs):
        cfg = configs[arch]
        for fmt in formats:
            name = QUANT_ENTRY.get(fmt)
            if name is not None:
                for Kd, N in serve_projections(cfg):
                    add(two_d, (name, Kd, N), rows, arch)
            if name is not None and fmt == "float16":
                # the LM head at a decode step's lanes and a prefill's
                # rows (its last tokens only)
                add(two_d, (name, cfg.d_model, cfg.vocab_size),
                    [1, kw["max_prefill_batch"], kw["max_batch"]], arch)
            entry = GROUPED_ENTRY.get(fmt)
            if not cfg.is_moe or entry is None:
                continue
            batched = kw["max_prefill_batch"] * kw["prompt_len"][1]
            E, k = cfg.num_experts, cfg.experts_per_token
            assert k == GROUPED_TOP_K, arch
            for T in (kw["max_batch"], kw["prompt_len"][1], batched):
                for cf in (cfg.moe_capacity_factor, E / k):
                    C = expert_capacity(T, E, k, cf)
                    for Kd, N in ((cfg.d_model, cfg.d_ff),
                                  (cfg.d_ff, cfg.d_model)):
                        add_grouped((entry, E, Kd, N), C, arch, T)
    return two_d, grouped


def _quantized(torch, name, w, bf16):
    """(kernel weight args, bytes, the weight dequantized to bf16, outlier
    rows) of a float weight (K, N) or (E, K, N) in the format of the entry
    point ``name``: int8's with the policy's outliers (codes, scale,
    outlier rows, their bf16 weights), nf4's, fp16's (the weight in
    float16) and bf16's (the weight in bf16)."""
    from repro_torch.quant.int8 import dequantize_int8, quantize_int8
    from repro_torch.quant.nf4 import dequantize_nf4, quantize_nf4
    *E, Kd, N = w.shape
    n = math.prod(E)
    if name.startswith("int8"):
        q = quantize_int8(w, OUTLIER_FRACTION)
        n_out = q.outlier_idx.shape[-1]
        return (tuple(q), n * (Kd * N + 4 * N + 4 * n_out + 2 * n_out * N),
                dequantize_int8(q, bf16), n_out)
    if name.startswith("fp16"):
        w16 = w.half()
        return (w16,), n * 2 * Kd * N, w16.to(bf16), 0
    if name.startswith("bf16"):
        wb = w.to(bf16)
        return (wb,), n * 2 * Kd * N, wb, 0
    q = quantize_nf4(w, 64)
    return ((q.packed, q.absmax), n * (Kd * N // 2 + 4 * (Kd // 64) * N),
            dequantize_nf4(q, bf16), 0)


def quant_calls(K, name, grouped=False):
    """(kernel, plain version) of the quant entry point ``name``, each as
    ``f(x, wargs, cd, rows=None)`` over :func:`_quantized`'s weight args
    (int8's outliers go in as the keywords the two take)."""
    kern = getattr(K, name + ("_grouped" if grouped else ""))
    plain = getattr(K, name + "_plain")
    if name == "int8_matmul":
        def k_call(x, w, cd, rows=None):
            if grouped:
                return kern(x, w[0], w[1], cd, rows, w[2], w[3])
            return kern(x, w[0], w[1], cd, w[2], w[3])

        def p_call(x, w, cd, rows=None):
            return plain(x, w[0], w[1], cd, rows, w[2], w[3])
        return k_call, p_call
    if grouped:
        return (lambda x, w, cd, rows=None: kern(x, *w, cd, rows),
                lambda x, w, cd, rows=None: plain(x, *w, cd, rows))
    return (lambda x, w, cd, rows=None: kern(x, *w, cd),
            lambda x, w, cd, rows=None: plain(x, *w, cd))


def separate_product(torch, K, x, w, cd):
    """The parent's int8 path at one call, for its time: the kernel
    without outliers, then x's outlier columns, an f32 product, a
    rounding and an add (7 kernels)."""
    out = K.int8_matmul(x, w[0], w[1], cd)
    x_out = torch.index_select(x, -1, w[2].long())
    return out + torch.matmul(x_out.float(), w[3].to(cd).float()).to(cd)


def kernel_phase(torch, K, cells):
    """The quant kernels' 2-D calls at ``cells`` (:func:`quant_cells`)
    against their plain versions, bf16, each row naming the loop that ran
    and the serve cells that make the call: int8 with the policy's
    outliers (``n_out`` rows; ``separate_ms``, the parent's path at the
    call: the kernel without them and the separate product,
    :func:`separate_product`), nf4, and fp16 with two library times
    (``library_ms``: ``torch.matmul`` on a bf16 copy of the weight, the
    product alone; ``library_cast_ms``: ``torch.matmul(x,
    w.to(bfloat16))``, the conversion included, the expression the kernel
    replaced)."""
    from repro_torch.kernels import cost
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {name: [] for name in QUANT_ENTRY.values()}
    for (name, Kd, N), ms in cells.items():
        w = torch.randn((Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        wargs, wbytes, wdeq, n_out = _quantized(torch, name, w, bf16)
        del w
        kern, plain = quant_calls(K, name)
        wsets = [wargs] + [tuple(t.clone() for t in wargs)
                           for _ in range(_copies(wbytes) - 1)]
        lsets = [wdeq] + [wdeq.clone()
                          for _ in range(_copies(2 * Kd * N) - 1)]
        for M in sorted(ms):
            x = torch.randn((M, Kd), generator=gen, device="cuda").to(bf16)
            before = dict(K.LOOP_LAUNCHES[name])
            got = kern(x, wargs, bf16)
            loop = next(lp for lp, n in K.LOOP_LAUNCHES[name].items()
                        if n != before[lp])
            launched = (check_one_launch(
                torch, name, lambda: kern(x, wargs, bf16))
                if (M, Kd, N) == HEADLINE else None)
            ref = plain(x, wargs, bf16)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            k_ms = timed_ms(torch, lambda *a: kern(x, a, bf16), wsets)
            p_ms = timed_ms(torch, lambda *a: plain(x, a, bf16), [wargs],
                            reps=3, graph=False)
            l_ms = timed_ms(torch, lambda w_: torch.matmul(x, w_),
                            [(t,) for t in lsets])
            nbytes, flops = cost.quant_matmul(M, Kd, N, wbytes, n_out=n_out)
            bound, by = _bound(nbytes, flops, "bfloat16")
            row = {"phase": "kernel", "name": name, "M": M, "K": Kd,
                   "N": N, "serves": ms[M], "loop": loop,
                   "max_abs_err": diff, "max_rel_err": rel,
                   "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms,
                   "bytes": nbytes, "flops": flops, "bound_ms": bound,
                   "bound_by": by, "cuda_launches_per_call": launched}
            if name == "int8_matmul":
                row["n_out"] = n_out
                row["separate_ms"] = timed_ms(
                    torch, lambda *a: separate_product(torch, K, x, a, bf16),
                    wsets)
            if name == "fp16_matmul":
                row["library_cast_ms"] = timed_ms(
                    torch, lambda w_: torch.matmul(x, w_.to(bf16)), wsets)
            emit(row)
            if not rel <= KERNEL_REL_TOL:
                raise SystemExit(f"{name} disagrees with its plain "
                                 f"version at M={M} K={Kd} N={N}: "
                                 f"rel {rel} > {KERNEL_REL_TOL}")
            rows[name].append(row)
            del x, got, ref
        del wargs, wdeq, wsets, lsets
        torch.cuda.empty_cache()
    return rows


def dispatch_rows(torch, E: int, C: int, tokens: int, seed: int):
    """Each expert's kept rows (int32 (E,) on the card) of a seeded top-8
    routing of ``tokens`` tokens through the port's capacity dispatch
    (``models/moe.py::_dispatch``), as an MoE layer hands them to its
    grouped products."""
    from repro_torch.models.moe import _dispatch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((tokens, 256), generator=gen, device="cuda")
    w_router = torch.randn((256, E), generator=gen, device="cuda")
    return _dispatch(x, w_router, GROUPED_TOP_K, E, C)[1][-1]


def kept_rows_cost(cost, E: int, C: int, K: int, N: int, active_bytes: int,
                   kept: int, n_out: int = 0) -> tuple:
    """(bytes, FLOPs) of a grouped call that computes only ``kept`` rows of
    the active experts (their weights ``active_bytes``, int8's outliers
    included): each kept row of x read and its products, int8's outlier
    product too (``kernels/cost.py::quant_matmul`` with a row a problem),
    and the whole (E, C, N) output written, its zero rows included."""
    nbytes, flops = cost.quant_matmul(1, K, N, active_bytes, 2, kept,
                                      *((n_out,) if n_out else ()))
    return nbytes + 2 * (E * C - kept) * N, flops


def _grouped_occupancy(torch, K, entry, x, wargs, rows, bf16, wbytes):
    """Case (b) or (c) of a grouped cell: the kernel with ``rows`` against
    the plain version with them; its rows past the counts must be exact
    zeros (x's rows there are zero, as the dispatch leaves them). Returns
    (output, max abs error, max rel error, active experts, the active
    experts' weight bytes)."""
    E, C, _ = x.shape
    kern, plain = quant_calls(K, entry.replace("_grouped", ""), True)
    got = kern(x, wargs, bf16, rows)
    ref = plain(x, wargs, bf16, rows)
    torch.cuda.synchronize()
    past = torch.arange(C, device="cuda") >= rows[:, None]
    if got[past].view(torch.int16).any():
        raise SystemExit(f"{entry}: rows past the counts are not zero")
    diff = (got.float() - ref.float()).abs().max().item()
    rel = diff / max(ref.float().abs().max().item(), 1e-30)
    active = int((rows > 0).sum())
    return got, diff, rel, active, wbytes * active // E


def _check_alone(torch, K, entry, x, wargs, rows, bf16, got) -> int:
    """The first expert the dispatch keeps gets the same bits alone, among
    the dispatch's experts (``got``) and with rows=None. Returns it."""
    e = int(torch.nonzero(rows)[0])
    r = int(rows[e])
    alone = torch.zeros_like(rows)
    alone[e] = r
    kern, _ = quant_calls(K, entry.replace("_grouped", ""), True)
    for other in (kern(x, wargs, bf16, alone), kern(x, wargs, bf16)):
        if not torch.equal(other[e, :r], got[e, :r]):
            raise SystemExit(f"{entry}: expert {e}'s kept rows depend on "
                             f"the other experts' counts")
    return e


def grouped_phase(torch, K, cells):
    """The grouped launch of every grouped entry point (GROUPED_ENTRY: the
    int8 and nf4 kernels, and the bf16 and fp16 kernels of 16-bit expert
    stacks; all E experts of an MoE projection in one launch) against its
    plain grouped version at ``cells`` (:func:`quant_cells`), bf16, in
    three cases: (a) every row
    kept (random x, rows=None: the worst case, timed); (b) the kept rows
    of a seeded top-8 routing of the cell's tokens through the port's
    dispatch (:func:`dispatch_rows`; x zero past the counts; timed, with
    its bound over the active experts' weights beside the all-expert
    one, which counts the kept rows' reads and products and the whole
    output written: :func:`kept_rows_cost`); (c) no expert kept
    (checked). Past the counts the output must
    be exact zeros; the first kept expert's rows the same bits alone,
    among the dispatch's experts and with rows=None; each call one kernel
    node. Two yardsticks at (a): ``torch.bmm`` on the weights already
    dequantized to bf16 (less work: no dequantization; for bf16 weights
    the product the kernel replaced, every expert read), and a Python
    loop of the 2-D kernel over the experts, timed from eager launches
    (what E launches cost the host; bf16 weights have no 2-D kernel).
    int8 runs with each expert's outliers (the policy's 1%), and its row
    adds ``separate_ms``: the kernel without them and the parent's
    batched gather and f32 product over every row; fp16's adds
    ``library_cast_ms``, ``torch.bmm(x, w.to(bfloat16))``, the product it
    replaced. Ends with :func:`moe_layer_rows_check`."""
    from repro_torch.kernels import cost
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows_out = {entry: [] for entry in GROUPED_ENTRY.values()}
    for (entry, E, Kd, N), cs in cells.items():
        name = entry.replace("_grouped", "")
        w = torch.randn((E, Kd, N), generator=gen, device="cuda") * Kd ** -0.5
        wargs, wbytes, wdeq, n_out = _quantized(torch, name, w, bf16)
        del w
        kern, plain = quant_calls(K, name, True)
        two_d = quant_calls(K, name)[0] if hasattr(K, name) else None
        wsets = [wargs] + [tuple(t.clone() for t in wargs)
                           for _ in range(_copies(wbytes) - 1)]
        lsets = [(wdeq,)] + [(wdeq.clone(),)
                             for _ in range(_copies(2 * E * Kd * N) - 1)]
        for C in sorted(cs):
            tokens = min(cs[C].values())
            x = torch.randn((E, C, Kd), generator=gen,
                            device="cuda").to(bf16)
            before = dict(K.LOOP_LAUNCHES[entry])
            got = kern(x, wargs, bf16)
            loop = next(lp for lp, n in K.LOOP_LAUNCHES[entry].items()
                        if n != before[lp])
            launched = check_one_launch(torch, entry,
                                        lambda: kern(x, wargs, bf16))
            ref = plain(x, wargs, bf16)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            del got, ref

            def loop_2d(*a):
                for e in range(E):
                    two_d(x[e], tuple(t[e] for t in a), bf16)

            def separate(*a):
                out = K.int8_matmul_grouped(x, a[0], a[1], bf16)
                cols = a[2].long()[:, None, :].expand(E, C, n_out)
                return out + torch.bmm(torch.gather(x, 2, cols).float(),
                                       a[3].to(bf16).float()).to(bf16)

            k_ms = timed_ms(torch, lambda *a: kern(x, a, bf16), wsets)
            p_ms = timed_ms(torch, lambda *a: plain(x, a, bf16), [wargs],
                            reps=3, graph=False)
            l_ms = timed_ms(torch, lambda w_: torch.bmm(x, w_), lsets)
            loop_ms = (timed_ms(torch, loop_2d, wsets, reps=3, graph=False)
                       if two_d else None)
            sep_ms = (timed_ms(torch, separate, wsets)
                      if name == "int8_matmul" else None)
            cast_ms = (timed_ms(torch, lambda w_: torch.bmm(x, w_.to(bf16)),
                                wsets) if name == "fp16_matmul" else None)
            nbytes, flops = cost.quant_matmul(C, Kd, N, wbytes, 2, E, n_out)
            bound, by = _bound(nbytes, flops, "bfloat16")

            # (b) the dispatch's counts, x zero past them
            rows = dispatch_rows(torch, E, C, tokens, seed=E + C)
            xb = x * (torch.arange(C, device="cuda")
                      < rows[:, None])[..., None].to(bf16)
            got_b, diff_b, rel_b, active, abytes = _grouped_occupancy(
                torch, K, entry, xb, wargs, rows, bf16, wbytes)
            _check_alone(torch, K, entry, xb, wargs, rows, bf16, got_b)
            check_one_launch(torch, entry,
                             lambda: kern(xb, wargs, bf16, rows))
            del got_b
            kb_ms = timed_ms(torch, lambda *a: kern(xb, a, bf16, rows),
                             wsets)
            nbytes_b, flops_b = kept_rows_cost(cost, E, C, Kd, N, abytes,
                                               int(rows.sum()), n_out)
            bound_b, by_b = _bound(nbytes_b, flops_b, "bfloat16")
            # (c) no expert kept
            none = torch.zeros_like(rows)
            got_c, *_ = _grouped_occupancy(torch, K, entry, x, wargs, none,
                                           bf16, wbytes)
            if got_c.view(torch.int16).any():
                raise SystemExit(f"{entry}: a call with no kept row wrote "
                                 f"a non-zero")
            del got_c, xb

            row = {"phase": "kernel", "name": entry, "E": E, "C": C,
                   "K": Kd, "N": N, "serves": sorted(cs[C]), "loop": loop,
                   "max_abs_err": max(diff, diff_b),
                   "max_rel_err": max(rel, rel_b),
                   "rel_tol": KERNEL_REL_TOL, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms,
                   "loop_of_2d_calls_ms": loop_ms, "n_out": n_out,
                   "separate_ms": sep_ms, "library_cast_ms": cast_ms,
                   "bytes": nbytes,
                   "flops": flops, "bound_ms": bound, "bound_by": by,
                   "cuda_launches_per_call": launched,
                   "dispatch": {"tokens": tokens, "active_experts": active,
                                "kept_rows": int(rows.sum()),
                                "rel_err": rel_b, "kernel_ms": kb_ms,
                                "bytes": nbytes_b, "bound_ms": bound_b,
                                "bound_by": by_b},
                   "none_kept": "zeros"}
            emit(row)
            for case, r in (("every row", rel), ("dispatch", rel_b)):
                if not r <= KERNEL_REL_TOL:
                    raise SystemExit(
                        f"{entry} disagrees with its plain version at E={E}"
                        f" C={C} K={Kd} N={N} ({case}): rel {r} > "
                        f"{KERNEL_REL_TOL}")
            rows_out[entry].append(row)
            del x
        del wargs, wdeq, wsets, lsets
        torch.cuda.empty_cache()
    emit(moe_layer_rows_check(torch, K))
    return rows_out


def moe_layer_rows_check(torch, K) -> dict:
    """One qwen3-moe-30b-a3b MoE layer (``moe_ffn``) at full width (d 2048,
    128 experts of d_ff 768, top 8), weights from seed 5, in int8, nf4 and
    bfloat16 (the experts cast to bf16: the bf16 grouped kernel), at the
    serve cells' batch-4 decode: the output with the dispatch's
    counts (the path the serve cells run, one grouped launch a product)
    must equal, bit for bit, the output with every expert's grouped
    products given rows=None."""
    from repro_torch.core.precision import make_policy
    from repro_torch.launch.serve import arch_config
    from repro_torch.models import moe
    from repro_torch.quant.apply import quantize_params
    cfg = arch_config("qwen3-moe-30b-a3b")
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = {"w_router": torch.randn((D, E), generator=gen, device="cuda")
         * D ** -0.5}
    for key, (i, o) in (("experts_gate", (D, Fd)), ("experts_up", (D, Fd)),
                        ("experts_down", (Fd, D))):
        p[key] = torch.randn((E, i, o), generator=gen, device="cuda") \
            * i ** -0.5
    x = torch.randn((4, D), generator=gen, device="cuda").to(torch.bfloat16)
    out = {"phase": "kernel", "check": "moe_layer_rows",
           "arch": "qwen3-moe-30b-a3b", "tokens": 4}
    dense = moe._expert_dense
    for fmt in ("int8", "nf4", "bfloat16"):
        pol = make_policy(fmt)
        q = quantize_params(p, pol) if fmt != "bfloat16" else {
            k: v.to(torch.bfloat16) for k, v in p.items()}
        entry = GROUPED_ENTRY[fmt]
        before = K.LAUNCHES[entry]
        with torch.no_grad():
            y_rows, _ = moe.moe_ffn(q, x, top_k=cfg.experts_per_token,
                                    policy=pol)
            try:
                moe._expert_dense = (lambda w, x_, policy, rows=None:
                                     dense(w, x_, policy))
                y_none, _ = moe.moe_ffn(q, x, top_k=cfg.experts_per_token,
                                        policy=pol)
            finally:
                moe._expert_dense = dense
        torch.cuda.synchronize()
        if K.LAUNCHES[entry] - before != 6:
            raise SystemExit(f"moe layer {fmt}: {K.LAUNCHES[entry] - before}"
                             f" grouped launches, expected 6")
        same = torch.equal(y_rows, y_none)
        out[fmt] = {"bit_identical": same,
                    "max_abs": (y_rows.float() - y_none.float()).abs().max()
                    .item()}
        if not same:
            raise SystemExit(f"moe layer {fmt}: the output with the "
                             f"dispatch's counts differs from rows=None")
        del q
    del p
    torch.cuda.empty_cache()
    return out


def _model_geometry(cfg, lens) -> tuple:
    """(padded prompt length, stub prefix, ring length) of a Model run's
    prefill of prompts of ``lens`` tokens: right-padded to a multiple of
    8, the patches (vlm) in front, and a ring of the padded length (stubs
    included) plus 9 slots rounded up to 64, so that the prefill stays
    within the ring."""
    pad = -(-max(lens) // 8) * 8
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    return pad, prefix, -(-(prefix + pad + 9) // 64) * 64


def model_prefills(cfg) -> list:
    """(rows, padded length, stub prefix, ring length, decoded) of each
    prefill a MODEL_CELLS run of ``cfg`` makes: MODEL_TRAFFIC's prompts
    MODEL_PAIR at a time, each pair then decoded, and each prompt on its
    own (the logit check; not decoded)."""
    from repro_torch.launch.serve import make_requests
    kw = MODEL_TRAFFIC
    lens = [r.prompt_len for r in make_requests(
        cfg.vocab_size, kw["n"], kw["seed"], kw["prompt_len"],
        kw["new_tokens"])]
    pairs = [lens[i:i + MODEL_PAIR] for i in range(0, len(lens),
                                                   MODEL_PAIR)]
    return [(len(g), *_model_geometry(cfg, g), decoded)
            for groups, decoded in ((pairs, True), ([[n] for n in lens],
                                                    False))
            for g in groups]


def model_attention_cells(configs) -> tuple:
    """Every attention call of the MODEL_CELLS runs at the shape it runs
    (:func:`model_prefills`): flash, causal, over each prefill (B, prefix
    + pad) and, for audio, unmasked over its encoder (B, T_ENC over
    T_ENC) and its cross-attention (B, pad over T_ENC); paged over each
    decoded pair's ring (B, ring) and, for audio, over the encoder K/V of
    its cross-attention (B, T_ENC). Returns (causal, unmasked, paged)
    cells, laid out as FLASH_CELLS' (B, S, heads, window), (B, S, T,
    heads) and PAGED_CELLS' (B, W, heads)."""
    causal, full, paged = [], [], []
    for arch, _ in MODEL_CELLS:
        cfg = configs[arch]
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        audio = cfg.family == "audio"
        for B, pad, prefix, ring, decoded in model_prefills(cfg):
            causal.append((B, prefix + pad, heads, cfg.sliding_window))
            if audio:
                full += [(B, T_ENC, T_ENC, heads), (B, pad, T_ENC, heads)]
            if decoded:
                paged += [(B, ring, heads)] + ([(B, T_ENC, heads)]
                                               if audio else [])
    return causal, full, paged


def attention_cells(configs) -> tuple:
    """(causal flash, unmasked flash, paged) cells of the attention
    phases: FLASH_CELLS and PAGED_CELLS, the Model runs' calls
    (:func:`model_attention_cells`), the arrival runs'
    (:func:`arrival_cells`) and the orchestration runs'
    (:func:`orch_cells`), each cell once."""
    causal, full, paged = model_attention_cells(configs)
    a_causal, a_paged, _ = arrival_cells()
    o_causal, o_paged, _ = orch_cells()
    x_causal, x_paged, _ = api_cells()
    return tuple(list(dict.fromkeys(fixed + extra))
                 for fixed, extra in zip(
                     (FLASH_CELLS, [], PAGED_CELLS),
                     (causal + a_causal + o_causal + x_causal, full,
                      paged + a_paged + o_paged + x_paged)))


def check_attention_cells(configs, cells) -> None:
    """Fail unless the heads (H, Kv, head_dim) of every SERVE_CELLS
    config with attention are among the causal flash ``cells``' and the
    paged ones' (where each paged cell also runs over int8 pages and the
    position test). An attention-free config needs none. (The Model runs'
    calls are among the cells at their own shapes:
    :func:`model_attention_cells`.)"""
    flash = {h for _, _, h, _ in cells[0]}
    paged = {h for _, _, h in cells[2]}
    for arch, *_ in SERVE_CELLS:
        cfg = configs[arch]
        if not cfg.has_attention:
            continue
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        if heads not in flash or heads not in paged:
            raise SystemExit(f"{arch}: its heads {heads} are missing from "
                             f"the attention cells")


def _bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _copies(nbytes: int) -> int:
    """Input sets to cycle through so that the timed calls read more than
    the L2 holds."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / nbytes)))


def _node_types(g) -> tuple:
    """(the driver, the nodes, their types: 0 a kernel) of a captured
    ``torch.cuda.CUDAGraph`` kept with ``keep_graph=True``, read through
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise SystemExit("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        raise SystemExit("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise SystemExit("cuGraphNodeGetType failed")
        types.append(t.value)
    return cu, list(nodes), types


def graph_nodes(torch, fn) -> list:
    """The node types (0: a kernel) of a CUDA graph that captures one call
    of ``fn`` after a warm-up call: every launch the call makes."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    types = _node_types(g)[2]
    g.reset()
    return types


def graph_kernel_names(g) -> list:
    """The function name of every kernel node of a captured CUDA graph
    (``cuGraphKernelNodeGetParams``, ``cuFuncGetName``), mangled as the
    compiler left it."""
    import ctypes

    class Params(ctypes.Structure):          # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    ("dims", ctypes.c_uint * 7),    # grid, block, smem
                    ("kernel_params", ctypes.c_void_p),
                    ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu, nodes, types = _node_types(g)
    names = []
    for node, t in zip(nodes, types):
        if t != 0:
            continue
        p = Params()
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            ctypes.byref(p)):
            raise SystemExit("cuGraphKernelNodeGetParams failed")
        func = ctypes.c_void_p(p.func)
        if not p.func and p.kern and cu.cuKernelGetFunction(
                ctypes.byref(func), ctypes.c_void_p(p.kern)):
            raise SystemExit("cuKernelGetFunction failed")
        name = ctypes.c_char_p()
        if cu.cuFuncGetName(ctypes.byref(name), func):
            raise SystemExit("cuFuncGetName failed")
        names.append(name.value.decode())
    return names


def check_one_launch(torch, name, fn) -> int:
    """Fail unless one call of ``fn`` is exactly one CUDA kernel launch
    (and nothing else: no copy or memset)."""
    types = graph_nodes(torch, fn)
    if types != [0]:
        raise SystemExit(f"{name}: one call captured the graph nodes "
                         f"{types}, expected one kernel [0]")
    return len(types)


def row_rel_err(got, ref) -> float:
    """Worst row, over the last axis: max |got - ref| / max |ref|."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _attn_row(torch, name, dtype, got, ref, control, lib, times, nbytes,
              flops, launched, **shape):
    rel = row_rel_err(got, ref)
    bound, by = _bound(nbytes, flops, dtype)
    tol = ATTN_REL_TOL[dtype]
    row = {"phase": "kernel", "name": name, "dtype": dtype, **shape,
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "max_rel_err": rel, "rel_tol": tol, "control_rel_err": control,
           "library_max_abs_err": (lib.float() - ref.float()).abs().max()
           .item(),
           "kernel_ms": times[0], "plain_ms": times[1],
           "library_ms": times[2], "bytes": nbytes, "flops": flops,
           "bound_ms": bound, "bound_by": by,
           "cuda_launches_per_call": launched}
    emit(row)
    row["fault"] = (
        f"{name} disagrees with its plain version at {dtype} {shape}: "
        f"rel {rel} > {tol}" if not rel <= tol else
        f"{name} at {dtype} {shape}: the control reads {control} <= {tol}, "
        f"so the check cannot see a one-key error" if not control > tol
        else None)
    return row


def _raise_faults(rows) -> None:
    faults = [r.pop("fault") for r in rows]
    if any(faults):
        raise SystemExit("\n".join(f for f in faults if f))


def flash_phase(torch, FK, causal_cells, full_cells):
    """Flash attention against its plain version at ``causal_cells``
    (S = T, laid out as FLASH_CELLS) and ``full_cells`` (no mask, S
    queries over T keys; (B, S, T, heads)); the
    library time is scaled_dot_product_attention on the same q, k, v laid
    out (B, H, S, d) beforehand, causal (with the window as a boolean
    mask) or unmasked."""
    from repro_torch.kernels import cost
    from repro_torch.models.layers import attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(2)
    cells = [(B, S, S, h, w, True) for B, S, h, w in causal_cells] \
        + [(B, S, T, h, None, False) for B, S, T, h in full_cells]
    rows = []
    for dtype in ATTN_DTYPES:
        td = getattr(torch, dtype)
        es = torch.finfo(td).bits // 8
        for B, S, T, (H, Kv, d), window, causal in cells:
            nbytes = cost.flash_attention(B, S, T, H, Kv, d, 0, es)[0]
            sets = [tuple(torch.randn(shape, generator=gen,
                                      device="cuda").to(td)
                          for shape in ((B, S, H, d), (B, T, Kv, d),
                                        (B, T, Kv, d)))
                    for _ in range(_copies(nbytes))]
            q, k, v = sets[0]
            kw = dict(causal=causal, window=window)
            got = FK.flash_attention(q, k, v, **kw)
            launched = check_one_launch(
                torch, "flash_attention",
                lambda: FK.flash_attention(q, k, v, **kw))
            ref = FK.flash_attention_plain(q, k, v, **kw)
            qpos = torch.arange(S, device="cuda")
            kpos = torch.arange(T, device="cuda")
            if causal:
                allow = kpos[None, :] <= qpos[:, None]
                if window is not None:
                    allow &= kpos[None, :] > qpos[:, None] - window
                # control: the plain attention without each row's
                # diagonal key, over the second half of the rows
                strict = kpos[None, :] < qpos[:, None]
                ctrl = attention(q, k, v, window=window, mask=strict[None],
                                 causal=True)
                control = row_rel_err(ctrl[:, S // 2:], ref[:, S // 2:])
                lkw = (dict(is_causal=True) if window is None
                       else dict(attn_mask=allow))
            else:
                allow = torch.ones((S, T), dtype=torch.bool, device="cuda")
                # control: the plain attention without the last key
                ctrl = attention(q, k, v, mask=(kpos < T - 1)[None, None]
                                 .expand(1, S, T))
                control = row_rel_err(ctrl, ref)
                lkw = {}
            pairs = int(allow.sum())
            want = cost.attention_pairs(S, T, causal, window)
            if pairs != want:
                raise SystemExit(f"flash_attention at {(S, T, window)}: "
                                 f"{pairs} pairs, the cost formula's "
                                 f"{want}")
            del ctrl
            lsets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                     for st in sets]

            def lib_fn(q_, k_, v_):
                return sdpa(q_, k_, v_, enable_gqa=True, **lkw)

            lib = lib_fn(*lsets[0]).transpose(1, 2)
            torch.cuda.synchronize()
            times = (
                timed_ms(torch, lambda *a: FK.flash_attention(*a, **kw),
                         sets),
                timed_ms(torch, lambda *a: FK.flash_attention_plain(*a, **kw),
                         sets[:1], reps=PLAIN_REPS, graph=False),
                timed_ms(torch, lib_fn, lsets))
            rows.append(_attn_row(
                torch, "flash_attention", dtype, got, ref, control, lib,
                times, nbytes,
                cost.flash_attention(B, S, T, H, Kv, d, pairs, es)[1],
                launched, B=B, S=S,
                T=T, H=H, Kv=Kv, d=d, window=window, causal=causal))
            del sets, lsets, got, ref, lib
            torch.cuda.empty_cache()
    _raise_faults(rows)
    return rows


def slot_positions(torch, B: int, W: int) -> tuple:
    """The position test of a paged cell's case (m): (slot_pos (B, W)
    int32, pos (B,) int32, window W // 2, the row with no valid slot or
    None). With B >= 3: row 0 a prefill of P = W // 4 + 1 positions with
    every 7th slot a -1 pad (pad slots inside its prefix, which the
    window does not reach); rows 1 .. B - 2 a wrapped ring (position W +
    (t - 5) % W in slot t, pos 2W - 6), which the window narrows to its
    last W // 2 positions; row B - 1 positions past its pos (no valid
    slot). With B <= 2 row 0 is the wrapped ring with the pads; with
    B = 1 there is no row without a valid slot."""
    t = torch.arange(W, device="cuda")
    pad = (t % 7 == 3) & (t < W - 1)    # the control's key stays valid
    wrapped = W + (t - 5) % W
    short = W // 4 + 1
    rows, pos = [], []
    for b in range(B):
        if b == B - 1 and B > 1:
            rows.append(t + W)
            pos.append(W - 1)
        elif b == 0 and B >= 3:
            rows.append(torch.where(pad | (t >= short), -1, t))
            pos.append(short - 1)
        else:
            rows.append(torch.where(pad & (b == 0), -1, wrapped))
            pos.append(2 * W - 6)
    return (torch.stack(rows).to(torch.int32),
            torch.tensor(pos, dtype=torch.int32, device="cuda"),
            max(1, W // 2), B - 1 if B > 1 else None)


def paged_phase(torch, PK, cells):
    """Paged attention against its plain version at ``cells`` (laid out
    as PAGED_CELLS) over a ring cache viewed
    as pages, as the decode step does, in three cases: (base) ragged
    lengths and (where a row has more than one page) an unassigned page
    in the last row; (q) the same caches as int8 codes and f32 scales
    (the port's ``quantize_kv``), the same lengths and page table; (m)
    the base caches under the position test of :func:`slot_positions`
    (pad slots, a window, a row with no valid slot, which must give
    exactly 0). The library time is scaled_dot_product_attention over the
    same cache laid out (B, Kv, W, d) beforehand (for (q) dequantized to
    q's dtype beforehand), with the valid slots as a boolean mask."""
    from repro_torch.kernels import cost
    import numpy as np
    from repro_torch.models.layers import ring_cache_pages, ring_pages
    from repro_torch.models.transformer import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    rows = []
    for dtype in ATTN_DTYPES:
        td = getattr(torch, dtype)
        es = torch.finfo(td).bits // 8
        for B, W, (H, Kv, d) in cells:
            lens = rng.integers(W // 2, W + 1, B)
            lens[0] = W
            cache_bytes = 2 * B * W * Kv * d * es
            caches = [tuple(torch.randn((B, W, Kv, d), generator=gen,
                                        device="cuda").to(td)
                            for _ in range(2))
                      for _ in range(_copies(cache_bytes))]
            q = torch.randn((B, H, d), generator=gen,
                            device="cuda").to(td)
            pos = torch.as_tensor(lens - 1, dtype=torch.int32,
                                  device="cuda")
            views = [ring_cache_pages(kc, vc, pos) for kc, vc in caches]
            _, _, table, sl = views[0]
            page, n = views[0][0].shape[1], table.shape[1]
            if n > 1:
                table[B - 1, n // 2] = -1
            sets = [(q, kp, vp, table, sl) for kp, vp, _, _ in views]
            slot = torch.arange(W, device="cuda")
            valid = (slot[None, :] < sl[:, None].long()) \
                & (table.repeat_interleave(page, dim=1) >= 0)
            shape = dict(B=B, W=W, H=H, Kv=Kv, d=d, page=page,
                         seq_lens=[int(x) for x in lens],
                         unassigned_page=n > 1)
            lib_sets = [(q[:, :, None], kc.transpose(1, 2).contiguous(),
                         vc.transpose(1, 2).contiguous())
                        for kc, vc in caches]
            rows.append(_paged_case(
                torch, PK, dtype, "base", sets, lib_sets, valid,
                cost.paged_attention(B, H, Kv, d, int(valid.sum()),
                                     table.numel(), es), shape))
            # (q): the cell's caches (and more seeded ones, as many as the
            # L2 asks) as int8 codes and scales, the base lengths and table
            qsets, lib_sets = [], []
            for i in range(_copies(B * W * Kv * (2 * d + 8))):
                kv = caches[i] if i < len(caches) else tuple(
                    torch.randn((B, W, Kv, d), generator=gen,
                                device="cuda").to(td) for _ in range(2))
                (kc, ks), (vc, vs) = (quantize_kv(c) for c in kv)
                kp, vp, _, _ = ring_cache_pages(kc, vc, pos)
                qsets.append((q, kp, vp, table, sl, ring_pages(ks, 0),
                              ring_pages(vs, 0)))
                lib_sets.append((q[:, :, None], *(
                    (c.float() * sc[..., None]).to(td).transpose(1, 2)
                    .contiguous() for c, sc in ((kc, ks), (vc, vs)))))
            rows.append(_paged_case(
                torch, PK, dtype, "int8_pages", qsets, lib_sets, valid,
                cost.paged_attention(B, H, Kv, d, int(valid.sum()),
                                     table.numel(), es, kv_es=1,
                                     scales=True), shape))
            del qsets
            # (m): the base caches under the position test
            slot_pos, mpos, window, empty = slot_positions(torch, B, W)
            msets = []
            for kc, vc in caches:
                kp, vp, mtable, msl = ring_cache_pages(kc, vc, mpos)
                msets.append((q, kp, vp, mtable, msl,
                              ring_pages(slot_pos, 0), mpos))
            mvalid = (slot[None, :] < msl[:, None].long()) \
                & PK.slot_mask(slot_pos, mpos, window)
            lib_sets = [(q[:, :, None], kc.transpose(1, 2).contiguous(),
                         vc.transpose(1, 2).contiguous())
                        for kc, vc in caches]
            row = _paged_case(
                torch, PK, dtype, "slot_positions", msets, lib_sets, mvalid,
                cost.paged_attention(B, H, Kv, d, int(mvalid.sum()),
                                     mtable.numel(), es, positions=True),
                dict(shape, seq_lens=msl.tolist(), unassigned_page=False,
                     window=window, row_without_valid_slot=empty),
                window=window, empty=empty)
            rows.append(row)
            del caches, views, sets, lib_sets, msets
        torch.cuda.empty_cache()
    _raise_faults(rows)
    return rows


#: the library call each paged case is timed beside
PAGED_LIBRARY = {
    "base": "scaled_dot_product_attention over the cache laid out (B, Kv, "
            "W, d) beforehand, the valid slots as a mask",
    "int8_pages": "scaled_dot_product_attention over the cache dequantized "
                  "to q's dtype and laid out (B, Kv, W, d) beforehand (reads "
                  "16-bit K/V, not int8), the valid slots as a mask",
    "slot_positions": "scaled_dot_product_attention over the cache laid out "
                      "(B, Kv, W, d) beforehand, the slots the position "
                      "test keeps as a mask",
}


def _paged_case(torch, PK, dtype, case, sets, lib_sets, valid, work, shape,
                window=None, empty=None) -> dict:
    """One case of a paged cell: the kernel on ``sets[0]`` against its
    plain version (``sets``: (q, k_pages, v_pages, table, seq_lens) and,
    for int8 pages, the scales, or, for the position test, slot_pos and
    pos) beside the control without each row's last key, one CUDA launch
    a call, the row ``empty`` exactly 0, and the kernel, plain and
    library (SDPA on ``lib_sets`` under ``valid``) times; ``work`` is
    the (bytes, FLOPs) of the cost formula. Returns the kernel row."""
    names = {"int8_pages": ("k_scale", "v_scale"),
             "slot_positions": ("slot_pos", "pos")}.get(case, ())
    extra = {} if window is None else {"window": window}
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call(fn):
        return lambda *a: fn(*a[:5], **dict(zip(names, a[5:])), **extra)

    kernel, plain = call(PK.paged_attention), call(PK.paged_attention_plain)
    args = sets[0]
    got = kernel(*args)
    ref = plain(*args)
    launched = check_one_launch(torch, "paged_attention",
                                lambda: kernel(*args))
    control = row_rel_err(plain(*args[:4], (args[4] - 1).clamp(min=0),
                                *args[5:]), ref)
    mask = valid[:, None, None, :]

    def lib_fn(q_, k_, v_):
        return sdpa(q_, k_, v_, attn_mask=mask, enable_gqa=True)

    lib = lib_fn(*lib_sets[0])[:, :, 0]
    torch.cuda.synchronize()
    times = (timed_ms(torch, kernel, sets),
             timed_ms(torch, plain, sets[:1], reps=PLAIN_REPS, graph=False),
             timed_ms(torch, lib_fn, lib_sets))
    row = _attn_row(torch, "paged_attention", dtype, got, ref, control, lib,
                    times, *work, launched, case=case, **shape,
                    library_is=PAGED_LIBRARY[case])
    if empty is not None and got[empty].float().any():
        row["fault"] = row["fault"] or (
            f"paged_attention {case} at {dtype} {shape}: the row without a "
            f"valid slot is not 0")
    return row


# ---------------------------------------------------------------------------
# the fused passes (kernels/fused): norm, RoPE, gated activation
# ---------------------------------------------------------------------------
#: what each replaces: no Pallas kernel, a jnp chain XLA fuses
FUSED_REPLACES = {
    name: f"none: XLA fuses the reference's ops under jax.jit "
          f"(src/repro/serving/backend.py:451); {what}"
    for name, what in (
        ("rms_norm", "rms_norm, src/repro/models/layers.py:24"),
        ("rope_qk", "apply_rope of q and of k, "
                    "src/repro/models/layers.py:46"),
        ("silu_mul", "jax.nn.silu(g) * u, src/repro/models/layers.py:236 "
                     "and the MoE experts' FFN"),
        ("ssm_conv_step", "conv_step, src/repro/models/ssm.py:67"),
        ("ssd_step", "ssd_decode_step, src/repro/models/ssm.py:154, with "
                     "the dt, A and gate lines of mamba_block_decode, "
                     ":249-255"))}
#: rms_norm and ssd_step against their plain versions, each returned
#: tensor on its own: its max |diff| over its max |plain|. f32: the same
#: operations, a sum (the norm's, ssd_step's over the state) in another
#: order; bf16: one rounding of (nearly) the same f32 value, an ulp apart.
#: ssd_step's f32 state is held at the f32 tolerance whatever the
#: activation dtype. rope_qk, silu_mul and ssm_conv_step round where their
#: plain ops round, and are held to them bit for bit, output and conv
#: cache (FUSED_EXACT)
FUSED_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FUSED_EXACT = ("rope_qk", "silu_mul", "ssm_conv_step")
#: RoPE's theta in the fused cells (llama-3.1-8b's); the table's values do
#: not change the kernel's work
FUSED_THETA = 500000.0
#: the kernels line's shapes: llama-3.1-8b's bf16 decode at batch 4
HEADLINE_FUSED = {
    "rms_norm": {"dtype": "bfloat16", "rows": 4, "D": 4096,
                 "gamma": "bfloat16"},
    "rope_qk": {"dtype": "bfloat16", "B": 4, "S": 1, "H": 32, "Kv": 8,
                "hd": 128},
    "silu_mul": {"dtype": "bfloat16", "shape": [4, 14336]},
    "ssm_conv_step": {"arch": "mamba2-2.7b", "dtype": "bfloat16",
                      "params": "bfloat16", "B": 4},
    "ssd_step": {"arch": "mamba2-2.7b", "dtype": "bfloat16",
                 "params": "bfloat16", "B": 4},
}
#: the argument each SSM step kernel updates in place: the conv cache, the
#: state
FUSED_STATE = {"ssm_conv_step": 1, "ssd_step": 8}


def fused_cells(configs) -> dict:
    """Every call the runs make of the fused kernels, by kernel:
    rms_norm at each run's rows (:func:`served_rows`) over d_model and,
    for SSM and hybrid, the gate norm's d_inner, x in the format's
    activation dtype and gamma in its parameter dtype; rope_qk at each
    causal flash cell (B, S, int64 positions (S,)) and each audio
    encoder's (B, T_ENC), and each paged cell's lanes (B, 1, int32
    positions (B, 1)), in bf16, and in f32 at llama-3.1-8b's heads (its
    float32 cell); silu_mul at each run's rows over d_ff (dense, vlm,
    audio, the hybrid's shared block), and over each MoE expert stack (E,
    C, d_ff) of the grouped cells (:func:`quant_cells`), in the
    activation dtype; ssm_conv_step and ssd_step at each SSM and hybrid
    run's width, at every decode batch up to its max_batch, in each
    format's activation and parameter dtypes and in f32. Returns {name:
    [cell, ...]}: rms_norm (rows, D, dtype, gamma dtype), rope_qk (B, S,
    H, Kv, hd, dtype, positions), silu_mul (shape, dtype) and the SSM
    kernels (arch, B, dtype, parameter dtype)."""
    from repro_torch.core.precision import make_policy
    from repro_torch.models.ssm import ssm_dims
    norms, silu, ssm = set(), set(), set()
    for arch, formats, kw, rows in served_rows(configs):
        cfg = configs[arch]
        widths = [cfg.d_model]
        if cfg.family in ("ssm", "hybrid"):
            widths.append(ssm_dims(cfg)["d_inner"])
        for fmt in formats:
            pol = make_policy(fmt)
            act = str(pol.activation_dtype).removeprefix("torch.")
            gam = str(pol.param_dtype).removeprefix("torch.")
            norms |= {(r, D, act, gam) for r in rows for D in widths}
            if cfg.family in ("ssm", "hybrid"):
                ssm |= {(arch, B, *dts) for B in range(
                    1, kw["max_batch"] + 1) for dts in (
                    (act, gam), ("float32", "float32"))}
            if cfg.d_ff and not cfg.is_moe and cfg.family != "ssm":
                silu |= {((r, cfg.d_ff), act) for r in rows}
    for (_, E, _, N), caps in quant_cells(configs)[1].items():
        for C, archs in caps.items():
            if any(configs[a].d_ff == N for a in archs):
                silu.add(((E, C, N), "bfloat16"))
    causal, full, paged = attention_cells(configs)
    rope = {(B, S, *h, "bfloat16", "S") for B, S, h, _ in causal}
    rope |= {(B, S, *h, "bfloat16", "S") for B, S, T, h in full if S == T}
    rope |= {(B, 1, *h, "bfloat16", "B1") for B, _, h in paged}
    rope |= {(*c[:5], "float32", c[6]) for c in list(rope)
             if tuple(c[2:5]) == LLAMA_HEADS}
    return {"rms_norm": sorted(norms), "rope_qk": sorted(rope),
            "silu_mul": sorted(silu), "ssm_conv_step": sorted(ssm),
            "ssd_step": sorted(ssm)}


def _ssm_call(torch, FU, name, cell, randn):
    """:func:`_fused_call` of an SSM step kernel: the inputs as a Mamba
    layer's decode step makes them (x, z and dt views of the input
    projection, x, B and C of the conv output, dt_bias and A_log as
    ``init_mamba_layer`` draws them, D from 0.5 to 1.5, a random conv
    cache and state); the
    calls return (output, the conv cache or the state), which they update
    in place."""
    from repro_torch.kernels import cost
    from repro_torch.launch.serve import arch_config
    from repro_torch.models.ssm import ssm_dims
    arch, B, dt, pd = cell
    cfg = arch_config(arch)
    d = ssm_dims(cfg)
    nh, hd, ng, ds = d["nheads"], d["headdim"], d["ngroups"], d["dstate"]
    C, di, Kw = d["conv_channels"], d["d_inner"], cfg.ssm_conv_width
    td, tp = getattr(torch, dt), getattr(torch, pd)
    es, pes = torch.finfo(td).bits // 8, torch.finfo(tp).bits // 8
    heads = torch.linspace(0, 1, nh, device="cuda")

    def conv_args():
        zx = randn((B, d["d_in_proj"]), td)
        return (zx[:, di:di + C], randn((B, Kw - 1, C), td),
                randn((Kw, C), tp, 0.3), randn((C,), tp, 0.1))

    def ssd_args():
        zx, xBC = randn((B, d["d_in_proj"]), td), randn((B, C), td)
        gs = ng * ds
        return (xBC[:, :di].reshape(B, nh, hd),
                xBC[:, di:di + gs].reshape(B, ng, ds),
                xBC[:, di + gs:].reshape(B, ng, ds),
                zx[:, :di].reshape(B, nh, hd), zx[:, di + C:],
                torch.log(torch.expm1(1e-3 + 0.099 * heads)).to(tp),
                torch.log(1 + 15 * heads).to(tp), (0.5 + heads).to(tp),
                randn((B, nh, hd, ds), torch.float32))

    if name == "ssm_conv_step":
        make, work = conv_args, cost.ssm_conv_step(B, C, Kw, es, pes)
        kern = lambda *a: (FU.ssm_conv_step(*a), a[1])  # noqa: E731
        plain = lambda *a: (FU.ssm_conv_step_plain(*a), a[1])  # noqa: E731
    else:
        make, work = ssd_args, cost.ssd_step(B, nh, hd, ng, ds, es, pes)
        kern = lambda *a: (FU.ssd_step(*a), a[8])  # noqa: E731
        plain = lambda *a: (FU.ssd_step_plain(*a), a[8])  # noqa: E731
    sets = [make() for _ in range(_copies(work[0]))]
    return (kern, plain, None, sets,
            {"arch": arch, "dtype": dt, "params": pd, "B": B, "C": C,
             "nh": nh, "hd": hd, "ng": ng, "ds": ds}, work)


def _fused_call(torch, FU, name, cell, gen):
    """(kernel call, plain call, library call or None, arg sets, the
    cell's fields, (bytes, FLOPs)) of one fused cell, the inputs drawn
    from ``gen``; arg sets cycle past the L2 (:func:`_copies`). MoE
    expert stacks keep their rows from C / 2 on at zero, as rows past a
    dispatch's counts are."""
    from repro_torch.kernels import cost
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    if name in FUSED_STATE:
        return _ssm_call(torch, FU, name, cell, randn)
    if name == "rms_norm":
        rows, D, dt, gd = cell
        x, gamma = randn((rows, D), td[dt], 3.0), randn((D,), getattr(
            torch, gd))
        work = cost.rms_norm(rows, D, x.element_size(),
                             gamma.element_size())
        lib_gamma = gamma.to(x.dtype)
        sets = [(x, gamma)] + [(x.clone(), gamma) for _ in range(
            _copies(work[0]) - 1)]
        return (FU.rms_norm, FU.rms_norm_plain,
                lambda x, g: torch.nn.functional.rms_norm(
                    x, (D,), lib_gamma, 1e-6), sets,
                {"dtype": dt, "rows": rows, "D": D, "gamma": gd}, work)
    if name == "rope_qk":
        B, S, H, Kv, hd, dt, kind = cell
        q, k = randn((B, S, H, hd), td[dt]), randn((B, S, Kv, hd), td[dt])
        pos = (torch.arange(S, device="cuda") if kind == "S" else
               torch.randint(0, 4096, (B, 1), generator=gen, device="cuda",
                             dtype=torch.int32))
        work = cost.rope_qk(B * S, H, Kv, hd, q.element_size(),
                            pos.element_size(), pos.numel())
        sets = [(q, k, pos)] + [(q.clone(), k.clone(), pos) for _ in range(
            _copies(work[0]) - 1)]
        return (lambda q, k, p: FU.rope_qk(q, k, p, FUSED_THETA),
                lambda q, k, p: FU.rope_qk_plain(q, k, p, FUSED_THETA),
                None, sets, {"dtype": dt, "B": B, "S": S, "H": H, "Kv": Kv,
                             "hd": hd, "positions": kind}, work)
    shape, dt = cell
    g, u = randn(shape, td[dt], 4.0), randn(shape, td[dt])
    if len(shape) == 3:
        g[:, shape[1] // 2:] = 0
        u[:, shape[1] // 2:] = 0
    work = cost.silu_mul(g.numel(), g.element_size())
    sets = [(g, u)] + [(g.clone(), u.clone()) for _ in range(
        _copies(work[0]) - 1)]
    return (FU.silu_mul, FU.silu_mul_plain, None, sets,
            {"dtype": dt, "shape": list(shape)}, work)


def fused_phase(torch, FU, cells) -> dict:
    """Each fused kernel at every cell of :func:`fused_cells` against its
    plain version (bit for bit for FUSED_EXACT, else each returned tensor
    within its FUSED_REL_TOL; an SSM step kernel and its plain version
    each on its own clone of the cell's conv cache or state, which is
    compared too),
    one launch a call counted and one
    kernel node in a CUDA graph (``check_one_launch``), an expert stack's
    zero rows kept zero; kernel, plain (today's eager ops) and, for
    rms_norm, library (``torch.nn.functional.rms_norm``, a yardstick the
    port never calls) times, CUDA graphs replayed between CUDA events,
    beside the bound (bytes over HBM, or the f32 operations over the f32
    peak). Returns each kernel's rows."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {name: [] for name in FU.NAMES}
    faults = []
    for name in FU.NAMES:
        for cell in cells[name]:
            kern, plain, lib, sets, fields, (nbytes, flops) = _fused_call(
                torch, FU, name, cell, gen)
            args = sets[0]

            def fresh():
                """The first arg set, its state (if any) a clone."""
                if name not in FUSED_STATE:
                    return args
                i = FUSED_STATE[name]
                return (*args[:i], args[i].clone(), *args[i + 1:])

            before = FU.LAUNCHES[name]
            got = kern(*fresh())
            launched_once = FU.LAUNCHES[name] == before + 1
            ref = plain(*fresh())
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            diffs = [(a.float() - b.float()).abs().max().item()
                     for a, b in zip(got, ref)]
            rels = [d / max(b.float().abs().max().item(), 1e-30)
                    for d, b in zip(diffs, ref)]
            zeros_kept = not (name == "silu_mul" and len(fields["shape"]) == 3
                              and got[0][:, fields["shape"][1] // 2:].any())
            bound, by = _bound(nbytes, flops, "float32")
            exact = name in FUSED_EXACT
            # the output at the activation dtype's tolerance, a state
            # (always f32) at f32's
            tols = [0.0 if exact else FUSED_REL_TOL[dt] for dt in
                    [fields["dtype"]] + ["float32"] * (len(ref) - 1)]
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            row = {"phase": "kernel", "name": name, **fields,
                   "max_abs_err": max(diffs), "max_rel_err": max(rels),
                   "rel_err_by_output": rels, "rel_tol": tols,
                   "bit_equal": equal,
                   "kernel_ms": timed_ms(torch, kern, sets),
                   "plain_ms": timed_ms(torch, plain, sets),
                   "library_ms": (timed_ms(torch, lib, sets)
                                  if lib is not None else None),
                   "bytes": nbytes, "flops": flops, "bound_ms": bound,
                   "bound_by": by,
                   "cuda_launches_per_call": check_one_launch(
                       torch, name, lambda: kern(*args))}
            emit(row)
            within = all(r <= t for r, t in zip(rels, tols))
            if not ((equal if exact else within) and launched_once
                    and zeros_kept):
                faults.append(f"{name} at {fields}: rel {rels} (tol {tols}), "
                              f"bit equal {equal}, counted once "
                              f"{launched_once}, zero rows kept "
                              f"{zeros_kept}")
            out[name].append(row)
            del sets, args, got, ref
        torch.cuda.empty_cache()
    if faults:
        raise SystemExit("fused: " + "; ".join(faults[:5]))
    return out


def fused_launches(cfg) -> tuple:
    """({kernel: launches} a prefill phase, a decode step) of the fused
    kernels: two norms a decoder layer (attention and FFN; a Mamba
    layer's norm and gate norm), RoPE of q and k and the gated activation
    once a layer with attention and a gated MLP or MoE FFN, and the
    final norm; audio adds a cross-attention norm a decoder layer and,
    at prefill, its encoder's layers and final norm; hybrid its shared
    block's two norms, RoPE and activation at each site; a Mamba layer's
    decode step its conv and state update (its prefill neither)."""
    L = cfg.num_layers

    def per(norms, rope, silu, ssm=0):
        return {"rms_norm": norms, "rope_qk": rope, "silu_mul": silu,
                "ssm_conv_step": ssm, "ssd_step": ssm}

    if cfg.family == "ssm":
        return per(2 * L + 1, 0, 0), per(2 * L + 1, 0, 0, L)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_sites
        s = n_attn_sites(cfg)
        return (per(2 * L + 1 + 2 * s, s, s),
                per(2 * L + 1 + 2 * s, s, s, L))
    if cfg.family == "audio":
        E = cfg.enc_layers
        return (per(3 * L + 1 + 2 * E + 1, L + E, L + E),
                per(3 * L + 1, L, L))
    step = per(2 * L + 1, L, L)
    return step, step


def train_fused_launches(cfg, remat: bool = False) -> dict:
    """{kernel: launches} of the fused kernels in a dense model's train
    step: its forward's, a prefill phase's (:func:`fused_launches`), with
    a layer's twice under ``remat`` (rerun in the backward); the backward
    launches none (it reruns the plain ops for their gradient)."""
    L, r = cfg.num_layers, 2 if remat else 1
    return {"rms_norm": 2 * L * r + 1, "rope_qk": L * r, "silu_mul": L * r}


def reset_launches(mods) -> None:
    for m in mods:
        m.reset_launches()


def read_launches(mods) -> dict:
    return {name: n for m in mods for name, n in m.LAUNCHES.items()}


def read_loops(K) -> dict:
    return {name: dict(c) for name, c in K.LOOP_LAUNCHES.items()}


def quant_calls_per_phase(cfg) -> tuple:
    """(2-D quant calls a phase makes over its tokens, over the encoder's
    rows; grouped expert products a phase): a dense or vlm layer's 7
    projections, an MoE layer's 4 attention ones (and 3 grouped), an
    audio decoder layer's 9 (its own 7, the cross-attention's q and o)
    and for a prefill its encoder's 7 a layer and each decoder layer's
    cross K/V, 2; a Mamba layer's 2, and hybrid's shared block's 7 at
    each site."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return 2 * L, 0, 0
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_sites
        return 2 * L + QUANT_PROJECTIONS * n_attn_sites(cfg), 0, 0
    if cfg.family == "audio":
        return ((QUANT_PROJECTIONS + 2) * L,
                QUANT_PROJECTIONS * cfg.enc_layers + 2 * L, 0)
    if cfg.is_moe:
        return (QUANT_PROJECTIONS - 3) * L, 0, 3 * L
    return QUANT_PROJECTIONS * L, 0, 0


def expected_quant_loops(cfg, fmt, tokens, enc_rows=()) -> dict:
    """Under int8, nf4 and float16, the launches of each quant entry point
    by loop over phases that route ``tokens`` tokens each (a prefill: its
    rows times its padded length; a decode step: its lanes), and for audio
    prefills whose encoders take ``enc_rows`` rows each: the 2-D calls of
    :func:`quant_calls_per_phase` on the decode loop for at most 8 rows
    and the wgmma loop above; under float16 also the LM head, once a phase
    (its rows are a step's lanes or a prefill's last tokens, at most 8 in
    every serve cell) on the decode loop, or on the tile loop where the
    bf16 loops do not take its vocabulary (granite-moe-1b-a400m's 49155
    columns: N % 16 != 0). Under those and bfloat16, an MoE layer's
    grouped expert products in the format's GROUPED_ENTRY on the loop
    their capacity (rows an expert) chooses the same way (qwen3 bf16: 144
    on the decode loop a step). Nothing else on the tile loop. Empty for
    the other formats and cells."""
    from repro_torch.kernels.quant_matmul.kernel import matmul_plan
    from repro_torch.models.moe import expert_capacity
    name = QUANT_ENTRY.get(fmt)
    entry = GROUPED_ENTRY.get(fmt) if cfg.is_moe else None
    per, per_enc, grouped = quant_calls_per_phase(cfg)
    zero = {"decode": 0, "wgmma": 0, "tile": 0}
    want = {n: dict(zero) for n in (name, entry) if n is not None}
    for T in tokens:
        if name is not None:
            want[name]["decode" if T <= 8 else "wgmma"] += per
        if fmt == "float16":
            want[name][matmul_plan(8, cfg.vocab_size, cfg.d_model, 1,
                                   fmt="fp16").loop] += 1
        if entry is not None:
            C = expert_capacity(T, cfg.num_experts, cfg.experts_per_token,
                                cfg.moe_capacity_factor)
            want[entry]["decode" if C <= 8 else "wgmma"] += grouped
    for T in enc_rows if name is not None else ():
        want[name]["decode" if T <= 8 else "wgmma"] += per_enc
    return want


def check_quant_loops(cfg, fmt, loops, tokens, run, enc_rows=()) -> dict:
    """Fail unless the run's quant launches by loop are
    :func:`expected_quant_loops`; return them."""
    want = expected_quant_loops(cfg, fmt, tokens, enc_rows)
    got = {name: loops[name] for name in want}
    if got != want:
        raise SystemExit(f"{cfg.name} {fmt} {run} run: quant loops {got}, "
                         f"expected {want}")
    return got


def attention_launches(cfg) -> tuple:
    """(flash launches per prefill, paged launches per decode step): one
    of each a layer (windowed, int8-KV and 16-bit caches alike); audio
    adds its encoder's flash per encoder layer and a cross-attention of
    each per decoder layer; hybrid one of each per site of its shared
    block; none for SSM."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_sites
        return n_attn_sites(cfg), n_attn_sites(cfg)
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * L, 2 * L
    return L, L


def sampled_power(fn):
    """Run ``fn()`` while ``nvidia-smi`` samples the card's power draw
    every 100 ms; return (fn's result, the readings in W). ``fn`` starts
    after the sampler's first reading, which is dropped: the sampler
    takes a moment to start, and a run shorter than that (stablelm-1.6b's
    serve run takes about 0.1 s) would otherwise end before it. The
    readings are those buffered while ``fn`` ran or, for a run that ends
    between two readings, the first after its end. Fails if the sampler
    gives no reading."""
    import os
    ids = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    proc = subprocess.Popen(POWER_SAMPLER + ["-i", ids or "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    watts = ""
    try:
        if proc.stdout.readline():
            out = fn()          # serve() ends with a device synchronise
            watts = proc.stdout.readline()
    finally:
        proc.terminate()
        # proc.stdout, not communicate(): readline may have buffered more
        # than the line it returned
        watts += proc.stdout.read()
        stderr = proc.stderr.read()
        proc.wait(timeout=60)
    if not watts:
        raise SystemExit(f"the power sampler gave no reading: {stderr!r}")
    return out, [float(x) for x in watts.split()]


# llama-3.1-8b's serve phase and the MoE cells: 8 requests, prompts of
# 64-256 tokens, 32 new tokens each, all arriving at t = 0
TRAFFIC = dict(n=8, max_batch=4, max_prefill_batch=2, buf_len=512,
               prompt_len=(64, 256), new_tokens=(32, 32), seed=0,
               record_logits=True)
# the dense ARCH_IDS cells: 4 requests of 8 new tokens
DENSE_TRAFFIC = dict(TRAFFIC, n=4, new_tokens=(8, 8))
# (arch, formats, traffic), at full width and depth; ``kv_quant`` in the
# traffic builds the model with an int8 KV cache
SERVE_CELLS = [
    ("llama-3.1-8b", FORMATS, TRAFFIC),
    ("llama-3.1-8b", ("bfloat16",), dict(TRAFFIC, kv_quant=True)),
    ("qwen3-moe-30b-a3b", ("bfloat16", "int8", "nf4"), TRAFFIC),
    ("granite-moe-1b-a400m", ("int8",), TRAFFIC),
    ("granite-moe-1b-a400m", ("float16",), TRAFFIC),
    ("stablelm-1.6b", ("bfloat16",), DENSE_TRAFFIC),
    ("minitron-8b", ("bfloat16",), DENSE_TRAFFIC),
    ("h2o-danube-3-4b", ("bfloat16",), DENSE_TRAFFIC),
    ("command-r-35b", ("int8",), DENSE_TRAFFIC),
    # the vlm (text only, as the reference serves it), SSM and hybrid
    # families
    ("phi-3-vision-4.2b", ("bfloat16",), DENSE_TRAFFIC),
    ("mamba2-2.7b", ("bfloat16", "nf4"), DENSE_TRAFFIC),
    ("zamba2-1.2b", ("bfloat16", "int8"), DENSE_TRAFFIC),
]
# (arch, formats) driven through Model.prefill and Model.decode_step with
# their stub inputs, 576 patches a request (vlm) or T_ENC frames (audio,
# which no serving path carries: the reference's backend passes only
# tokens), over DENSE_TRAFFIC's prompts, two at a time
MODEL_CELLS = [("phi-3-vision-4.2b", ("bfloat16",)),
               ("seamless-m4t-large-v2", ("bfloat16", "int8"))]
MODEL_TRAFFIC = DENSE_TRAFFIC
MODEL_PAIR = 2
# the arrival phase: llama-3.1-8b at full width and depth, 12 requests of
# the paper's prompts (200-4000 tokens, log-uniform) with outputs cut
# from the paper's 10-300 to 10-64 for the time limit; prompt + output
# stays within buf_len, so no prompt is truncated
ARRIVAL_ARCH = "llama-3.1-8b"
ARRIVAL = dict(n=12, seed=0, max_batch=8, max_prefill_batch=4, buf_len=4096,
               prompt_range=(200, 4000), output_range=(10, 64))
# (run, format, arrival pattern, scheduler, batch policy): the pattern's
# times are burst (all at t = 0), fixed_50ms (every 50 ms) or poisson_20
# (20 a second, seed 0); scheduler and policy are (registry name,
# parameters), None for none and for SlotCountPolicy
ARRIVAL_RUNS = [
    ("burst", "bfloat16", "burst", None, None),
    ("fixed_50ms", "bfloat16", "fixed_50ms", None, None),
    ("poisson_20", "bfloat16", "poisson_20", None, None),
    ("burst_paced_10", "bfloat16", "burst", ("paced", {"rate_per_s": 10.0}),
     None),
    ("fixed_50ms_chunked_1024", "bfloat16", "fixed_50ms", None,
     ("chunked_prefill", {"chunk_tokens": 1024})),
    ("burst", "int8", "burst", None, None),
    ("fixed_50ms", "int8", "fixed_50ms", None, None),
]
# the runs whose first-token logits are held against each request's own
# prefill: the 50 ms run prefills each request alone, the burst in
# batches of up to 4 padded rows
ARRIVAL_LOGIT_RUNS = (("fixed_50ms", "bfloat16"), ("burst", "bfloat16"))


def _run_tokens(res, mode, max_batch) -> list:
    """The tokens each phase of a served run routed: continuous, each
    executed batched prefill's rows times its padded length and
    max_batch lanes a decode step; sequential, each prompt, then one
    token a step."""
    if mode == "continuous":
        steps = [p.phase
                 for p in res.engine.backend.phases].count("decode")
        return ([b * s for b, s in res.engine.backend.prefill_shapes]
                + [max_batch] * steps)
    return ([r.prompt_len for r in res.requests]
            + [1] * sum(r.max_new_tokens - 1 for r in res.requests))


def _check_run(torch, mods, cfg, fmt, res, mode, max_batch,
               kv_quant=False):
    """The launch checks of one served run (the counts set to 0 before
    it): every token in the vocabulary and every request complete; the
    quant kernels in their formats only (the grouped ones only for MoE),
    each launch on the loop its rows choose; the attention launches of
    :func:`attention_launches` per prefill and decode step, and the
    paged launches' cases (:func:`check_paged_cases`). Returns (launch
    counts, quant loops)."""
    counts = read_launches(mods)
    for r in res.requests:
        if len(r.generated) != r.max_new_tokens:
            raise SystemExit(f"{cfg.name} {fmt}: request {r.req_id} got "
                             f"{len(r.generated)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise SystemExit(f"{cfg.name} {fmt}: token out of the "
                             f"vocabulary")
    check_quant_entries(cfg, fmt, counts, mode)
    loops = check_quant_loops(cfg, fmt, read_loops(mods[0]),
                              _run_tokens(res, mode, max_batch), mode)
    if mode == "continuous":
        # a chunk before a prompt's last is costed only: the executed
        # prefills are those with a host wall time, one a prefill shape,
        # and without chunks every prefill phase
        backend = res.engine.backend
        phases = [p.phase for p in backend.phases]
        executed = sum(p.phase == "prefill" and p.wall_s is not None
                       for p in backend.phases)
        if executed != len(backend.prefill_shapes) or (
                not res.report.prefill_chunks
                and executed != phases.count("prefill")):
            raise SystemExit(f"{cfg.name} {fmt}: {executed} executed "
                             f"prefills of {phases.count('prefill')} "
                             f"phases, {len(backend.prefill_shapes)} "
                             f"prefill shapes")
        check_attention_launches(cfg, fmt, counts, executed,
                                 phases.count("decode"))
        check_paged_cases(cfg, fmt, mods[2], phases.count("decode"),
                          kv_quant)
    return counts, loops


def check_quant_entries(cfg, fmt, counts, run) -> None:
    """Fail unless the quant kernels launched in their formats only (the
    2-D ones of QUANT_ENTRY), and the grouped ones (GROUPED_ENTRY: bf16's
    under bfloat16, fp16's under float16) in theirs and only for MoE."""
    pairs = [(name, fmt == fmt_of) for fmt_of, name in QUANT_ENTRY.items()]
    pairs += [(entry, fmt == fmt_of and cfg.is_moe)
              for fmt_of, entry in GROUPED_ENTRY.items()]
    for entry, want in pairs:
        if (counts[entry] > 0) != want:
            raise SystemExit(f"{cfg.name} {fmt} {run}: {entry} "
                             f"launched {counts[entry]} times")


def check_attention_launches(cfg, fmt, counts, prefills, steps) -> None:
    """Fail unless the attention kernels launched
    :func:`attention_launches` times over ``prefills`` prefill phases
    and ``steps`` decode steps, and the fused kernels
    :func:`fused_launches` times."""
    for name, phase, per, n in zip(("flash_attention", "paged_attention"),
                                   ("prefill", "decode"),
                                   attention_launches(cfg),
                                   (prefills, steps)):
        if counts[name] != per * n:
            raise SystemExit(f"{cfg.name} {fmt}: {name} launched "
                             f"{counts[name]} times, not {per} per "
                             f"{phase} ({per * n})")
    pre, step = fused_launches(cfg)
    want = {k: pre[k] * prefills + step[k] * steps for k in pre}
    got = {k: counts[k] for k in want}
    if got != want:
        raise SystemExit(f"{cfg.name} {fmt}: fused launches {got}, not "
                         f"{pre} a prefill and {step} a step ({want})")


def check_paged_cases(cfg, fmt, PK, steps, kv_quant) -> dict:
    """Fail unless, over ``steps`` decode steps, every self-attention
    layer's paged launch took the position test (none for the hybrid's
    sites, which describe their rings by lengths alone, nor for SSM) and,
    with an int8 KV cache, int8 pages; return the case counts."""
    per = 0 if cfg.family in ("ssm", "hybrid") else cfg.num_layers
    want = {"int8_pages": per * steps if kv_quant else 0,
            "slot_positions": per * steps}
    if PK.CASES != want:
        raise SystemExit(f"{cfg.name} {fmt}: paged launches by case "
                         f"{PK.CASES}, expected {want}")
    return dict(PK.CASES)


#: teacher-forced decode through the paged kernel against the same steps
#: through its plain version (each step from the same cache), as the
#: 16-bit model tests bound it: the max |logit difference| over the max
#: |logit|
TEACHER_TOL = 5e-2
TEACHER_STEPS = 8


def teacher_forced(torch, PK, model, params, toks, lengths, buf_len,
                   steps: int = TEACHER_STEPS) -> dict:
    """A prefill of ``toks`` (right-padded, ``lengths``) into a ring of
    ``buf_len``, then ``steps`` decode steps, each run twice from the
    same cache: through the paged kernel, and with
    ``paged_attention_plain`` in the kernel's place; the plain step's
    greedy token feeds the next. Fails past TEACHER_TOL or unless each
    step launched the kernel once a layer. Returns the line's fields."""
    logits, cache = model.prefill(params, {"tokens": toks}, buf_len=buf_len,
                                  lengths=lengths)
    tok = logits.argmax(-1)[:, None]
    worst, launched = 0.0, set()
    pads = int((cache["slot_pos"] < 0).sum())
    for _ in range(steps):
        plain_cache = {k: v.clone() for k, v in cache.items()}
        before = PK.LAUNCHES["paged_attention"]
        got, cache = model.decode_step(params, tok, cache)
        launched.add(PK.LAUNCHES["paged_attention"] - before)
        kernel = PK.paged_attention
        PK.paged_attention = PK.paged_attention_plain
        try:
            ref, _ = model.decode_step(params, tok, plain_cache)
        finally:
            PK.paged_attention = kernel
        if not torch.isfinite(got).all():
            raise SystemExit(f"{model.cfg.name}: non-finite decode logits")
        worst = max(worst, ((got - ref).abs().max()
                            / ref.abs().max()).item())
        tok = ref.argmax(-1)[:, None]
        del plain_cache
    want = {model.cfg.num_layers}
    if not worst <= TEACHER_TOL or launched != want:
        raise SystemExit(f"{model.cfg.name}: teacher-forced decode through "
                         f"the paged kernel off by {worst} (tolerance "
                         f"{TEACHER_TOL}), {launched} launches a step, "
                         f"expected {want}")
    return {"steps": steps, "buf_len": cache["k"].shape[2],
            "prompt_lens": [int(x) for x in lengths],
            "pad_slots_after_prefill": pads, "max_rel_err": worst,
            "tol": TEACHER_TOL, "paged_launches_per_step": sorted(launched)}


#: the cache past its ring: two prompts of these lengths right-padded
#: into a ring of PAST_RING_BUF slots (h2o-danube-3-4b, bfloat16)
PAST_RING_LENS = (200, 137)
PAST_RING_BUF = 128


#: the graph check's decode steps, each from the cache the last left
GRAPH_STEPS = 4
#: each serve cell's replayed graph: its kernel nodes by function name
#: (graph_check), by (arch, format[, "kv_quant"])
GRAPH_NODES = {}
#: the cells whose graphs the serve phase sets side by side: a format
#: against the one whose kernel node count it should match (int8's
#: outlier product and fp16's weights now inside their kernels; qwen3's
#: bf16 experts, one grouped launch a product as nf4's)
GRAPH_PAIRS = [(("llama-3.1-8b", "int8"), ("llama-3.1-8b", "nf4")),
               (("llama-3.1-8b", "float16"), ("llama-3.1-8b", "bfloat16")),
               (("qwen3-moe-30b-a3b", "int8"), ("qwen3-moe-30b-a3b", "nf4")),
               (("qwen3-moe-30b-a3b", "bfloat16"),
                ("qwen3-moe-30b-a3b", "nf4")),
               (("zamba2-1.2b", "int8"), ("zamba2-1.2b", "bfloat16"))]
#: the most kernel nodes a replayed llama-3.1-8b bf16 step may have: its
#: 2453 before the fused kernels (PERF.md section 5) less the 1500 they
#: must take out at least
LLAMA_BF16_NODES_MAX = 2453 - 1500
#: the same for mamba2-2.7b and zamba2-1.2b in bf16: their 2886 and 1843
#: before the SSM step's two kernels (PERF.md section 5) less the 2000
#: and 1200 those must take out at least
MAMBA2_BF16_NODES_MAX = 2886 - 2000
ZAMBA2_BF16_NODES_MAX = 1843 - 1200
#: the CUDA kernel functions each kernel module launches, by a part of
#: their names
KERNEL_FUNCTIONS = {"quant_matmul": ("qmm_wgmma_kernel", "qmm_tile_kernel"),
                    "flash_attention": ("flash_kernel", "flash_wgmma_kernel"),
                    "paged_attention": ("paged_kernel",),
                    "fused": ("rms_norm_kernel", "rope_qk_kernel",
                              "silu_mul_kernel", "ssm_conv_step_kernel",
                              "ssd_step_kernel")}


def graph_check(torch, mods, model, params, backend) -> dict:
    """The served decode step as a CUDA graph (``ExecutedBackend.
    decode_graph``), after a timed run: every decode step of the run
    after its first was a replay of one graph; then GRAPH_STEPS more
    steps from the cache the run left, each through ``Model.decode_step``
    eagerly on a copy of the cache and feed tokens, then through a
    replay. Fails unless the logits, the greedy tokens and the whole
    cache agree bit for bit, each step's launch counts (launches, paged
    cases, quant loops) agree, and the graph's kernel nodes by function
    name are the eager step's launches of each kernel module. Returns
    the line's fields, with the host wall of the run's first step (eager)
    and second (captured and replayed), and each checked step's host
    time to enqueue and its span between two CUDA events on the device,
    eager and replayed (the eager span holds the device's waits for the
    host)."""
    K, FK, PK, FU = mods
    g = backend.decode_graph
    name = f"{model.cfg.name} {model.policy.fmt}"
    steps = [p.phase for p in backend.phases].count("decode")
    if g is None or g.graph is None or g.replays != steps - 1:
        raise SystemExit(f"{name}: {steps} decode steps but "
                         f"{getattr(g, 'replays', None)} graph replays")
    run_replays = g.replays
    walls = [p.wall_s for p in backend.phases if p.phase == "decode"]
    names = graph_kernel_names(g.graph)
    nodes = {mod: sum(any(f in n for f in fns) for n in names)
             for mod, fns in KERNEL_FUNCTIONS.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = {"eager": [], "graph": []}
    span = {"eager": [], "graph": []}

    def counts():
        return read_launches(mods), dict(PK.CASES), read_loops(K)

    for step in range(GRAPH_STEPS):
        twin = {k: v.clone() for k, v in backend.cache.items()}
        toks = backend.slot_tokens.clone()
        torch.cuda.synchronize()
        reset_launches(mods)
        ev[0].record()
        t0 = time.perf_counter()
        ref, _ = model.decode_step(params, toks, twin)
        host["eager"].append(time.perf_counter() - t0)
        ev[1].record()
        torch.cuda.synchronize()
        eager = counts()
        reset_launches(mods)
        ev[2].record()
        t0 = time.perf_counter()
        got = g()
        host["graph"].append(time.perf_counter() - t0)
        ev[3].record()
        torch.cuda.synchronize()
        span["eager"].append(ev[0].elapsed_time(ev[1]))
        span["graph"].append(ev[2].elapsed_time(ev[3]))
        faults = [what for what, same in (
            ("logits", torch.equal(got, ref)),
            ("tokens", torch.equal(backend.slot_tokens[:, 0],
                                   ref.argmax(-1))),
            ("cache", all(torch.equal(backend.cache[k], v)
                          for k, v in twin.items())),
            ("launch counts", counts() == eager)) if not same]
        if faults:
            raise SystemExit(
                f"{name}: graph step {step} differs from the eager step in "
                f"{faults}: max |logit diff| "
                f"{(got - ref).abs().max().item()}, counts {counts()} "
                f"against {eager}")
        del twin
    launched, cases, loops = eager
    GRAPH_NODES[(model.cfg.name, model.policy.fmt)
                + (("kv_quant",) if model.kv_quant else ())] = \
        collections.Counter(names)
    want = {"quant_matmul": sum(launched[e] for e in K.ENTRY_POINTS),
            "flash_attention": launched[FK.NAME],
            "paged_attention": launched[PK.NAME],
            "fused": sum(launched[n] for n in FU.NAMES)}
    if nodes != want:
        raise SystemExit(f"{name}: the graph's kernel nodes {nodes}, the "
                         f"eager step's launches {want}")
    fused = {n: launched[n] for n in FU.NAMES}
    if fused != fused_launches(model.cfg)[1]:
        raise SystemExit(f"{name}: a step launched the fused kernels "
                         f"{fused}, not {fused_launches(model.cfg)[1]}")
    mean = statistics.mean
    return {"run_decode_steps": steps, "run_replays": run_replays,
            "check_steps": GRAPH_STEPS, "logits_bit_identical": True,
            "tokens_identical": True, "cache_identical": True,
            "launches_per_step": {k: n for k, n in launched.items() if n},
            "paged_cases_per_step": cases,
            "quant_loops_per_step": {k: c for k, c in loops.items()
                                     if any(c.values())},
            "graph_kernel_nodes": nodes,
            "graph_kernel_nodes_all": len(names),
            "run_first_step_ms": 1e3 * walls[0],
            "run_capture_step_ms": 1e3 * walls[1],
            "eager_host_us_per_step": 1e6 * mean(host["eager"]),
            "graph_host_us_per_step": 1e6 * mean(host["graph"]),
            "eager_device_span_ms_per_step": mean(span["eager"]),
            "graph_device_ms_per_step": mean(span["graph"])}


def _logit_check(torch, cfg, fmt, con, seq) -> float:
    """Each request's batched prefill logits against its own sequential
    prefill: the worst max |diff| over max |logit|, within
    PREFILL_LOGIT_TOL."""
    worst = 0.0
    for rc, rs in zip(con.requests, seq.requests):
        a = con.engine.backend.first_logits[rc.req_id]
        b = seq.engine.backend.first_logits[rs.req_id]
        if not torch.isfinite(a).all():
            raise SystemExit(f"{cfg.name} {fmt}: non-finite prefill logits")
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    if not worst <= PREFILL_LOGIT_TOL[fmt]:
        raise SystemExit(f"{cfg.name} {fmt}: batched prefill logits differ "
                         f"from the sequential run by {worst} > "
                         f"{PREFILL_LOGIT_TOL[fmt]}")
    return worst


def serve_cell(torch, mods, cfg, fmt, kw) -> dict:
    """One format of one config at full width: weights from seed 0 (each
    layer quantized as it is drawn), a timed continuous run under the
    power sampler with its launch checks, and the prefill-logit check of
    a continuous and a sequential run. For MoE that pair runs under a
    capacity that drops nothing (E / top_k: an expert's buffer holds
    every token routed with it), on the same weights: capacity drops
    depend on how many tokens are routed together, so a batched prefill
    and a request's own prefill may rightly drop different assignments
    under the config's capacity. With ``kv_quant`` in ``kw`` the model
    keeps an int8 KV cache; for it and a windowed model the serve line
    adds a teacher-forced decode through the paged kernel against its
    plain version (:func:`teacher_forced`), and a windowed model a second
    one from a prefill padded past its ring (PAST_RING_LENS into
    PAST_RING_BUF slots). Prints the serve line; returns the timed run's
    launch counts."""
    import dataclasses
    from repro_torch.launch.serve import build_params, serve
    from repro_torch.models.api import build_model
    t0 = time.perf_counter()
    kv_quant = kw.get("kv_quant", False)
    model = build_model(cfg, fmt=fmt, kv_quant=kv_quant, device="cuda")
    params = build_params(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    con, watts = sampled_power(lambda: serve(
        model=model, params=params, mode="continuous", **kw))
    counts, loops = _check_run(torch, mods, cfg, fmt, con, "continuous",
                               kw["max_batch"], kv_quant)
    cases = dict(mods[2].CASES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    line = {"phase": "serve", "fmt": fmt, "model": cfg.name,
            "family": cfg.family, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "kv_quant": kv_quant}
    line["decode_graph"] = graph_check(torch, mods, model, params,
                                       con.engine.backend)
    pair_model, pair_con = model, con
    if cfg.is_moe:
        line["capacity_factor"] = cfg.moe_capacity_factor
        line["dropped_fraction_per_prefill"] = [
            a["dropped_fraction"] for a in con.engine.backend.prefill_aux]
        nodrop = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
        pair_model = build_model(nodrop, fmt=fmt, kv_quant=kv_quant,
                                 device="cuda")
        reset_launches(mods)
        pair_con = serve(model=pair_model, params=params, mode="continuous",
                         **kw)
        _, pair_loops = _check_run(torch, mods, nodrop, fmt, pair_con,
                                   "continuous", kw["max_batch"], kv_quant)
        dropped = [a["dropped_fraction"]
                   for a in pair_con.engine.backend.prefill_aux]
        if any(d != 0.0 for d in dropped):
            raise SystemExit(f"{cfg.name} {fmt}: the no-drop capacity "
                             f"dropped {dropped}")
        line["logit_pair_capacity_factor"] = nodrop.moe_capacity_factor
        loops = {"continuous": loops, "no_drop_continuous": pair_loops}
    else:
        loops = {"continuous": loops}
    reset_launches(mods)
    seq = serve(model=pair_model, params=params, mode="sequential", **kw)
    _, loops["sequential"] = _check_run(torch, mods, pair_model.cfg, fmt,
                                        seq, "sequential", kw["max_batch"])
    worst = _logit_check(torch, cfg, fmt, pair_con, seq)
    if kv_quant or cfg.sliding_window:
        PK = mods[2]
        two = con.requests[:2]
        lengths = torch.tensor([r.prompt_len for r in two],
                               dtype=torch.int32, device="cuda")
        toks = torch.zeros((2, int(lengths.max())), dtype=torch.long,
                           device="cuda")
        for i, r in enumerate(two):
            toks[i, :r.prompt_len] = torch.from_numpy(r.prompt)
        line["teacher_forced"] = teacher_forced(
            torch, PK, model, params, toks, lengths, kw["buf_len"])
        if cfg.sliding_window:
            gen = torch.Generator(device="cuda").manual_seed(4)
            lens = torch.tensor(PAST_RING_LENS, dtype=torch.int32,
                                device="cuda")
            toks = torch.randint(0, cfg.vocab_size, (2, max(PAST_RING_LENS)),
                                 generator=gen, device="cuda")
            line["past_ring"] = teacher_forced(torch, PK, model, params, toks,
                                               lens, PAST_RING_BUF)
            if not line["past_ring"]["pad_slots_after_prefill"]:
                raise SystemExit(f"{cfg.name}: the prefill past its ring "
                                 f"left no pad slot inside it")
    same = sum(rc.generated == rs.generated
               for rc, rs in zip(pair_con.requests, seq.requests))
    tok_same = sum(x == y for rc, rs in zip(pair_con.requests, seq.requests)
                   for x, y in zip(rc.generated, rs.generated))
    n_tok = sum(len(r.generated) for r in con.requests)
    # host wall times of the executed phases (latency_s is the analytic
    # clock)
    phases = con.engine.backend.phases
    pre = [p.wall_s for p in phases if p.phase == "prefill"]
    dec = [p.wall_s for p in phases if p.phase == "decode"]
    rep = con.report
    analytic = {"j_per_token": 3600.0 * rep.mean_energy_per_token_wh,
                "total_energy_j": rep.total_energy_j,
                "wall_time_s": rep.wall_time_s,
                "mean_batch": rep.mean_batch}
    if not (all(math.isfinite(v) and v > 0 for v in analytic.values())
            and rep.n_decode_steps == len(dec)):
        raise SystemExit(f"{cfg.name} {fmt}: analytic report {analytic}, "
                         f"{rep.n_decode_steps} decode steps")
    mean_w = sum(watts) / len(watts)
    line.update({
        "requests": len(con.requests),
        "prompt_lens": [r.prompt_len for r in con.requests],
        "generated_tokens": n_tok, "init_s": init_s,
        "wall_s": con.wall_s, "tokens_per_s": n_tok / con.wall_s,
        "prefill_phases": len(pre),
        "prefill_ms_mean": 1e3 * sum(pre) / len(pre),
        "decode_steps": len(dec),
        "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
        "decode_ms_median": 1e3 * statistics.median(dec),
        "analytic": analytic,
        "measured": {"power_w_mean": mean_w, "samples": len(watts),
                     "power_w": watts, "interval_s": 0.1,
                     "j_per_token": mean_w * con.wall_s / n_tok},
        "peak_mem_gb": peak_gb, "launches": counts,
        "paged_launches_by_case": cases, "quant_loops": loops,
        "prefill_logit_rel_err": worst,
        "prefill_logit_tol": PREFILL_LOGIT_TOL[fmt],
        "requests_same_tokens_as_sequential": same / len(con.requests),
        "tokens_same_as_sequential": tok_same / n_tok})
    emit(line)
    del model, params, con, seq, pair_model, pair_con
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts, **{f"paged_attention.{case}": n
                           for case, n in cases.items()})


def _stub_inputs(torch, cfg, req_id: int):
    """A request's seeded stub input on the card: its (num_patches, D)
    patch embeddings (vlm) or (T_ENC, D) frame embeddings (audio), f32
    times 0.1; None for the other families."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + req_id)
    rows = {"vlm": cfg.num_patches, "audio": T_ENC}.get(cfg.family)
    if rows is None:
        return None
    return torch.randn((rows, cfg.d_model), generator=gen,
                       device="cuda") * 0.1


def _model_prefill(torch, model, params, reqs, stubs):
    """One prefill of ``reqs`` with ``lengths``, their stubs stacked in
    front (vlm) or as the encoder's input (audio), padded and with the
    ring of :func:`_model_geometry`. Returns (logits, cache, (rows, padded
    length, stub prefix, the cache's ring length), encoder rows)."""
    cfg = model.cfg
    pad, prefix, buf_len = _model_geometry(cfg, [r.prompt_len
                                                 for r in reqs])
    toks = torch.zeros((len(reqs), pad), dtype=torch.long, device="cuda")
    for j, r in enumerate(reqs):
        toks[j, :r.prompt_len] = torch.as_tensor(r.prompt, device="cuda")
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = torch.stack(stubs)
    enc_rows = []
    if cfg.family == "audio":
        batch["frames"] = torch.stack(stubs)
        enc_rows = [len(reqs) * T_ENC]
    lengths = torch.as_tensor([r.prompt_len for r in reqs],
                              dtype=torch.int32, device="cuda")
    logits, cache = model.prefill(params, batch, buf_len=buf_len,
                                  lengths=lengths)
    return (logits, cache, (len(reqs), pad, prefix, cache["k"].shape[2]),
            enc_rows)


def model_cell(torch, mods, cfg, fmt) -> dict:
    """One format of a MODEL_CELLS config at full width and depth, weights
    from seed 0: MODEL_TRAFFIC's prompts, MODEL_PAIR at a time, each
    request with its own stub input, a prefill and new_tokens greedy
    decode steps, under the launch checks (flash per prefill and paged
    per step of :func:`attention_launches`, the quant loops); then each
    request's own prefill, whose logits the batched prefill must match
    within PREFILL_LOGIT_TOL. Its prefills' shapes and rings must be
    :func:`model_prefills`', at which the kernel phase held the kernels.
    Prints the model line (host wall times, tokens/s, peak memory);
    returns the batched run's launch counts."""
    from repro_torch.launch.serve import build_params, make_requests
    from repro_torch.models.api import build_model
    kw = MODEL_TRAFFIC
    t0 = time.perf_counter()
    model = build_model(cfg, fmt=fmt, device="cuda")
    params = build_params(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(cfg.vocab_size, kw["n"], kw["seed"],
                         kw["prompt_len"], kw["new_tokens"])
    stubs = [_stub_inputs(torch, cfg, r.req_id) for r in reqs]
    steps = kw["new_tokens"][1]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    tokens, enc_rows, pre_s, dec_s, first = [], [], [], [], []
    ran = []
    t_run = time.perf_counter()
    for i in range(0, len(reqs), MODEL_PAIR):
        pair = reqs[i:i + MODEL_PAIR]
        t0 = time.perf_counter()
        logits, cache, geom, enc = _model_prefill(
            torch, model, params, pair, stubs[i:i + MODEL_PAIR])
        tok = torch.argmax(logits, -1)[:, None]
        for j, r in enumerate(pair):
            r.generated = [int(tok[j, 0])]
        pre_s.append(time.perf_counter() - t0)
        first.append(logits.float().cpu())
        ran.append((*geom, True))
        tokens.append(geom[0] * (geom[1] + geom[2]))
        enc_rows += enc
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, cache)
            tok = torch.argmax(logits, -1)[:, None]
            for j, r in enumerate(pair):
                r.generated.append(int(tok[j, 0]))
            dec_s.append(time.perf_counter() - t0)
            tokens.append(len(pair))
        del cache
    wall_s = time.perf_counter() - t_run
    counts = read_launches(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_attention_launches(cfg, fmt, counts, len(pre_s), len(dec_s))
    loops = {"batched": check_quant_loops(cfg, fmt, read_loops(mods[0]),
                                          tokens, "batched", enc_rows)}
    for r in reqs:
        if len(r.generated) != steps + 1 or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            raise SystemExit(f"{cfg.name} {fmt}: request {r.req_id} got "
                             f"{r.generated}")
    # each request's own prefill against its row of the batched one
    reset_launches(mods)
    worst, own_tokens, own_enc = 0.0, [], []
    for i, r in enumerate(reqs):
        logits, _, geom, enc = _model_prefill(torch, model, params, [r],
                                              [stubs[i]])
        ran.append((*geom, False))
        own_tokens.append(geom[0] * (geom[1] + geom[2]))
        own_enc += enc
        a = first[i // MODEL_PAIR][i % MODEL_PAIR]
        b = logits[0].float().cpu()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"{cfg.name} {fmt}: non-finite prefill logits")
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    check_attention_launches(cfg, fmt, read_launches(mods), len(reqs), 0)
    if ran != model_prefills(cfg):
        raise SystemExit(f"{cfg.name} {fmt}: the run's prefills {ran} are "
                         f"not those the attention and quant cells were "
                         f"derived from, {model_prefills(cfg)}")
    loops["own_prefill"] = check_quant_loops(
        cfg, fmt, read_loops(mods[0]), own_tokens, "own prefill", own_enc)
    if not worst <= PREFILL_LOGIT_TOL[fmt]:
        raise SystemExit(f"{cfg.name} {fmt}: batched prefill logits differ "
                         f"from each request's own prefill by {worst} > "
                         f"{PREFILL_LOGIT_TOL[fmt]}")
    n_tok = sum(len(r.generated) for r in reqs)
    emit({"phase": "model", "fmt": fmt, "model": cfg.name,
          "family": cfg.family, "layers": cfg.num_layers,
          "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
          "stub_rows": stubs[0].shape[0], "requests": len(reqs),
          "batch": MODEL_PAIR,
          "prompt_lens": [r.prompt_len for r in reqs],
          "generated_tokens": n_tok, "init_s": init_s, "wall_s": wall_s,
          "tokens_per_s": n_tok / wall_s, "prefill_phases": len(pre_s),
          "prefill_ms_mean": 1e3 * sum(pre_s) / len(pre_s),
          "decode_steps": len(dec_s),
          "decode_ms_per_step": 1e3 * sum(dec_s) / len(dec_s),
          "peak_mem_gb": peak_gb, "launches": counts, "quant_loops": loops,
          "prefill_logit_rel_err": worst,
          "prefill_logit_tol": PREFILL_LOGIT_TOL[fmt]})
    del model, params, stubs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def model_phase(torch, mods) -> dict:
    """Every MODEL_CELLS config in each of its formats; the batched runs'
    launch counts by (arch, format, "model")."""
    from repro_torch.launch.serve import arch_config
    return {(arch, fmt, "model"): model_cell(torch, mods, arch_config(arch),
                                             fmt)
            for arch, formats in MODEL_CELLS for fmt in formats}


def serve_phase(torch, mods) -> dict:
    """Every SERVE_CELLS config in each of its formats; the timed runs'
    launch counts by (arch, format) and (arch, format, "kv_quant"). Then a
    ``graph_nodes`` line: each GRAPH_PAIRS cell's kernel nodes a replayed
    step beside its partner's, and the functions whose node counts
    differ."""
    from repro_torch.launch.serve import arch_config
    out = {(arch, fmt) + (("kv_quant",) if kw.get("kv_quant") else ()):
           serve_cell(torch, mods, arch_config(arch), fmt, kw)
           for arch, formats, kw in SERVE_CELLS for fmt in formats}
    pairs = []
    for a, b in GRAPH_PAIRS:
        na, nb = GRAPH_NODES[a], GRAPH_NODES[b]
        pairs.append({
            "cell": list(a), "nodes": sum(na.values()), "against": list(b),
            "against_nodes": sum(nb.values()),
            "differ": {f: [na[f], nb[f]] for f in sorted(set(na) | set(nb))
                       if na[f] != nb[f]}})
    ceilings = {"llama-3.1-8b": LLAMA_BF16_NODES_MAX,
                "mamba2-2.7b": MAMBA2_BF16_NODES_MAX,
                "zamba2-1.2b": ZAMBA2_BF16_NODES_MAX}
    nodes = {arch: GRAPH_NODES[(arch, "bfloat16")] for arch in ceilings}
    emit({"phase": "serve", "check": "graph_nodes", "pairs": pairs,
          **{f"{arch}_bf16_nodes": sum(n.values())
             for arch, n in nodes.items()},
          **{f"{arch}_bf16_fused_nodes": sum(
              k for f, k in n.items()
              if any(name in f for name in KERNEL_FUNCTIONS["fused"]))
             for arch, n in nodes.items()},
          "nodes_max": ceilings})
    for arch, most in ceilings.items():
        if sum(nodes[arch].values()) > most:
            raise SystemExit(f"serve: a {arch} bf16 replay has "
                             f"{sum(nodes[arch].values())} kernel nodes, "
                             f"more than {most}")
    return out


def arrival_requests(cfg, pattern: str) -> list:
    """ARRIVAL's requests (``paper_requests``, prompt ids from seed + 1)
    arriving in ``pattern``."""
    from repro_torch.serving.arrival import (fixed_arrivals, paper_requests,
                                             poisson_arrivals)
    n = ARRIVAL["n"]
    times = {"burst": lambda: [0.0] * n,
             "fixed_50ms": lambda: fixed_arrivals(n, 0.05),
             "poisson_20": lambda: poisson_arrivals(n, 20.0, seed=0)}
    return paper_requests(n, times[pattern](), seed=ARRIVAL["seed"],
                          prompt_range=ARRIVAL["prompt_range"],
                          output_range=ARRIVAL["output_range"],
                          vocab_size=cfg.vocab_size)


def arrival_engine(cfg, fmt, policy, **kw):
    """A ServeEngine of ``cfg`` under ``fmt`` with ARRIVAL's batch limits
    and the run's batch ``policy``."""
    from repro_torch.batching.policy import make_batch_policy
    from repro_torch.serving.engine import ServeEngine
    name, params = policy or ("slot_count", {})
    return ServeEngine(cfg, fmt=fmt, batch_policy=make_batch_policy(
        name, max_batch=ARRIVAL["max_batch"],
        max_prefill_batch=ARRIVAL["max_prefill_batch"], **params), **kw)


def arrival_scheduler(spec):
    from repro_torch.serving.scheduler import make_scheduler
    return make_scheduler(spec[0], **spec[1]) if spec else None


@functools.lru_cache(maxsize=None)
def arrival_plan() -> dict:
    """Each ARRIVAL_RUNS run served on the analytic backend alone (no
    card): {(run, fmt): (report, power trace, the (rows, padded length)
    of each prefill the executed backend runs, the naive sequential
    report of the same requests)}. The executed run must give the same
    report, trace and prefills: the kernel phase holds the kernels at
    these shapes."""
    from repro_torch.launch.serve import arch_config
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.trace import PowerTrace
    cfg = arch_config(ARRIVAL_ARCH)
    plan = {}
    for run, fmt, pattern, sched, policy in ARRIVAL_RUNS:
        backend = _shape_backend(cfg, fmt, ARRIVAL["buf_len"])
        trace = PowerTrace()
        rep = arrival_engine(cfg, fmt, policy, backend=backend).run(
            arrival_requests(cfg, pattern),
            scheduler=arrival_scheduler(sched), trace=trace)
        naive = ServeEngine(cfg, fmt=fmt, mode="sequential").run(
            arrival_requests(cfg, pattern))
        plan[(run, fmt)] = (rep, trace, backend.shapes, naive)
    return plan


def arrival_cells() -> tuple:
    """(flash causal cells, paged cells, {fmt: quant rows}) of the
    arrival runs (:func:`arrival_plan`): flash over each executed prefill
    (B, padded length) and each request's own prefill of the logit runs
    (1, its prompt rounded up to 8); paged over max_batch lanes of
    buf_len slots; the quant projections at each prefill's rows times
    its length and at max_batch rows."""
    from repro_torch.launch.serve import arch_config
    cfg = arch_config(ARRIVAL_ARCH)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    plan = arrival_plan()
    flash, rows = [], {}
    for (run, fmt), (_, _, shapes, _) in plan.items():
        flash += [(B, S, heads, None) for B, S in shapes]
        rows.setdefault(fmt, set()).update(
            [B * S for B, S in shapes] + [ARRIVAL["max_batch"]])
    flash += [(1, -(-r.prompt_len // 8) * 8, heads, None)
              for run in ARRIVAL_LOGIT_RUNS
              for r in plan[run][0].requests]
    paged = [(ARRIVAL["max_batch"], ARRIVAL["buf_len"], heads)]
    return list(dict.fromkeys(flash)), paged, rows


def _report_fields(rep) -> tuple:
    """Every energy, clock and count field of a ServeReport, and each
    request's id, times, energy and tokens, in request order."""
    return (rep.total_energy_j, rep.busy_energy_j, rep.idle_energy_j,
            rep.gated_energy_j, rep.wall_time_s, rep.busy_time_s,
            rep.idle_time_s, rep.gated_time_s, rep.mean_batch,
            rep.n_prefill_batches, rep.n_decode_steps,
            rep.prefill_computed_tokens, rep.prefill_effective_tokens,
            rep.prefill_chunks,
            tuple((r.req_id, r.t_prefill_start, r.t_first_token, r.t_done,
                   r.energy_j, r.tokens_generated) for r in rep.requests))


def _own_prefill_check(torch, model, params, res,
                       name: str = "arrival") -> float:
    """Each request's batched first-token logits against its own prefill
    (one row, padded to a multiple of 8, the backend's ring): the worst
    max |diff| over max |logit|, within PREFILL_LOGIT_TOL."""
    fmt = model.policy.fmt
    worst = 0.0
    for r in res.requests:
        pad = -(-r.prompt_len // 8) * 8
        toks = torch.zeros((1, pad), dtype=torch.long, device="cuda")
        toks[0, :r.prompt_len] = torch.as_tensor(r.prompt, device="cuda")
        lengths = torch.tensor([r.prompt_len], dtype=torch.int32,
                               device="cuda")
        logits, _ = model.prefill(params, {"tokens": toks},
                                  buf_len=ARRIVAL["buf_len"],
                                  lengths=lengths)
        a = res.engine.backend.first_logits[r.req_id]
        b = logits[0].float().cpu()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"{name} {fmt}: non-finite prefill logits")
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    if not worst <= PREFILL_LOGIT_TOL[fmt]:
        raise SystemExit(f"{name} {fmt}: batched prefill logits differ "
                         f"from each request's own prefill by {worst} > "
                         f"{PREFILL_LOGIT_TOL[fmt]}")
    return worst


def arrival_cell(torch, mods, cfg, fmt) -> dict:
    """ARRIVAL_RUNS' runs of ``fmt`` on llama-3.1-8b at full width and
    depth, weights from seed 0: each run through a ServeEngine on the
    ExecutedBackend with a PowerTrace, under :func:`_check_run`'s
    launch checks. Each request must be DONE; the run's prefill shapes,
    report and per-request times and energies must equal its
    :func:`arrival_plan` (the analytic backend's) float for float, its
    power trace must equal the analytic run's segment for segment and
    cover the report's total energy (1.0 within 1e-12: the trace sums
    its merged segments in another order than the report). Prints an
    arrival line a run; returns each run's launch counts."""
    from repro_torch.launch.serve import ServeResult, build_params
    from repro_torch.models.api import build_model
    from repro_torch.serving.backend import ExecutedBackend
    from repro_torch.serving.requests import RequestStatus
    from repro_torch.serving.trace import PowerTrace
    t0 = time.perf_counter()
    model = build_model(cfg, fmt=fmt, device="cuda")
    params = build_params(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {}
    for run, run_fmt, pattern, sched, policy in ARRIVAL_RUNS:
        if run_fmt != fmt:
            continue
        want, want_trace, shapes, naive = arrival_plan()[(run, fmt)]
        reqs = arrival_requests(cfg, pattern)
        backend = ExecutedBackend(
            cfg, model, params, max_batch=ARRIVAL["max_batch"],
            buf_len=ARRIVAL["buf_len"],
            record_logits=(run, fmt) in ARRIVAL_LOGIT_RUNS)
        eng = arrival_engine(cfg, fmt, policy, backend=backend)
        trace = PowerTrace()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        t0 = time.perf_counter()
        rep = eng.run(reqs, scheduler=arrival_scheduler(sched), trace=trace)
        torch.cuda.synchronize()
        res = ServeResult(requests=reqs, engine=eng, model=model,
                          params=params, wall_s=time.perf_counter() - t0,
                          report=rep)
        counts, loops = _check_run(torch, mods, cfg, fmt, res, "continuous",
                                   ARRIVAL["max_batch"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        name = f"{run} {fmt}"
        if any(r.status is not RequestStatus.DONE for r in reqs):
            raise SystemExit(f"arrival {name}: a request is not done")
        if [tuple(x) for x in backend.prefill_shapes] != shapes:
            raise SystemExit(f"arrival {name}: prefills "
                             f"{backend.prefill_shapes}, not those the "
                             f"kernel cells were derived from, {shapes}")
        if (_report_fields(rep) != _report_fields(want)
                or trace.as_dict() != want_trace.as_dict()):
            raise SystemExit(f"arrival {name}: the executed report or "
                             f"trace is not the analytic engine's")
        coverage = trace.coverage(rep.total_energy_j)
        if not abs(coverage - 1.0) <= 1e-12:
            raise SystemExit(f"arrival {name}: trace coverage {coverage}")
        worst = (_own_prefill_check(torch, model, params, res)
                 if (run, fmt) in ARRIVAL_LOGIT_RUNS else None)
        phases = backend.phases
        pre = [p.wall_s for p in phases
               if p.phase == "prefill" and p.wall_s is not None]
        dec = [p.wall_s for p in phases if p.phase == "decode"]
        n = len(reqs)
        j_req = rep.total_energy_j / n
        naive_j = naive.total_energy_j / n
        emit({"phase": "arrival", "run": run, "fmt": fmt,
              "model": cfg.name, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "pattern": pattern,
              "scheduler": sched,
              "batch_policy": policy or ("slot_count", {}), **ARRIVAL,
              "init_s": init_s,
              "arrivals_s": [r.arrival_time for r in reqs],
              "prompt_lens": [r.prompt_len for r in reqs],
              "new_tokens": [r.max_new_tokens for r in reqs],
              "prefill_shapes": [list(x) for x in backend.prefill_shapes],
              "prefill_phases": rep.n_prefill_batches,
              "prefill_chunks": rep.prefill_chunks,
              "decode_steps": len(dec), "host_wall_s": res.wall_s,
              "prefill_ms_mean": 1e3 * sum(pre) / len(pre),
              "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
              "decode_ms_median": 1e3 * statistics.median(dec),
              "peak_mem_gb": peak_gb,
              # the idle gaps are simulated, not slept on the card: every
              # energy and clock here is the analytic model's
              "analytic": {
                  "j_per_request": j_req,
                  "total_energy_j": rep.total_energy_j,
                  "busy_energy_j": rep.busy_energy_j,
                  "idle_energy_j": rep.idle_energy_j,
                  "gated_energy_j": rep.gated_energy_j,
                  "clock_s": rep.wall_time_s,
                  "mean_batch": rep.mean_batch,
                  "mean_ttft_s": rep.mean_ttft_s,
                  "naive_sequential_j_per_request": naive_j,
                  "naive_over_run": naive_j / j_req},
              "report_equals_analytic_engine": True,
              "trace_segments": len(trace.segments),
              "trace_coverage": coverage,
              "launches": counts, "quant_loops": loops,
              "prefill_logit_rel_err": worst})
        out[(cfg.name, fmt, run)] = counts
        del backend, eng, res
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def arrival_phase(torch, mods) -> dict:
    """The arrival runs in each format; launch counts by (arch, format,
    run)."""
    from repro_torch.launch.serve import arch_config
    cfg = arch_config(ARRIVAL_ARCH)
    out = {}
    for fmt in dict.fromkeys(fmt for _, fmt, *_ in ARRIVAL_RUNS):
        out.update(arrival_cell(torch, mods, cfg, fmt))
    return out


# the orchestration phase: llama-3.1-8b at full width and depth, weights
# from seed 0, every replica an ExecutedBackend with ORCH's batch limits
# and rings of buf_len slots; replicas of one run share the weights, each
# keeps its own decode cache
ORCH_ARCH = "llama-3.1-8b"
ORCH = dict(max_batch=8, max_prefill_batch=4, buf_len=4096)
# the request runs' traffic: 16 of the paper's prompts (200-4000 tokens),
# outputs cut from 10-300 to 10-64 for the time limit
ORCH_REQUESTS = dict(n=16, seed=0, prompt_range=(200, 4000),
                     output_range=(10, 64))
# workflow traffic: (template, tasks, seconds between tasks, parameters),
# cut from the templates' defaults (agent rounds 4 -> 3, base prompt
# 3072 -> 2560, outputs 48-256 -> 32-96) so that every prompt plus its
# outputs stays within buf_len and the phase within the time limit
ORCH_WORKFLOWS = {
    "agent": ("agent_loop", 4, 0.2, dict(rounds=3,
                                         base_prompt=(1536, 2560),
                                         round_out=(32, 96))),
    "fanout": ("fan_out", 2, 0.5, dict(n=4, prompt=(512, 2048),
                                       sample_out=(32, 96),
                                       join_out=(32, 96))),
}
# (run, format, replicas, router, traffic, fault, controller): traffic is
# a workflow of ORCH_WORKFLOWS or the requests arriving Poisson at 20/s
# (seed 0) or every 100 ms; fault "crash_mid" crashes the one engine
# halfway through its analytic run without faults for 0.5 s,
# "crash_replica_1" crashes replica 1 halfway through the cluster's for
# good, both under make_retry("backoff")
ORCH_RUNS = [
    ("wf-agent", "bfloat16", 1, None, "agent", None, None),
    ("wf-fanout", "int8", 1, None, "fanout", None, None),
    ("cluster-rr", "bfloat16", 2, "round_robin", "poisson_20", None, None),
    ("cluster-gated", "bfloat16", 2, "energy_aware_gated", "fixed_100ms",
     None, None),
    ("cluster-wf", "bfloat16", 2, "least_loaded", "agent", None, None),
    ("fault-retry", "bfloat16", 1, None, "poisson_20", "crash_mid", None),
    ("cluster-fault", "int8", 2, "least_loaded", "poisson_20",
     "crash_replica_1", None),
    ("control-mpc", "bfloat16", 1, None, "poisson_20", None, "mpc"),
]
ORCH_CONTROL_INTERVAL_S = 0.5
# the run whose children's prompts and first-token logits are checked
ORCH_LOGIT_RUN = "wf-agent"


def orch_traffic(cfg, traffic: str) -> tuple:
    """Fresh (requests, workflow source or None) of one traffic."""
    import numpy as np
    from repro_torch.serving.arrival import (fixed_arrivals, paper_requests,
                                             poisson_arrivals)
    from repro_torch.workflows import WorkflowSource, make_workflow
    if traffic in ORCH_WORKFLOWS:
        template, n, gap, params = ORCH_WORKFLOWS[traffic]
        rng = np.random.default_rng(0)
        source = WorkflowSource(
            [make_workflow(template, rng, **params) for _ in range(n)],
            [gap * i for i in range(n)], reuse_prefix=True,
            vocab_size=cfg.vocab_size, seed=0)
        return source.initial(), source
    n = ORCH_REQUESTS["n"]
    times = {"poisson_20": lambda: poisson_arrivals(n, 20.0, seed=0),
             "fixed_100ms": lambda: fixed_arrivals(n, 0.1)}[traffic]()
    return paper_requests(n, times, seed=ORCH_REQUESTS["seed"],
                          prompt_range=ORCH_REQUESTS["prompt_range"],
                          output_range=ORCH_REQUESTS["output_range"],
                          vocab_size=cfg.vocab_size), None


def orch_serve(cfg, run_spec, backends, faults=None) -> dict:
    """Serve one ORCH_RUNS run over ``backends`` (one a replica): a
    ServeEngine, or a ClusterEngine behind the run's router, with the
    run's source, controller and ``faults`` (a FaultSchedule) under
    backoff retries, on a PowerTrace."""
    from repro_torch.batching.policy import SlotCountPolicy
    from repro_torch.control import make_controller
    from repro_torch.faults import make_retry
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.router import make_router
    from repro_torch.serving.trace import PowerTrace
    run, fmt, n_rep, router, traffic, fault, control = run_spec
    reqs, source = orch_traffic(cfg, traffic)
    engines = [ServeEngine(cfg, backend=b, batch_policy=SlotCountPolicy(
        max_batch=ORCH["max_batch"],
        max_prefill_batch=ORCH["max_prefill_batch"])) for b in backends]
    target = (engines[0] if router is None
              else ClusterEngine(engines, make_router(router)))
    trace = PowerTrace()
    kw = {}
    if control is not None:
        kw.update(controller=make_controller(control),
                  control_interval_s=ORCH_CONTROL_INTERVAL_S)
    if faults is not None:
        kw.update(faults=faults, retry=make_retry("backoff"))
    t0 = time.perf_counter()
    rep = target.run(reqs, source=source, trace=trace, **kw)
    return {"report": rep, "trace": trace, "engines": engines,
            "wall_s": time.perf_counter() - t0, "requests": rep.requests,
            "retry": kw.get("retry")}


def _shape_backend(cfg, fmt, buf_len):
    """An AnalyticBackend that also records the (rows, padded length) of
    each prefill the ExecutedBackend would run (``shapes``, per run)."""
    from repro_torch.serving.backend import (AnalyticBackend,
                                             executed_prefill_shape)

    class Shapes(AnalyticBackend):
        def start(self):
            self.shapes = []

        def prefill(self, batch):
            shape = executed_prefill_shape(batch, buf_len)
            if shape is not None:
                self.shapes.append(shape)
            return super().prefill(batch)

    return Shapes(cfg, fmt=fmt)


@functools.lru_cache(maxsize=None)
def orch_plan() -> dict:
    """Each ORCH_RUNS run on analytic replicas alone (no card): {run:
    (compared fields, power trace, each replica's executed prefill
    shapes, the fault schedule, the report)}. A fault's instant comes
    from the same run without faults. The executed run must give the
    same fields, trace and prefills: the kernel phase holds the kernels
    at these shapes."""
    from repro_torch.faults import FaultSchedule
    from repro_torch.launch.serve import arch_config
    cfg = arch_config(ORCH_ARCH)
    plan = {}
    for spec in ORCH_RUNS:
        run, fmt, n_rep, _, _, fault, _ = spec
        faults = None
        if fault is not None:
            calm = orch_serve(cfg, spec, [
                _shape_backend(cfg, fmt, ORCH["buf_len"])
                for _ in range(n_rep)])["report"]
            t = 0.5 * calm.wall_time_s
            faults = FaultSchedule([
                dict(t=t, kind="crash", downtime_s=0.5)
                if fault == "crash_mid" else
                dict(t=t, kind="crash", replica=1, downtime_s=math.inf)])
        backends = [_shape_backend(cfg, fmt, ORCH["buf_len"])
                    for _ in range(n_rep)]
        res = orch_serve(cfg, spec, backends, faults)
        plan[run] = (_orch_fields(res["report"]), res["trace"].as_dict(),
                     [list(b.shapes) for b in backends], faults,
                     res["report"])
    return plan


def orch_cells() -> tuple:
    """(flash causal cells, paged cells, {fmt: quant rows}) of the
    orchestration runs (:func:`orch_plan`): flash over each executed
    prefill (B, padded length) of every replica and each request's own
    prefill of ORCH_LOGIT_RUN (1, its prompt rounded up to 8); paged
    over max_batch lanes of buf_len slots; the quant projections at each
    prefill's rows times its length and at max_batch rows."""
    from repro_torch.launch.serve import arch_config
    cfg = arch_config(ORCH_ARCH)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    plan = orch_plan()
    flash, rows = [], {}
    for run, fmt, *_ in ORCH_RUNS:
        shapes = [s for per in plan[run][2] for s in per]
        flash += [(B, S, heads, None) for B, S in shapes]
        rows.setdefault(fmt, set()).update(
            [B * S for B, S in shapes] + [ORCH["max_batch"]])
    flash += [(1, -(-r.prompt_len // 8) * 8, heads, None)
              for r in plan[ORCH_LOGIT_RUN][4].requests]
    paged = [(ORCH["max_batch"], ORCH["buf_len"], heads)]
    return list(dict.fromkeys(flash)), paged, rows


def _orch_fields(rep) -> tuple:
    """Every compared field of a ServeReport or a ClusterReport: the
    energies, clocks and counts, the fault counters, the summaries, each
    request's times, energies, status, attempts and workflow step, the
    task reports and the control telemetry without its host time."""
    import dataclasses

    def requests(reqs):
        return tuple((r.req_id, r.status.name, r.arrival_time,
                      r.release_time, r.t_prefill_start, r.t_first_token,
                      r.t_done, r.energy_j, r.wasted_energy_j,
                      r.tokens_generated, r.prefilled_tokens, r.n_attempts,
                      r.fail_reason, r.hedge_of, r.task_id, r.step,
                      r.kv_parent) for r in reqs)

    def serve(r):
        control = None if r.control is None else {
            k: v for k, v in r.control.items()
            if k != "controller_overhead_s"}
        return (_report_fields(r), r.n_failures, r.n_retries,
                r.wasted_energy_j, r.down_time_s, r.prefix_reused_tokens,
                r.n_relayed, r.summary(), requests(r.requests),
                requests(r.shed), control)

    tasks = tuple(dataclasses.astuple(t) for t in rep.tasks)
    if not hasattr(rep, "replica_reports"):
        return serve(rep), tasks
    return (tuple(serve(r) for r in rep.replica_reports), rep.summary(),
            rep.per_replica_summary(), rep.wall_time_s,
            rep.handoff_energy_j, rep.n_handoffs, requests(rep.failed),
            tasks)


def _check_orch_run(torch, mods, cfg, fmt, run, res) -> tuple:
    """The launch checks of one orchestration run (the counts set to 0
    before it), summed over its replicas' backends: every done request
    carries max_new_tokens tokens in the vocabulary; the quant kernel of
    the format only (:func:`check_quant_entries`), each launch on the
    loop its rows choose; one flash
    launch per layer and executed prefill, one paged per layer and
    decode step. Returns (launch counts, quant loops, host wall s of the
    executed prefills, of the decode steps)."""
    from repro_torch.serving.requests import RequestStatus
    counts = read_launches(mods)
    for r in res["requests"]:
        if r.status is not RequestStatus.DONE:
            continue
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            raise SystemExit(f"orchestration {run}: request {r.req_id} "
                             f"got {len(r.generated)} tokens of "
                             f"{r.max_new_tokens}, or one out of the "
                             f"vocabulary")
    check_quant_entries(cfg, fmt, counts, run)
    tokens, pre, dec, n_shapes = [], [], [], 0
    for eng in res["engines"]:
        b = eng.backend
        steps = [p for p in b.phases if p.phase == "decode"]
        tokens += ([B * S for B, S in b.prefill_shapes]
                   + [ORCH["max_batch"]] * len(steps))
        pre += [p.wall_s for p in b.phases if p.phase == "prefill"]
        dec += [p.wall_s for p in steps]
        n_shapes += len(b.prefill_shapes)
    # no chunked policy: every prefill phase runs the model, one shape each
    if None in pre or len(pre) != n_shapes:
        raise SystemExit(f"orchestration {run}: {len(pre)} prefill phases, "
                         f"{n_shapes} executed prefill shapes")
    loops = check_quant_loops(cfg, fmt, read_loops(mods[0]), tokens, run)
    check_attention_launches(cfg, fmt, counts, len(pre), len(dec))
    return counts, loops, pre, dec


def _prefix_parent(step: str):
    """The step a workflow step extends (``prefix_of`` in
    ORCH_WORKFLOWS' templates): an agent round its previous round, a
    fan-out join its first sample; None for a root."""
    if step == "join":
        return "sample_0"
    if step.startswith("round_") and step != "round_0":
        return f"round_{int(step[len('round_'):]) - 1}"
    return None


def _check_children(run, res) -> int:
    """Each workflow child's prompt starts with its parent's prompt and
    greedy generation (a child extends its prefix parent's context).
    Returns the children checked."""
    steps = {(r.task_id, r.step): r for r in res["requests"]}
    n = 0
    for r in res["requests"]:
        parent = _prefix_parent(r.step)
        if parent is None:
            continue
        p = steps[(r.task_id, parent)]
        ctx = list(p.prompt) + list(p.generated)
        if list(r.prompt[:len(ctx)]) != ctx:
            raise SystemExit(f"orchestration {run}: request {r.req_id}'s "
                             f"prompt does not extend its parent's "
                             f"prompt and generation")
        n += 1
    return n


def orch_cell(torch, mods, cfg, fmt) -> dict:
    """ORCH_RUNS' runs of ``fmt`` on llama-3.1-8b at full width and depth:
    each run on ExecutedBackend replicas that share one model, under
    :func:`_check_orch_run`'s launch checks. Its compared fields, power
    trace and each replica's prefill shapes must equal its analytic twin's
    (:func:`orch_plan`) float for float, the trace must cover the
    report's energy, a fault run must satisfy check_run_invariants, and
    ORCH_LOGIT_RUN's children must extend their parents and its
    first-token logits match each request's own prefill. Prints an
    orchestration line a run; returns each run's launch counts."""
    from repro_torch.faults import check_run_invariants
    from repro_torch.launch.serve import build_params
    from repro_torch.models.api import build_model
    from repro_torch.serving.backend import ExecutedBackend
    t0 = time.perf_counter()
    model = build_model(cfg, fmt=fmt, device="cuda")
    params = build_params(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {}
    for spec in ORCH_RUNS:
        run, run_fmt, n_rep, router, traffic, fault, control = spec
        if run_fmt != fmt:
            continue
        want, want_trace, shapes, faults, twin = orch_plan()[run]
        backends = [ExecutedBackend(cfg, model, params,
                                    max_batch=ORCH["max_batch"],
                                    buf_len=ORCH["buf_len"],
                                    record_logits=run == ORCH_LOGIT_RUN)
                    for _ in range(n_rep)]
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        res = orch_serve(cfg, spec, backends, faults)
        torch.cuda.synchronize()
        rep, trace = res["report"], res["trace"]
        counts, loops, pre, dec = _check_orch_run(torch, mods, cfg, fmt,
                                                  run, res)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        got_shapes = [[tuple(x) for x in b.prefill_shapes]
                      for b in backends]
        if got_shapes != shapes:
            raise SystemExit(f"orchestration {run}: prefills {got_shapes}, "
                             f"not those the kernel cells were derived "
                             f"from, {shapes}")
        if (_orch_fields(rep) != want
                or trace.as_dict() != want_trace):
            raise SystemExit(f"orchestration {run}: the executed report, "
                             f"requests, tasks or trace are not the "
                             f"analytic twin's")
        coverage = trace.coverage(rep.total_energy_j)
        if not abs(coverage - 1.0) <= 1e-12:
            raise SystemExit(f"orchestration {run}: trace coverage "
                             f"{coverage}")
        if faults is not None:
            check_run_invariants(rep, engines=res["engines"],
                                 retry=res["retry"], trace=trace)
            if not rep.n_failures:
                raise SystemExit(f"orchestration {run}: the crash failed "
                                 f"no request")
        children = worst = None
        if run == ORCH_LOGIT_RUN:
            children = _check_children(run, res)
            worst = _own_prefill_check(
                torch, model, params, SimpleNamespace(
                    requests=res["requests"],
                    engine=SimpleNamespace(backend=backends[0])),
                name=f"orchestration {run}")
        cluster = hasattr(rep, "replica_reports")
        reports = rep.replica_reports if cluster else [rep]
        n = rep.n
        line = {
            "phase": "orchestration", "run": run, "fmt": fmt,
            "model": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "replicas": n_rep, "router": router,
            "traffic": traffic, "fault": fault, "controller": control,
            **ORCH, "init_s": init_s, "requests": n,
            "prompt_lens": [r.prompt_len for r in res["requests"]],
            "new_tokens": [r.max_new_tokens for r in res["requests"]],
            "prefill_shapes": [[list(x) for x in s] for s in got_shapes],
            "prefill_phases": len(pre), "decode_steps": len(dec),
            "host_wall_s": res["wall_s"],
            "prefill_ms_mean": 1e3 * sum(pre) / len(pre),
            "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
            "decode_ms_median": 1e3 * statistics.median(dec),
            "peak_mem_gb": peak_gb,
            # idle gaps and downtime are simulated, not slept on the
            # card: every energy and clock here is the analytic model's
            "analytic": {
                "j_per_request": rep.total_energy_j / n,
                "total_energy_j": rep.total_energy_j,
                "busy_energy_j": rep.busy_energy_j,
                "idle_energy_j": rep.idle_energy_j,
                "gated_energy_j": rep.gated_energy_j,
                "wasted_energy_j": rep.wasted_energy_j,
                "clock_s": rep.wall_time_s,
                "n_completed": rep.n_completed,
                "n_failures": rep.n_failures,
                "n_retries": rep.n_retries,
                "down_time_s": rep.down_time_s},
            "equals_analytic_twin": True, "trace_coverage": coverage,
            "launches": counts, "quant_loops": loops}
        if cluster:
            line["requests_per_replica"] = rep.requests_per_replica
            line["utilization_per_replica"] = rep.utilization_per_replica
        if rep.tasks:
            line["prefix_reused_tokens"] = rep.prefix_reused_tokens
            line["task_latency_s"] = [t.latency_s for t in rep.tasks]
            line["tasks_completed"] = sum(t.completed for t in rep.tasks)
        if rep.control is not None:
            line["control"] = {k: rep.control[k] for k in
                               ("n_control_actions", "mean_freq_scale")}
        if children is not None:
            line["children_extend_parents"] = children
            line["prefill_logit_rel_err"] = worst
        emit(line)
        out[(cfg.name, fmt, run)] = counts
        del backends, res, reports
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def orchestration_phase(torch, mods) -> dict:
    """The orchestration runs in each format; launch counts by (arch,
    format, run)."""
    from repro_torch.launch.serve import arch_config
    cfg = arch_config(ORCH_ARCH)
    out = {}
    for fmt in dict.fromkeys(fmt for _, fmt, *_ in ORCH_RUNS):
        out.update(orch_cell(torch, mods, cfg, fmt))
    return out


# the api phase: executed specs of llama-3.1-8b at full width and depth,
# reached only through the port's public surface (repro_torch.sweep and
# ExperimentSpec.run) on the card; every prompt plus its outputs stays
# within the ring of buf_len slots
API_BASE = dict(model="llama-3.1-8b", backend="executed", n_requests=8,
                arrival="all_at_once", max_batch=8,
                prompt_range=(200, 960), output_range=(8, 32),
                buf_len=1024, seed=0)
# the sweep over formats: its grid labels and the runs they name
API_SWEEP = {"fmt": ["bfloat16", "int8"]}
API_SWEEP_RUNS = {"fmt=bfloat16": "api-burst", "fmt=int8": "api-burst-int8"}
# the vectorized fleet of two executed replicas (one shared model)
API_FLEET = dict(fleet="vector", replicas=2, router="round_robin",
                 arrival="poisson", arrival_params={"rate_per_s": 20.0})
API_RUNS = ("api-burst", "api-burst-int8", "api-fleet")


def api_specs() -> dict:
    """{run: ExperimentSpec} of API_RUNS: the sweep's grid points and
    the fleet spec."""
    from repro_torch import ExperimentSpec, expand_grid
    base = ExperimentSpec(**API_BASE)
    specs = {API_SWEEP_RUNS[label]: spec
             for label, spec in expand_grid(base, API_SWEEP)}
    specs["api-fleet"] = base.derive(**API_FLEET)
    return specs


@functools.lru_cache(maxsize=None)
def api_plan() -> dict:
    """Each API_RUNS spec's analytic twin (``backend="analytic"``) on the
    CPU: {run: (its record without spec_hash, the (rows, padded length)
    of each prefill the executed backend runs, per replica; prefill
    phases; decode steps)}. The shapes come from the twin's engine with
    each replica's backend recording them, and that run's record must be
    the twin's. The executed run must give the same record, prefills
    and steps: the kernel phase holds the kernels at these shapes."""
    from repro_torch.api import result_from_report
    plan = {}
    for run, spec in api_specs().items():
        twin = spec.derive(backend="analytic")
        record = twin.run().to_dict()
        record.pop("spec_hash")
        eng = twin.build_engine()
        engines = getattr(eng, "replicas", [eng])
        for e in engines:
            e.backend = _shape_backend(twin.model_config(), spec.fmt,
                                       spec.buf_len)
        rep = eng.run(twin.requests(), scheduler=twin.build_scheduler())
        again = result_from_report(twin, rep).to_dict()
        again.pop("spec_hash")
        if again != record:
            raise SystemExit(f"api {run}: the twin recording its prefill "
                             f"shapes is not the analytic twin")
        reports = getattr(rep, "replica_reports", [rep])
        plan[run] = (record, [list(e.backend.shapes) for e in engines],
                     sum(r.n_prefill_batches for r in reports),
                     sum(r.n_decode_steps for r in reports))
    return plan


def api_cells() -> tuple:
    """(flash causal cells, paged cells, {fmt: quant rows}) of the api
    runs (:func:`api_plan`): flash over each executed prefill (B, padded
    length); paged over max_batch lanes of buf_len slots; the quant
    projections at each prefill's rows times its length and at max_batch
    rows."""
    specs, plan = api_specs(), api_plan()
    flash, paged, rows = [], [], {}
    for run, spec in specs.items():
        cfg = spec.model_config()
        heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        shapes = [s for per in plan[run][1] for s in per]
        flash += [(B, S, heads, None) for B, S in shapes]
        paged.append((spec.max_batch, spec.buf_len, heads))
        rows.setdefault(spec.fmt, set()).update(
            [B * S for B, S in shapes] + [spec.max_batch])
    return list(dict.fromkeys(flash)), list(dict.fromkeys(paged)), rows


class _ApiWindows:
    """Observes the executed specs that the port's public API runs: each
    spec draws its shared weights once through
    ``repro_torch.api.executed_params``, so a wrapper of it opens the
    spec's window there (the previous spec's model freed, peak memory
    and the launch counts set to 0, the weights' draw timed) and closes
    the previous one (host wall from the draw to the next, launch counts,
    peak memory). It also records the token shape of each prefill the
    spec's model runs."""

    def __init__(self, torch, mods):
        self.torch, self.mods, self.windows = torch, mods, []

    def close(self) -> None:
        w = self.windows[-1] if self.windows else None
        if w is None or "wall_s" in w:
            return
        self.torch.cuda.synchronize()
        w.update(wall_s=time.perf_counter() - w["t0"],
                 counts=read_launches(self.mods),
                 loops=read_loops(self.mods[0]),
                 peak_gb=self.torch.cuda.max_memory_allocated() / 1e9)

    def executed_params(self, real, model):
        torch = self.torch
        self.close()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(self.mods)
        t0 = time.perf_counter()
        params = real(model)
        torch.cuda.synchronize()
        shapes = []
        prefill = model.prefill

        def recorded(params, batch, *args, **kw):
            shapes.append(tuple(batch["tokens"].shape))
            return prefill(params, batch, *args, **kw)

        model.prefill = recorded
        self.windows.append(dict(fmt=model.policy.fmt, t0=t0, shapes=shapes,
                                 build_s=time.perf_counter() - t0))
        return params


def _check_api_run(cfg, run, spec, res, w) -> dict:
    """The checks of one executed api run (its window ``w``): its record
    equals its analytic twin's on every field but spec_hash, every
    request generated max_new_tokens ids in the vocabulary, its prefills
    (token shapes, summed over the replicas) and decode steps are the
    twin's, and the launches over them are one flash a layer and
    prefill, one paged a layer and step and, under int8, the 2-D quant
    kernel on the loop its rows choose (224 calls a phase). Returns the
    run's line."""
    from repro_torch.serving.requests import RequestStatus
    record, shapes, n_pre, n_dec = api_plan()[run]
    got = res.to_dict()
    if got.pop("spec_hash") != spec.spec_hash() or got != record:
        raise SystemExit(f"api {run}: the executed record is not its "
                         f"analytic twin's")
    reports = getattr(res.report, "replica_reports", [res.report])
    reqs = [r for rep in reports for r in rep.requests]
    if len(reqs) != spec.n_requests:
        raise SystemExit(f"api {run}: {len(reqs)} requests served")
    for r in reqs:
        if (r.status is not RequestStatus.DONE
                or len(r.generated) != r.max_new_tokens
                or not all(0 <= t < cfg.vocab_size for t in r.generated)):
            raise SystemExit(f"api {run}: request {r.req_id} got "
                             f"{len(r.generated)} tokens of "
                             f"{r.max_new_tokens}, or one out of the "
                             f"vocabulary")
    pre = sum(rep.n_prefill_batches for rep in reports)
    dec = sum(rep.n_decode_steps for rep in reports)
    flat = sorted(tuple(s) for per in shapes for s in per)
    if (pre, dec) != (n_pre, n_dec) or sorted(w["shapes"]) != flat:
        raise SystemExit(f"api {run}: prefills {sorted(w['shapes'])} and "
                         f"{dec} decode steps, not the twin's {flat} and "
                         f"{n_dec}")
    counts = w["counts"]
    check_quant_entries(cfg, spec.fmt, counts, run)
    check_attention_launches(cfg, spec.fmt, counts, pre, dec)
    tokens = [B * S for B, S in flat] + [spec.max_batch] * dec
    loops = check_quant_loops(cfg, spec.fmt, w["loops"], tokens, run)
    n = res.n_requests
    return {
        "phase": "api", "run": run, "fmt": spec.fmt, "model": cfg.name,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "spec": spec.to_dict(), "spec_hash": spec.spec_hash(),
        "torch_device": "cuda", "kind": res.kind,
        "engine": type(res.report).__name__, "requests": n,
        "prompt_lens": [r.prompt_len for r in reqs],
        "new_tokens": [r.max_new_tokens for r in reqs],
        "prefill_shapes": [list(s) for s in flat],
        "prefill_phases": pre, "decode_steps": dec,
        "host_wall_s": w["wall_s"], "model_build_s": w["build_s"],
        "peak_mem_gb": w["peak_gb"],
        # every energy and clock of the record is the analytic model's
        "analytic": {"j_per_request": res.total_energy_j / n,
                     "total_energy_j": res.total_energy_j,
                     "idle_energy_j": res.idle_energy_j,
                     "gated_energy_j": res.gated_energy_j,
                     "clock_s": res.wall_time_s,
                     "mean_batch": res.mean_batch,
                     "requests_per_replica":
                         list(res.requests_per_replica)},
        "equals_analytic_twin": True, "launches": counts,
        "quant_loops": loops}


def api_phase(torch, mods) -> dict:
    """API_RUNS through the port's public surface on the card: one
    ``repro_torch.sweep`` over the formats (``cache=False``,
    ``workers=1``, ``torch_device="cuda"``) and the fleet spec's
    ``run(torch_device="cuda")``, each spec observed by
    :class:`_ApiWindows` and checked by :func:`_check_api_run`. Prints an
    api line a run; returns each run's launch counts."""
    import repro_torch
    from repro_torch import api
    specs = api_specs()
    cfg = specs["api-burst"].model_config()
    obs = _ApiWindows(torch, mods)
    real = api.executed_params
    api.executed_params = functools.partial(obs.executed_params, real)
    try:
        t0 = time.perf_counter()
        grid = repro_torch.sweep(repro_torch.ExperimentSpec(**API_BASE),
                                 API_SWEEP, cache=False, workers=1,
                                 torch_device="cuda")
        obs.close()
        sweep_s = time.perf_counter() - t0
        results = {API_SWEEP_RUNS[label]: r
                   for label, r in grid.results.items()}
        results["api-fleet"] = specs["api-fleet"].run(torch_device="cuda")
        obs.close()
    finally:
        api.executed_params = real
    if [w["fmt"] for w in obs.windows] != [specs[run].fmt
                                           for run in API_RUNS]:
        raise SystemExit(f"api: the specs drew weights in the formats "
                         f"{[w['fmt'] for w in obs.windows]}")
    out = {}
    for run, w in zip(API_RUNS, obs.windows):
        line = _check_api_run(cfg, run, specs[run], results[run], w)
        if run in API_SWEEP_RUNS.values():
            line["sweep_wall_s"] = sweep_s
        emit(line)
        out[(cfg.name, specs[run].fmt, run)] = w["counts"]
    del grid, results
    gc.collect()
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# train: the flash backward kernel, and training at full width
# ---------------------------------------------------------------------------
# the backward kernel's cells, (B, S, T, heads, causal, window):
# stablelm-1.6b's train shape, granite-moe-1b-a400m's GQA heads,
# h2o-danube-3-4b's head_dim 120 (also windowed), and seamless's
# unmasked cross-attention of a padded prompt over 64 frames
BWD_CELLS = [(4, 1024, 1024, STABLELM_HEADS, True, None),
             (4, 1024, 1024, GRANITE_HEADS, True, None),
             (2, 1024, 1024, H2O_HEADS, True, None),
             (2, 1024, 1024, H2O_HEADS, True, 256),
             (2, 256, T_ENC, SEAMLESS_HEADS, False, None)]
# backward kernel vs plain, each of dq, dk, dv: its max |kernel - plain|
# over its max |plain|. f32 sums the same f32 products in other orders;
# bf16 rounds each output once to bf16 (2^-8 of an element, below 4e-3 of
# the max)
BWD_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
HEADLINE_BWD = {"dtype": "bfloat16", "B": 4, "S": 1024, "H": 32, "Kv": 32,
                "d": 64, "window": None}
# full-width training: stablelm-1.6b in bf16 on SyntheticLM, B = 4,
# S = 1024, 20 AdamW steps from seed 0
TRAIN_ARCH = "stablelm-1.6b"
TRAIN = dict(batch=4, seq_len=1024, steps=20, lr=5e-4, warmup=5)
# the one-step checks run on a copy of the config cut to 2 layers
STEP_LAYERS = 2
# one bf16 step through the kernels against the same step through the
# plain versions, each gradient leaf: max |kernel - plain| over max
# |plain|. The two attentions round their outputs to bf16 at different
# points, and two layers of bf16 backward carry such one-ulp differences
# into every leaf; f32 carries only sums in other orders
STEP_GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-3}
# the served check after training: 2 prompts of 64 tokens, 8 greedy steps
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_NEW = 2, 64, 8
LAUNCHER = ["-m", "repro_torch.launch.train", "--arch",
            "granite-moe-1b-a400m", "--steps", "5", "--device", "cuda"]


def bwd_phase(torch, FK) -> list:
    """The flash backward kernel against ``flash_attention_backward_plain``
    at BWD_CELLS in bf16 and f32, on the forward kernel's own output and
    logsumexp: each of dq, dk, dv within BWD_REL_TOL; also SDPA's
    gradients against the plain version (reported, not gated). Times:
    the backward kernel alone, forward + backward through the autograd
    Function, the plain backward, SDPA forward + backward (the library),
    and SDPA's backward alone (``torch.autograd.grad`` on a forward graph
    kept with ``retain_graph``), eager; the bound is the larger of five
    products' FLOPs at the dtype's peak and the bytes at HBM
    bandwidth."""
    from repro_torch.kernels import cost
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in ATTN_DTYPES:
        td = getattr(torch, dtype)
        es = torch.finfo(td).bits // 8
        for B, S, T, (H, Kv, d), causal, window in BWD_CELLS:
            q, do = (torch.randn((B, S, H, d), generator=gen,
                                 device="cuda").to(td) for _ in range(2))
            k, v = (torch.randn((B, T, Kv, d), generator=gen,
                                device="cuda").to(td) for _ in range(2))
            kw = dict(causal=causal, window=window)
            out, lse = FK.flash_attention_forward(q, k, v, with_lse=True,
                                                  **kw)
            same = bool(torch.equal(out, FK.flash_attention(q, k, v, **kw)))
            got = FK.flash_attention_backward(q, k, v, out, lse, do, **kw)
            ref = FK.flash_attention_backward_plain(q, k, v, out, lse, do,
                                                    **kw)
            nodes = graph_nodes(torch, lambda: FK.flash_attention_backward(
                q, k, v, out, lse, do, **kw))
            allow = FK.visible(S, T, causal, window, "cuda")
            pairs = int(allow.sum())
            mask = {} if not causal else (
                dict(is_causal=True) if window is None
                else dict(attn_mask=allow))
            lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            lout = sdpa(lq, lk, lv, enable_gqa=True, **mask)
            lib = torch.autograd.grad(lout, (lq, lk, lv),
                                      do.transpose(1, 2), retain_graph=True)
            lib = [t.transpose(1, 2) for t in lib]
            torch.cuda.synchronize()
            rel = [((a.float() - b.float()).abs().max()
                    / b.float().abs().max()).item()
                   for a, b in zip(got, ref)]
            lib_rel = [((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
                       for a, b in zip(lib, ref)]
            max_abs = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, ref))
            del got, ref, lib
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))

            def fwd_bwd(q_, k_, v_, do_):
                o = FK.flash_attention(q_, k_, v_, **kw)
                return torch.autograd.grad(o, (q_, k_, v_), do_)

            def lib_fwd_bwd(q_, k_, v_, do_):
                o = sdpa(q_, k_, v_, enable_gqa=True, **mask)
                return torch.autograd.grad(o, (q_, k_, v_), do_)

            def lib_bwd(do_):
                return torch.autograd.grad(lout, (lq, lk, lv), do_,
                                           retain_graph=True)

            times = (
                timed_ms(torch, lambda *a: FK.flash_attention_backward(
                    *a, **kw), [(q, k, v, out, lse, do)], reps=3,
                    graph=False),
                timed_ms(torch, fwd_bwd, [(qr, kr, vr, do)], reps=3,
                         graph=False),
                timed_ms(torch, lambda *a: FK.flash_attention_backward_plain(
                    *a, **kw), [(q, k, v, out, lse, do)], reps=1,
                    graph=False),
                timed_ms(torch, lib_fwd_bwd, [(lq, lk, lv,
                                               do.transpose(1, 2))],
                         reps=3, graph=False),
                timed_ms(torch, lib_bwd, [(do.transpose(1, 2),)], reps=3,
                         graph=False))
            del lout
            nbytes, flops = cost.flash_attention_bwd(B, S, T, H, Kv, d,
                                                     pairs, es)
            bound, by = _bound(nbytes, flops, dtype)
            tol = BWD_REL_TOL[dtype]
            row = {"phase": "kernel", "name": FK.BWD, "dtype": dtype,
                   "B": B, "S": S, "T": T, "H": H, "Kv": Kv, "d": d,
                   "causal": causal, "window": window,
                   "rel_err_dq_dk_dv": rel, "max_rel_err": max(rel),
                   "max_abs_err": max_abs, "rel_tol": tol,
                   "forward_with_lse_unchanged": same,
                   "library_rel_err_dq_dk_dv": lib_rel,
                   "kernel_ms": times[0], "kernel_fwd_bwd_ms": times[1],
                   "plain_ms": times[2], "library_ms": times[3],
                   "library_bwd_ms": times[4],
                   "bytes": nbytes, "flops": flops,
                   "bound_ms": bound, "bound_by": by,
                   "cuda_launches_per_call": len(nodes)}
            emit(row)
            row["fault"] = (
                f"{FK.BWD} disagrees with its plain version at {dtype} "
                f"{(B, S, T, H, Kv, d, causal, window)}: {rel} > {tol}"
                if not max(rel) <= tol else
                f"flash_attention's forward with lse differs from without "
                f"at {dtype} {(B, S, T, H, Kv, d)}" if not same else
                f"{FK.BWD}: one call is {nodes}, not 3 kernels"
                if nodes != [0, 0, 0] else None)
            rows.append(row)
            del q, k, v, do, out, lse, qr, kr, vr, lq, lk, lv
            torch.cuda.empty_cache()
    _raise_faults(rows)
    return rows


class _PlainAttention:
    """The model's attention through the plain versions, forward and
    backward, in the autograd Function's plumbing: the one-step check's
    other side (a check, not the main path)."""

    def __init__(self, torch, FK):
        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, window):
                out, lse = FK.flash_attention_plain(
                    q, k, v, causal=causal, window=window, return_lse=True)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.kw = dict(causal=causal, window=window)
                return out

            @staticmethod
            def backward(ctx, do):
                q, k, v, out, lse = ctx.saved_tensors
                return (*FK.flash_attention_backward_plain(
                    q, k, v, out, lse, do.contiguous(), **ctx.kw),
                    None, None)

        self.fn = Plain

    def __call__(self, q, k, v, *, causal=True, window=None):
        return self.fn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal, window)


def _train_batch(torch, cfg):
    """The first batch of TRAIN's SyntheticLM stream, on the card."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN["seq_len"],
                                  batch_size=TRAIN["batch"]))
    return {k: torch.from_numpy(v).cuda()
            for k, v in next(data.batches()).items()}


def _grads(torch, model, params, batch, remat=False):
    """(total loss, the gradient of every param leaf, in tree order)."""
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    total, _ = lm_loss(model, tree_unflatten(params, leaves), batch,
                       remat=remat)
    grads = torch.autograd.grad(total, leaves)
    return float(total.detach()), grads


def step_checks(torch, mods, FK) -> dict:
    """One train step of stablelm-1.6b cut to STEP_LAYERS layers at full
    width, three ways: through the kernels against the same step with
    attention through the plain versions (bf16 and f32, each grad leaf
    within STEP_GRAD_TOL), the fused kernels launched as
    :func:`train_fused_launches` says; with ``remat=True``, every grad
    equal bit for bit to the plain step's, with 2 flash forward launches
    a layer (the recompute) and 1 backward; and one whole f32 step (the
    launcher's default format) through ``make_train_step``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=STEP_LAYERS)
    batch = _train_batch(torch, cfg)
    out = {"phase": "train_step", "model": cfg.name, "layers": STEP_LAYERS,
           "d_model": cfg.d_model, "B": TRAIN["batch"], "S": TRAIN["seq_len"]}
    faults = []
    for fmt in ("bfloat16", "float32"):
        model = build_model(cfg, fmt=fmt, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        reset_launches(mods)
        loss_k, g_k = _grads(torch, model, params, batch)
        counts = read_launches(mods)
        real = tfm.flash_attention
        tfm.flash_attention = _PlainAttention(torch, FK)
        try:
            loss_p, g_p = _grads(torch, model, params, batch)
        finally:
            tfm.flash_attention = real
        rel = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(g_k, g_p))
        want = {"flash_attention": STEP_LAYERS,
                "flash_attention_bwd": STEP_LAYERS,
                **train_fused_launches(cfg)}
        line = {"loss": loss_k, "plain_loss": loss_p,
                "max_leaf_rel_err": rel, "tol": STEP_GRAD_TOL[fmt],
                "launches": counts}
        if not rel <= STEP_GRAD_TOL[fmt]:
            faults.append(f"{fmt} step: grads {rel} off the plain step's")
        if {k: counts[k] for k in want} != want:
            faults.append(f"{fmt} step launched {counts}, not {want}")
        if fmt == "bfloat16":
            reset_launches(mods)
            _, g_r = _grads(torch, model, params, batch, remat=True)
            counts = read_launches(mods)
            line["remat_launches"] = counts
            line["remat_bit_equal"] = all(torch.equal(a, b)
                                          for a, b in zip(g_r, g_k))
            want = {"flash_attention": 2 * STEP_LAYERS,
                    "flash_attention_bwd": STEP_LAYERS,
                    **train_fused_launches(cfg, remat=True)}
            if not line["remat_bit_equal"]:
                faults.append("the remat step's grads are not the plain "
                              "step's bit for bit")
            if {k: counts[k] for k in want} != want:
                faults.append(f"remat step launched {counts}, not {want}")
            del g_r
        else:
            step = make_train_step(model, AdamWConfig())
            t0 = time.perf_counter()
            new, opt, met = step(params, adamw_init(params), batch)
            torch.cuda.synchronize()
            line["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
            line["step_lm_loss"] = float(met["lm_loss"])
            line["step_grad_norm"] = float(met["grad_norm"])
            if not math.isfinite(line["step_lm_loss"]) or int(
                    opt["step"]) != 1:
                faults.append("the f32 step gave a non-finite loss")
            del new, opt
        out[fmt] = line
        del params, g_k, g_p, model
        gc.collect()
        torch.cuda.empty_cache()
    emit(out)
    if faults:
        raise SystemExit("train_step: " + "; ".join(faults))
    return out


def _greedy(torch, model, params, prompts):
    """SERVE_NEW greedy tokens of each prompt: one prefill, then decode
    steps (flash in the prefill, paged in each step)."""
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  buf_len=SERVE_PROMPT_LEN + SERVE_NEW)
    toks = []
    for _ in range(SERVE_NEW):
        tok = logits.argmax(-1)[:, None]
        toks.append(tok)
        logits, cache = model.decode_step(params, tok, cache)
    return torch.cat(toks, dim=1).tolist()


def train_phase(torch, mods) -> dict:
    """Full-width training: stablelm-1.6b at full width and depth in bf16
    on SyntheticLM through ``repro_torch.training.train`` (TRAIN), under
    the power sampler, with exactly one flash forward and one backward
    launch a layer and step, the fused kernels' launches of
    :func:`train_fused_launches`, and no other kernel; finite losses
    whose last
    5 steps' mean is below step 0's. Then the trained params are saved
    with ``save_checkpoint``, loaded with ``load_checkpoint`` and serve
    the same greedy tokens as the params in memory; then the launcher
    trains granite-moe-1b-a400m (reduced) for 5 steps as a subprocess.
    Returns the launch counts of the training run."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, train
    from repro_torch.training.checkpoint import load_checkpoint, \
        save_checkpoint
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, fmt="bfloat16", device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN["seq_len"],
                                  batch_size=TRAIN["batch"]))
    steps = []
    last = {"t": None}

    def record(step, metrics):
        loss, gn = float(metrics["lm_loss"]), float(metrics["grad_norm"])
        now = time.perf_counter()
        steps.append({"step": step, "loss": loss, "grad_norm": gn,
                      "host_ms": 1e3 * (now - last["t"]),
                      "launches": read_launches(mods)})
        reset_launches(mods)
        last["t"] = now

    def run():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        t0 = last["t"] = time.perf_counter()
        state = train(model, data.batches(), n_steps=TRAIN["steps"],
                      seed=0, log_every=5, callback=record,
                      opt_cfg=AdamWConfig(lr=TRAIN["lr"],
                                          warmup_steps=TRAIN["warmup"]),
                      torch_device="cuda")
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    (state, wall), watts = sampled_power(run)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [s["loss"] for s in steps]
    # the first step's host time includes drawing the weights
    step_ms = [s["host_ms"] for s in steps[1:]]
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    mean_w = sum(watts) / len(watts)
    line = {"phase": "train", "model": cfg.name, "fmt": "bfloat16",
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(), **TRAIN,
            "loss": losses, "grad_norm": [s["grad_norm"] for s in steps],
            "host_ms": [s["host_ms"] for s in steps],
            "wall_s": wall, "ms_per_step": sum(step_ms) / len(step_ms),
            "tokens_per_s": tokens / (sum(step_ms) / len(step_ms) / 1e3),
            "peak_mem_gb": peak, "mean_w": mean_w, "power_samples": watts,
            "j_per_token": mean_w * (sum(step_ms) / 1e3)
            / (tokens * len(step_ms)),
            "launches_per_step": steps[-1]["launches"]}
    emit(line)
    faults = []
    want = {"flash_attention": cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers,
            **train_fused_launches(cfg)}
    for s in steps:
        if {k: v for k, v in s["launches"].items() if v} != want:
            faults.append(f"step {s['step']} launched {s['launches']}, "
                          f"not {want}")
    if not all(math.isfinite(x) for x in losses):
        faults.append(f"non-finite losses {losses}")
    if not sum(losses[-5:]) / 5 < losses[0]:
        faults.append(f"the loss did not fall: {losses}")
    if faults:
        raise SystemExit("train: " + "; ".join(faults[:5]))
    counts = {k: sum(s["launches"][k] for s in steps)
              for k in steps[0]["launches"]}

    # train -> save -> load -> serve
    params = state.params
    del state
    gc.collect()
    torch.cuda.empty_cache()
    path = ROOT / "build" / "train_stablelm.npz"
    t0 = time.perf_counter()
    save_checkpoint(str(path), params, step=TRAIN["steps"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, opt, step = load_checkpoint(str(path), device="cuda")
    load_s = time.perf_counter() - t0
    size_gb = path.stat().st_size / 1e9
    os.remove(path)
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size,
                            (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                            generator=gen, device="cuda")
    with torch.no_grad():
        reset_launches(mods)
        mine = _greedy(torch, model, params, prompts)
        served = read_launches(mods)
        again = _greedy(torch, model, loaded, prompts)
    line = {"phase": "train_serve", "model": cfg.name,
            "checkpoint_gb": size_gb, "save_s": save_s, "load_s": load_s,
            "step": step, "tokens": mine, "tokens_from_checkpoint": again,
            "launches": served}
    emit(line)
    if mine != again or step != TRAIN["steps"] or opt is not None:
        raise SystemExit(f"train_serve: the reloaded checkpoint served "
                         f"{again}, the trained params {mine}")
    if not (served["flash_attention"] == cfg.num_layers
            and served["paged_attention"] == cfg.num_layers * SERVE_NEW):
        raise SystemExit(f"train_serve: launches {served}")
    del params, loaded, model
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher, as a user runs it
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *LAUNCHER], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    launcher_losses = [float(ln.split("loss=")[1].split()[0])
                       for ln in lines]
    emit({"phase": "train_launcher", "argv": LAUNCHER,
          "exit": proc.returncode, "wall_s": time.perf_counter() - t0,
          "losses": launcher_losses, "stdout_head":
          proc.stdout.splitlines()[:1]})
    if (proc.returncode or len(launcher_losses) != 5
            or not all(math.isfinite(x) for x in launcher_losses)):
        raise SystemExit(f"the launcher failed:\n{proc.stdout[-2000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return counts


# ---------------------------------------------------------------------------
# dryrun: the launch analysis (repro_torch.launch.dryrun) on the meta device
# ---------------------------------------------------------------------------
DRY_WORKERS = 8                   # processes of the sweep (the host's cores)
DRY_TRAIN = ("stablelm-1.6b", (1024, 4, "train"))   # TRAIN's cell
DRY_DECODE = ("llama-3.1-8b", (512, 4, "decode"))   # the serve cells' ring
DRY_FLOP_RATIO = 2.0              # counted FLOPs within 2x of the estimate
EP_ARCH, EP_TOKENS, EP_REL_TOL = "granite-moe-1b-a400m", 2048, 1e-2
ONE_RANK = ((1, 1), ("data", "model"))


def _dry_one(combo):
    """One record of the sweep (a worker process): the production mesh,
    bf16, on the meta device; the summary the phase prints."""
    from repro_torch.launch import dryrun
    arch, shape = combo
    t0 = time.perf_counter()
    try:
        r = dryrun.run_one(arch, shape, False, "bfloat16", save=False)
    except Exception as e:                   # reported, and fails the phase
        import traceback
        where = [f"{f.filename.split('/src/')[-1]}:{f.lineno} {f.name}"
                 for f in traceback.extract_tb(e.__traceback__)][-8:]
        return {"phase": "dryrun", "arch": arch, "shape": shape,
                "ok": False, "error": repr(e)[:1500], "where": where,
                "seconds": time.perf_counter() - t0}
    rf, mem = r["roofline"], r["memory_analysis"]
    return {"phase": "dryrun", "arch": arch, "shape": shape,
            "mesh": r["mesh"], "ok": r["ok"], "hlo_flops": r["hlo_flops"],
            "hlo_bytes": r["hlo_bytes"],
            "collective_bytes": r["collective_bytes"],
            "per_gpu_gb": (mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"]) / 1e9,
            "argument_gb": mem["argument_size_in_bytes"] / 1e9,
            "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "fits": mem["fits"], "bottleneck": rf["bottleneck"],
            "t_compute_s": rf["t_compute_s"], "t_memory_s": rf["t_memory_s"],
            "t_collective_s": rf["t_collective_s"],
            "useful_flop_ratio": rf["useful_flop_ratio"],
            "seconds": time.perf_counter() - t0}


def dry_sweep() -> list:
    """The reference's default sweep: every ARCH_IDS config at every
    INPUT_SHAPES shape on the 16 x 16 mesh, bf16, on the meta device, in
    DRY_WORKERS processes; each record must be ok, count FLOPs and bytes,
    and name a bottleneck."""
    import multiprocessing as mp
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(DRY_WORKERS) as pool:
        rows = pool.map(_dry_one, combos, chunksize=1)
    for row in rows:
        emit(row)
    bad = [(r["arch"], r["shape"]) for r in rows
           if not (r["ok"] and r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
                   and r["bottleneck"] in ("compute", "memory",
                                           "collective"))]
    emit({"phase": "dryrun_sweep", "records": len(rows), "failed": bad,
          "wall_s": time.perf_counter() - t0})
    if bad or len(rows) != len(combos):
        raise SystemExit(f"dryrun: records not ok: {bad}")
    return rows


def _tree_bytes(tree) -> int:
    from repro_torch.core.op_analysis import tree_bytes
    return tree_bytes(tree)


def _dry_cell(torch, mods, arch, dims):
    """One cell the card runs: the dry run on a one-rank mesh, the same
    tree allocated on the card (bytes equal), the step run there (launch
    counts equal to the dry run's kernel calls; measured peak and host
    wall step beside the dry run's argument + temp and roofline step)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import workload as W
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import make_train_step
    seq, batch, kind = dims
    shape = ShapeConfig(f"{kind}_cell", seq, batch, kind)
    t0 = time.perf_counter()
    rec, dry_cost = dryrun.dry_run(arch, shape.name, False, "bfloat16",
                                   shape=shape, mesh=ONE_RANK)
    dry_s = time.perf_counter() - t0
    calls = dry_cost.kernels
    mem, rf = rec["memory_analysis"], rec["roofline"]
    step_time = max(rf["t_compute_s"], rf["t_memory_s"]) \
        + rf["t_collective_s"]
    cfg = dryrun.arch_config(arch)
    model = build_model(cfg, fmt="bfloat16", device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq if kind == "train"
                                             else 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    if kind == "train":
        opt = adamw_init(params)
        args = (params, opt, {"tokens": toks, "labels": toks})
        step = make_train_step(model, remat=True)
        estimate = W.train_step_workload(cfg, batch, seq).flops
    else:
        cache = model.init_cache(batch, seq)
        args = (params, toks, cache)
        estimate = W.decode_step_workload(cfg, batch, seq).flops

        def step(params, toks, cache):
            # a full ring: every slot holds a position, pos at its end
            cache["pos"].fill_(seq - 1)
            cache["slot_pos"].copy_(torch.arange(seq, device="cuda")
                                    .expand(batch, seq))
            with torch.no_grad():
                return model.decode_step(params, toks, cache)
    torch.cuda.synchronize()
    card_bytes = _tree_bytes(args)
    allocated = torch.cuda.memory_allocated() - before
    step(*args)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        step(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    counts = {k: v // reps for k, v in read_launches(mods).items()}
    launched = {k: v for k, v in counts.items() if v}
    peak = torch.cuda.max_memory_allocated()
    counted = rec["hlo_flops"]
    line = {"phase": "dryrun_card", "arch": arch, "kind": kind,
            "batch": batch, "seq": seq, "dry_s": dry_s,
            "argument_bytes": mem["argument_size_in_bytes"],
            "card_tree_bytes": card_bytes, "card_allocated_bytes": allocated,
            "temp_bytes": mem["temp_size_in_bytes"],
            "argument_plus_temp_gb": (mem["argument_size_in_bytes"]
                                      + mem["temp_size_in_bytes"]) / 1e9,
            "measured_peak_gb": peak / 1e9,
            "peak_ratio": peak / (mem["argument_size_in_bytes"]
                                  + mem["temp_size_in_bytes"]),
            "counted_flops": counted, "workload_flops": estimate,
            "flop_ratio": counted / estimate,
            "roofline_step_s": step_time, "measured_step_s": wall,
            "step_ratio": wall / step_time, "bottleneck": rf["bottleneck"],
            "dry_kernel_calls": calls, "launches": launched}
    emit(line)
    del args, params, toks
    gc.collect()
    torch.cuda.empty_cache()
    faults = []
    if card_bytes != mem["argument_size_in_bytes"]:
        faults.append(f"the card holds {card_bytes} bytes, the dry run "
                      f"counts {mem['argument_size_in_bytes']}")
    if not estimate / DRY_FLOP_RATIO < counted < estimate * DRY_FLOP_RATIO:
        faults.append(f"counted {counted} FLOPs, the workload estimate "
                      f"{estimate}")
    if launched != calls or not launched:
        faults.append(f"the step launched {launched}, the dry run counted "
                      f"{calls} kernel calls")
    if faults:
        raise SystemExit(f"dryrun {arch} {kind}: " + "; ".join(faults))
    return counts


def ep_check(torch) -> dict:
    """One MoE layer of granite-moe-1b-a400m at full width, bf16, on
    EP_TOKENS tokens (one prefill): the expert-parallel path over a
    one-rank NCCL group against moe_ffn's local path, within EP_REL_TOL
    relative."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.core.precision import make_policy
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_moe_params
    cfg = get_config(EP_ARCH)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator(device="cuda").manual_seed(5)
        p = init_moe_params(gen, cfg, torch.bfloat16)
        x = torch.randn((EP_TOKENS, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kw = dict(top_k=cfg.experts_per_token,
                  policy=make_policy("bfloat16"),
                  capacity_factor=cfg.moe_capacity_factor)
        calls = []
        body = moe._ep_body
        moe._ep_body = lambda *a, **k: calls.append(1) or body(*a, **k)
        try:
            ref, _ = moe.moe_ffn(p, x, **kw)
            with moe.expert_parallel(mesh, data_axes=("data",)):
                got, aux = moe.moe_ffn(p, x, **kw)
        finally:
            moe._ep_body = body
        torch.cuda.synchronize()
        rel = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        line = {"phase": "dryrun_ep", "arch": EP_ARCH, "tokens": EP_TOKENS,
                "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
                "group": "nccl, 1 rank, mesh (1, 1)",
                "expert_parallel_calls": len(calls), "max_rel_err": rel,
                "rel_tol": EP_REL_TOL,
                "aux": {k: float(v) for k, v in aux.items()}}
        emit(line)
    finally:
        dist.destroy_process_group()
    if len(calls) != 1 or not rel <= EP_REL_TOL:
        raise SystemExit(f"dryrun_ep: {len(calls)} expert-parallel calls, "
                         f"rel {rel} > {EP_REL_TOL}")
    return line


def dryrun_phase(torch, mods) -> dict:
    """The launch analysis: the sweep, the two cells the card runs, and
    the expert-parallel path; every group destroyed before the next step.
    Returns the launch counts of the cells' steps."""
    t0 = time.perf_counter()
    dry_sweep()
    counts = {}
    for arch, dims in (DRY_TRAIN, DRY_DECODE):
        counts[("dryrun", arch)] = _dry_cell(torch, mods, arch, dims)
    ep_check(torch)
    emit({"phase": "dryrun_done", "wall_s": time.perf_counter() - t0})
    return counts


def _phase_timer(t_start: float):
    """``timed(name, fn, *args)``: fn(*args), and a ``phase_wall`` line
    with its host wall and the script's so far."""
    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        emit({"phase": "phase_wall", "of": name, "wall_s": now - t0,
              "script_s": now - t_start})
        return out
    return timed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as PK
    from repro_torch.kernels.fused import kernel as FU
    from repro_torch.kernels.quant_matmul import kernel as K
    mods = (K, FK, PK, FU)

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    libs = cuda_build.build(src for m in mods for src in m.SOURCES.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libs]})

    from repro_torch.launch.serve import arch_config
    configs = {arch: arch_config(arch)
               for arch in [a for a, *_ in SERVE_CELLS + MODEL_CELLS]}
    causal, full, paged = attention_cells(configs)
    check_attention_cells(configs, (causal, full, paged))
    two_d, grouped = quant_cells(configs)
    timed = _phase_timer(t_start)
    rows = timed("kernel", kernel_phase, torch, K, two_d)
    rows.update(timed("grouped", grouped_phase, torch, K, grouped))
    rows["flash_attention"] = timed("flash", flash_phase, torch, FK, causal,
                                    full)
    rows["paged_attention"] = timed("paged", paged_phase, torch, PK, paged)
    rows.update(timed("fused", fused_phase, torch, FU,
                      fused_cells(configs)))
    launches = timed("serve", serve_phase, torch, mods)
    launches.update(timed("model", model_phase, torch, mods))
    launches.update(timed("arrival", arrival_phase, torch, mods))
    launches.update(timed("orchestration", orchestration_phase, torch,
                          mods))
    launches.update(timed("api", api_phase, torch, mods))
    rows[FK.BWD] = timed("bwd", bwd_phase, torch, FK)
    timed("train_step", step_checks, torch, mods, FK)
    launches[("train", TRAIN_ARCH)] = timed("train", train_phase, torch,
                                            mods)
    launches.update(timed("dryrun", dryrun_phase, torch, mods))

    kernels = []
    for name in K.ENTRY_POINTS:
        grouped = name.endswith("_grouped")
        shape = HEADLINE_GROUPED if grouped else HEADLINE
        head = next(r for r in rows[name] if tuple(
            r[k] for k in (("E", "C", "K", "N") if grouped
                           else ("M", "K", "N"))) == shape)
        op = "torch.bmm" if grouped else "torch.matmul"
        if name.startswith("fp16"):
            library = (f"{op} on a bf16 copy of the weight (the product "
                       f"alone; library_cast_ms: {op}(x, w.to(bfloat16)), "
                       "the conversion included)")
        elif name.startswith("bf16"):
            library = (f"{op} on the same bf16 weights: the product it "
                       "replaced, every expert read")
        else:
            library = (f"{op} on the weight already dequantized to bf16 "
                       "(does less work)")
        extra = {k: head[k] for k in ("n_out", "separate_ms",
                                      "library_cast_ms") if k in head}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/quant_matmul/csrc/"
                      f"{name.replace('_grouped', '')}.cu",
            "replaces": REPLACES[name],
            **({"replaces_as": "that kernel under jax.vmap over the "
                               "experts, src/repro/models/moe.py:147 "
                               "_expert_dense"}
               if grouped and REPLACES[name] != REPLACES_16 else {}),
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": list(shape),
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "cuda_launches_per_call": head["cuda_launches_per_call"],
            "library_ms": head["library_ms"], "library_is": library,
            **extra,
            **({"loop_of_2d_calls_ms": head["loop_of_2d_calls_ms"],
                # case (b): the dispatch's kept rows of a batch-4 decode
                "dispatch": head["dispatch"]} if grouped else {}),
        })
    for name, shape in HEADLINE_ATTN.items():
        head = next(r for r in rows[name]
                    if all(r[k] == v for k, v in shape.items()))
        kernels.append({
            "name": name, "route": "cuda",
            "source": ATTN_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": max(c[name] for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": shape,
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "library_ms": head["library_ms"],
            "library_is": "torch.nn.functional.scaled_dot_product_attention"
                          " (enable_gqa) on the same inputs",
        })
    for case, row in PAGED_ROWS.items():
        head = next(r for r in rows["paged_attention"]
                    if all(r[k] == v for k, v in dict(
                        HEADLINE_ATTN["paged_attention"], case=case).items()))
        cases = [r for r in rows["paged_attention"] if r["case"] == case]
        kernels.append({
            "name": "paged_attention", "case": case, "row": row,
            "route": "cuda", "source": ATTN_SOURCES["paged_attention"],
            "replaces": REPLACES["paged_attention"],
            "launches": max(c.get(f"paged_attention.{case}", 0)
                            for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "max_rel_err": max(r["max_rel_err"] for r in cases),
            "shape": HEADLINE_ATTN["paged_attention"],
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "library_ms": head["library_ms"],
            "library_is": head["library_is"],
        })
    for name, shape in HEADLINE_FUSED.items():
        head = next(r for r in rows[name]
                    if all(r[k] == v for k, v in shape.items()))
        kernels.append({
            "name": name, "route": "cuda", "source": str(
                FU.SOURCES[name].files[0].relative_to(ROOT)),
            "replaces": FUSED_REPLACES[name],
            "launches": max(c.get(name, 0) for c in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "max_rel_err": max(r["max_rel_err"] for r in rows[name]),
            "shape": shape,
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "bytes": head["bytes"],
            "cuda_launches_per_call": head["cuda_launches_per_call"],
            "library_ms": head["library_ms"],
            "library_is": ("torch.nn.functional.rms_norm with gamma cast to "
                           "x's dtype beforehand (a yardstick: the port "
                           "never calls it)" if name == "rms_norm" else
                           "none: no single PyTorch call computes it"),
        })
    head = next(r for r in rows[FK.BWD]
                if all(r[k] == v for k, v in HEADLINE_BWD.items()))
    kernels.append({
        "name": FK.BWD, "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "none: src/repro/kernels/flash_attention/kernel.py:67 "
                    "has no backward; the reference differentiates XLA "
                    "attention (src/repro/models/transformer.py:136-140)",
        "launches": max(c.get(FK.BWD, 0) for c in launches.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows[FK.BWD]),
        "max_rel_err": max(r["max_rel_err"] for r in rows[FK.BWD]),
        "shape": HEADLINE_BWD,
        "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
        "kernel_fwd_bwd_ms": head["kernel_fwd_bwd_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "bytes": head["bytes"],
        "cuda_launches_per_call": head["cuda_launches_per_call"],
        "library_ms": head["library_ms"],
        "library_bwd_ms": head["library_bwd_ms"],
        "library_is": "torch.nn.functional.scaled_dot_product_attention "
                      "forward + backward (enable_gqa) on the same inputs; "
                      "compare kernel_fwd_bwd_ms (library_bwd_ms: its "
                      "backward alone, beside ms)",
    })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
