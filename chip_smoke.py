#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON object per line; any failed check raises and
the script exits non-zero without printing the final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   all seven CUDA sources compile from this checkout, in parallel;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it, with its median time (CUDA events,
   L2 flushed before each launch), the plain version's time, a PyTorch
   library call computing the same function as a yardstick (never used by
   the port) and the card's lower bound for the work: the fused MVM (slice
   1; since slice 5 in two regimes, each row naming its own: "gemv" streams
   the bank at decode widths, "mma" runs s8 tensor cores at prefill
   widths) and flash attention (slice 1; since slice 5 a bf16 tensor-core
   variant "mma" beside the float32 CUDA-core one "simt", and a case with
   NaN/inf past kv_len; since slice 10 MLA's head dims, q/k 192 against v
   128, on the tensor cores, with the SDPA backend that ran beside each
   row; since slice 11 non-causal calls over 1601 image tokens and 1500
   audio frames, each also in a longer buffer holding NaN/inf past the
   memory, and the fused MVM at the memory projections' and the vlm and
   whisper decode shapes), the split MVMs in both orientations and the
   blend (slice 2; since slice 6 ``photonic_mvm_t`` and since slice 7
   ``photonic_mvm`` run the fused kernel's regimes on int8 rows, each row
   naming its own, and each orientation equals the other on the
   transposed bank bit for bit; since slice 7 the blend's cases cover its
   16-byte vector pass and its element pass, in bf16 and float32), the
   reuse-resident MVM (slice 3, also held bit for bit to T launches of the
   split MVM; since slice 6 on the s8 tensor cores, any K, with a
   jamba-width bank past the first kernel's limit), the intra-chunk SSD
   (slice 4, at mamba2-780m's and a jamba-width chunk, with stride-0 and
   materialised B/C, which must agree bit for bit, each at mamba2's decay
   spread and at a slow decay under which every key tile and state row
   carries weight; since slice 8 on the TF32 tensor cores in 3xTF32, with
   C B^T once per group of heads, at b * nc = 1, 2, 6 and 8 and a ragged
   chunk whose every tile is partial, bit for bit the same under another
   grouping of heads, its SASS holding TF32 wgmma); since slice 18 the
   decode attention (``check_decode_attention``: no Pallas counterpart,
   the repair of the einsum's batch dependence) at minitron-4b's, the vlm
   self-attention's, whisper's decoder's and granite's serving shapes in
   bf16 and minitron's in float32, each row bit-equal alone, beside one
   other row and within the whole batch, each group of KV heads (tp 2 and
   4) bit-equal to those heads of the whole call, and its partial form
   joined over 2 and 4 pieces of the positions at the float gates;
3. the fused serving path: minitron-4b with its R&B plan (8 physical
   blocks x 4 reuses) at full width, photonic, bf16, seeded random weights,
   through ``Program.generate`` and a ``ContinuousScheduler`` with chunked
   prefill; kernel launch counts are zeroed just before and read just
   after, and both fused regimes and the tensor-core flash must have run;
   then one prefill's logits are checked and a small model's GPU logits
   are held against the CPU plain path;
3b. the fault-model serving path: the same model with the paper's blocked
   shuffle (``shuffle_block=128``) on ``Backend("photonic", fused=False,
   noise=...)`` at full width and depth, served by a ``ContinuousScheduler``
   with bank residency and the calibration loop; launch counts zeroed just
   before the drain and read just after; single billing of every write;
3c. a small float32 model on the card: fused vs split logits with noise
   off, the drift bench's gates, and crosstalk-only noise on the card
   against the CPU plain path;
3d. the MoE path: granite-moe-1b-a400m with its R&B plan (6 x 4) and
   blended experts (``num_basic_experts=8``) at full width and depth,
   photonic, bf16, seeded random weights, through ``Program.generate`` and
   a ``ContinuousScheduler`` with chunked prefill; launch counts zeroed
   just before and read just after, the resident count held to 480 per
   forward pass;
3e. the granite smoke model (float32, blended experts, an R&B stack with a
   transposed reuse) on the card against the CPU plain path;
3f. the SSM path: mamba2-780m with its R&B plan (12 x 4) at full width and
   depth, photonic, bf16, seeded random weights, through
   ``Program.generate`` and a ``ContinuousScheduler`` whose exact-length
   prefills must not chunk; launch counts zeroed just before and read just
   after, ``ssd_chunk`` held to 48 launches per prefill pass and the fused
   MVM to its per-pass counts;
3g. the mamba2 smoke model (R&B, 2 x 2) and the jamba smoke model (SSM,
   attention and MoE layers), float32, on the card against the CPU plain
   path;
3h. a small dense model's card logits against the same CPU program with
   the MVM kernels' own arithmetic (``photonic_mvm.exact_mvm``: the exact
   integer product, rescaled once), at a kernel-level tolerance;
3i. since slice 9 the decode steps of the fused, MoE and SSM paths replay
   CUDA graphs (``repro_torch.graphs.DecodeCell``), captured with
   synchronizing calls made errors: each ``generate`` captures once, each
   path's scheduler drain runs with its decode graph (one capture) and
   again with the cell kept eager, and the two drains must give the same
   tokens and the same launch counts (the eager one is not counted in the
   path's window); each path's ``decode_step`` phase reports the eager and
   the replayed step (wall, aten ops, profiled device busy) and requires
   the replay's logits and caches bit-equal to the eager step's from the
   same caches, and the profiled replay's CUDA kernels of each port kernel
   counted by name equal to the launches the cell adds per replay (so the
   counts in a path's window rest on kernels a replay was seen to run).
   The fault-model path is not captured by rule
   (``graphs.NOISE_RULE``, printed as ``decode_graph_reason``);
3j. since slice 10 the MLA path: deepseek-v2-lite-16b R&B (64 routed
   experts top-6, 2 shared, one dense ``pre`` layer, MLA with kv_lora 512,
   q/k head dim 192 and v 128) at full width, since slice 16 cut in depth
   from its 13 x 2 plan to 4 x 2 (``mla_config``), photonic, bf16, seeded
   random weights, through
   ``Program.generate`` and a ``ContinuousScheduler`` with chunked prefill
   (graph and eager drains as in 3i); launch counts zeroed just before and
   read just after, the fused MVM held to the config's count per pass
   (``fused_per_pass``: 1591 per decode pass, 1600 per prefill pass or
   chunk), flash to one tensor-core launch per layer of every pass of 512
   rows or more; then a small bf16 MLA model's card logits against the CPU
   program with the MVM kernels' arithmetic and the tensor-core flash's
   bf16 P, taught by the card's MVM inputs since slice 13
   (``small_mla_check``);
3k. since slice 11 the memory-stream paths (``serve_memory``):
   llama-3.2-vision-11b with its R&B plan (4 x 2: 8 scan groups of 4
   self-attention layers and one cross-attention layer over 1601 image
   tokens) and whisper-medium with its plan (6 x 4 on both 24-layer
   stacks: a non-causal encoder over 1500 frames, a decoder of self- and
   cross-attention, layer norm, gelu), each at full width and depth,
   photonic, bf16, seeded random weights and seeded stub embeddings per
   request (``configs.stub_extras``), through ``Program.generate`` and a
   ``ContinuousScheduler`` (no request with extras is chunked; graph and
   eager drains as in 3i); the fused MVM held to the config's count per
   pass (``fused_per_pass``: 265 / 282 and 193 / 386 per decode / prefill
   pass), flash to ``flash_per_prefill`` (causal and not, all on the
   tensor cores), the decode step leaving the cross K/V untouched; then
   small float32 vlm and whisper models (``small_memory_checks``) whose
   card logits are held to the CPU program with the kernels' arithmetic,
   taught at each MVM call by the card's input (``exact_backend``,
   ``recording_backend``);
3l. since slice 12 the serving launcher (``serve_launcher``), right after
   the fused path: ``python -m repro_torch.launch.serve`` (through its
   ``build_program`` / ``serve``) on minitron-4b R&B at full width and
   depth, photonic, bf16, the continuous scheduler over the launcher's
   own trace (12 requests of 256-1024 tokens, up to 32 new) with
   ``--stats``, ``--trace-out`` and ``--metrics-out``: launch counts and
   the default metrics registry zeroed just before, both fused regimes
   and tensor-core flash required in the window, the snapshot validated
   against the port's schema, TTFT / TPOT sample counts, one trace row per
   request, ``program.steps{kind=decode_sample}`` equal to the decode
   steps, one decode-graph capture, and the tokens equal to a drain of
   the same Program with telemetry off; then 4 requests each through the
   wave batcher, the engine and the fault model (noise, an array budget
   of half the Program's tiles so the hybrid mapping streams banks,
   calibration every 4 steps: the split MVMs, no fused launch);
3m. since slice 13 training (``train_phase``): granite-moe-1b-a400m with
   its R&B plan (6 x 4) at full width through
   ``repro_torch.launch.train.run``, bf16 compute over float32 masters,
   the copy task, batch 8 x 1024 in 2 microbatches, remat per reuse,
   AdamW; a straight 6-step run and a 3-step run resumed to step 6, under
   deterministic algorithms, the resumed params and Adam state bit-equal
   to the straight run's; step walls, tokens/s, peak memory, checkpoint
   save and restore, one profiled step; then the held-out
   ``Program.loss`` on xla and photonic, the photonic call's fused-MVM
   and flash launches held to the config's exact count, each launch to
   its plain version on its own inputs and the CE to xla's at the W8A8
   bound;
3n. since slice 14 the paper's own models (``paper_phase``): Tables 2, 3
   and Fig. 1 from the port's cost model (Table 3 held to the paper),
   Tables 4 and 5 through ``repro_torch.paper_run`` with every MLP and
   Mixer trained on the card at the reference's setting (120 steps of
   batch 64), three train steps and the VGG-13 / ResNet-18 forwards held
   to the CPU, their images/s, and a card-trained Mixer 2x4 quantized
   W8A8 bit for bit as on the CPU (no port kernel: cuBLAS and cuDNN in
   float32);
3o. since slice 15 sharded execution (``sharded_phase``), right after the
   launcher, as ranks over ``torch.distributed`` sharing the card (gloo;
   every line names the transport): the small float32 model's
   ``launch/shardcheck.py`` gates on 2x2 ranks, then minitron-4b R&B at
   full width on 1x2 and 2x1 ranks (2x2 too until slice 17; one 4 x 600
   prefill, 8 decode
   steps; every dot of a prefill and a decode step taught against the
   single-device kernel on the same input; the 2x1 logits bit-equal to
   the unsharded Program's and its drain token-identical to the unsharded
   scheduler's; the 1x2 readings printed beside the unsharded
   Program's own flash-vs-einsum gap); every rank's fused launches held
   to ``fused_per_pass`` with each input on the card, one line per rank
   (launches, taught dots, bank piece shapes, peak memory, wall); then
   ``python -m repro_torch.launch.serve --mesh 1x2`` (its ``main``) serves
   4 requests; since slice 16 the 2x1 ranks also build the model with
   ``cfg.fsdp`` (``fsdp_serving``: prefill and 4 decode steps bit-equal
   to the build without it, from half the bank bytes a rank); since
   slice 18 the caches follow ``cache_pspecs``: each 1x2 rank holds and
   attends with its 4 of the 8 KV heads (half the K/V bytes), every decode
   attention taught against the whole heads' call on the gathered inputs
   (bit-equal), the prefill's recorded all-gather bytes reported (the
   column dots' outputs stay local: the Megatron pairing), 32 decode-
   attention launches a decode step a rank; the 2x1 ranks also run 2
   rows (one a rank) bit-equal to the unsharded Program at 2 rows; and
   shardcheck's sequence-split gate (``seq_cfg``: 3 KV heads, so the
   positions split) on 1x2 on xla within 1e-5; since slice 19
   mamba2-780m R&B (8 decode steps) and deepseek-v2-lite-16b R&B (4; 2
   since slice 22) on 1x2 with SSM states and MLA latents cut by
   ``cache_pspecs``
   (``tp_cache_runs``: the mamba2 logits bit-equal to the unsharded
   Program's);
3p. since slice 16 training on a mesh (``train_mesh_phase``), right after
   ``train``: granite-moe-1b-a400m R&B at full width on 2x1 ranks sharing
   the card, 3 steps data-parallel and 3 with ``cfg.fsdp`` through
   ``launch.train.run(mesh=)`` (FSDP bit-equal to DP; DP step 0 within
   1e-3 of ``train``'s unsharded step 0; the FSDP checkpoint restored in
   this process bit-equal to the ranks' state), then ``Program.loss`` of
   the FSDP build on the mesh on photonic (CE within 1e-3 of the
   unsharded einsum route, every fused launch checked and counted); since
   slice 22 FSDP gathers each block where it runs: the FSDP rank's peak
   below the DP rank's, its gathers and reduce-scatters a step as
   ``sharding.fsdp.planned`` counts them, one block's gathers alive at
   most;
3q. since slice 17 the dry-run (``dryrun_phase``), after ``train_mesh``:
   no GPU work; ``repro_torch.launch.dryrun`` walks the earlier phases'
   steps on meta tensors on the host and is held to what they measured in
   this run: the planned fused-MVM calls of a minitron-4b R&B prefill pass
   and decode pass, granite's resident calls a pass (480) and mamba2's
   ``ssd_chunk`` calls a prefill pass (48) and fused calls a pass, and
   since slice 18 minitron's decode-attention calls a decode pass (32),
   equal the launches those phases counted, exactly; the dry-run's per-device
   memory for ``train``'s cell within [0.75, 1.33] of that phase's
   ``torch.cuda.max_memory_allocated``; the train step's MFU
   (``model_flops`` / median step wall / 989 TFLOP/s) and the analytic
   against the census FLOPs are reported;
4. a ``{"kernels": [...]}`` summary and the ``{"ok": true, ...}`` line.

Tolerances: the MVM kernels compute an exact int32 product while the plain
versions keep the reference's fp32 offset decomposition, so they agree up
to that rounding: rel-L2 <= 2**-8 (bf16 outputs of the fused kernel, fp32
of the split ones).  The resident MVM, like the split one, is
float32 out: rel-L2 <= 2**-8 against its plain version, and each stream
equal bit for bit to the split kernel's output (one integer product, one
rescale expression).  Flash attention reorders fp32 softmax sums, and its
tensor-core variant rounds P to bf16 for the PV product (~2e-3): rel-L2 <=
2**-8; keys past kv_len, even NaN or inf, leave the output bit for bit
unchanged.  The blend is a gather plus the same epilogue: exact without an
activation, rel-L2 <= 2**-8 with silu (the card's exp may differ from the
plain version's in the last bit).  The SSD kernel sums its float32 products
and its cumsum in another order than the plain version: rel-L2 <= 2**-8
for y and the states (at the slow decay, a kernel that dropped a key tile
or a block of state rows would miss it: ``tests/test_torch_ssd.py``), and
since slice 8, which runs its products in 3xTF32, rel-L2 <= 1e-4 for each
(float32 level: one-pass TF32 reads ~4e-4, ``tests/test_torch_ssd.py``).
The decode attention rounds its weights to bf16 before normalising them
(the plain version after): rel-L2 <= 2**-8 in bf16, 1e-5 in float32 (sum
order only), and bit for bit across batch sizes and head groups.
Model-level checks use the repository's W8A8 bound, rel-L2 <= 0.055; the
small dense model's card logits are also held to the CPU program with the
kernels' integer arithmetic at rel-L2 <= 1e-5 (what is left is float32
summation order and flash's softmax).  The small bf16 MLA model's card
logits are held to the CPU program with the kernels' integer MVM
arithmetic and the tensor-core flash's bf16 P at rel-L2 <= 1e-2, that
program taught by the card's MVM inputs (each within 2**-8 rel-L2 of its
own, each differing A8 code a one-step flip within 4 bf16 ulps of its
boundary); untaught, A8 flips of bf16 noise carry the gap to 0.0214 and,
against the plain flash, to 0.062 (PERF.md, slices 10 and 13), reported
beside the former bound 0.07.  The small vlm and whisper
models' card logits are held at rel-L2 <= 1e-5 to that program taught by
the card's MVM inputs: each call's input within 1e-5 of the program's
own, and each A8 code that differs a one-step flip within 2e-3 steps of
its rounding boundary (float32 noise on the per-tensor A8 grid), so no
flip carries through the layers (PERF.md, slice 11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MVM_TOL = 2.0 ** -8
FLASH_TOL = 2.0 ** -8
BLEND_TOL = 2.0 ** -8
W8A8_BOUND = 0.055
SSD_TOL = 2.0 ** -8         # the PR 14 kernel's gate; SSD_F32_TOL below
SSD_F32_TOL = 1e-4          # is tighter and replaces it for the TF32
                            # kernel (one-pass TF32 reads ~4e-4)
EXACT_ARITH_TOL = 1e-5      # card logits vs the CPU program with the
                            # MVM kernels' integer arithmetic
INT8_TOPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12          # H100 SXM, CUDA cores (no tensor cores)
TF32_FLOPS = 495e12         # H100 SXM, tensor cores, dense
TF32X3_FLOPS = TF32_FLOPS / 3   # a 3xTF32 product: three TF32 products
HBM_BYTES_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / (b.norm() + 1e-12))


class Timer:
    """Median CUDA-event time of a call, with the 50 MB L2 flushed (a
    64 MiB write) before every timed launch: on the serving path each
    weight bank is cold when its matmul runs.  A spin kernel queued ahead
    of the timed launches keeps the host ahead of the device, so an event
    pair measures the device's time for the call, not the host's time to
    issue it (the host's cost per step is measured end to end, in the
    decode-step phase)."""

    SPIN_CYCLES = 100_000_000          # ~50 ms at 1.98 GHz

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for start, end in events:
            self.flush_buf.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


# -------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# -------------------------------------------------------------------------
def mvm_cases():
    """(label, M, K, N, transpose, activation, bias_perm) at the serving
    paths' shapes.  minitron-4b (d 3072, kv 1024, d_ff 9216, vocab 256000)
    at decode M = 4 slots and prefill M = 2048 rows; the transposed rows
    are the OBU transpose reuse: wq/wo (square), w_down^T with the gate's
    silu, w_gate^T.  Then both sides of the fused kernel's regime boundary
    (M = 8 decode, 9 tensor cores), 16 and 17, and the scheduler's widths
    (40: its short prompt, 512: its prefill chunk, 600: the generate
    prompt) in both orientations; mamba2-780m's ``w_in`` (1536 -> 2*3072
    + 2*128 + 48 = 6448, not a multiple of 128) at M = 2048;
    granite-moe-1b-a400m's 1024 -> 512 at decode and prefill widths.  Since
    slice 11 the memory streams' projections at one request's rows:
    llama-3.2-vision-11b's ``vision_proj`` (7680 -> 4096) and cross
    ``wk`` / ``wv`` (4096 -> 1024) at its 1601 image tokens, whisper-
    medium's ``audio_proj`` (128 -> 1024) at its 1500 frames; and the two
    models' decode shapes at M = 4 (vlm d 4096, d_ff 14336, vocab 128256;
    whisper d 1024, gelu MLP of 4096, padded vocab 51968), with whisper's
    transposed reuse (its plan's third): the square ``wq`` and ``w_down``
    (1024 -> 4096, the gelu MLP's first dot there)."""
    shapes = [("wq", 3072, 3072, False, "none"),
              ("wq^T", 3072, 3072, True, "none"),
              ("wk", 3072, 1024, False, "none"),
              ("w_gate+silu", 3072, 9216, False, "silu"),
              ("w_down^T+silu", 3072, 9216, True, "silu"),
              ("w_down", 9216, 3072, False, "none"),
              ("w_gate^T", 9216, 3072, True, "none"),
              ("lm_head", 3072, 256000, False, "none")]
    cases = []
    for M in (4, 2048):
        for name, K, N, tr, act in shapes:
            cases.append((f"M={M} {name} {K}->{N}", M, K, N, tr, act, False))
    cases.append(("M=8 bias+relu+block_perm 256->512", 8, 256, 512, False,
                  "relu", True))
    for M in (8, 9, 16, 17, 40, 512, 600):
        for name, K, N, tr, act in shapes[3:5]:
            cases.append((f"M={M} {name} {K}->{N}", M, K, N, tr, act, False))
    cases.append(("M=2048 mamba2 w_in 1536->6448", 2048, 1536, 6448, False,
                  "none", False))
    for M in (4, 2048):
        cases.append((f"M={M} granite expert 1024->512", M, 1024, 512,
                      False, "none", False))
    for label, M, K, N in (("vlm vision_proj", 1601, 7680, 4096),
                           ("vlm cross wk", 1601, 4096, 1024),
                           ("whisper audio_proj", 1500, 128, 1024)):
        cases.append((f"M={M} {label} {K}->{N}", M, K, N, False, "none",
                      False))
    for label, K, N, tr, act in (
            ("vlm wq", 4096, 4096, False, "none"),
            ("vlm wk", 4096, 1024, False, "none"),
            ("vlm w_gate+silu", 4096, 14336, False, "silu"),
            ("vlm w_down", 14336, 4096, False, "none"),
            ("vlm lm_head", 4096, 128256, False, "none"),
            ("whisper wq", 1024, 1024, False, "none"),
            ("whisper wq^T", 1024, 1024, True, "none"),
            ("whisper w_up", 1024, 4096, False, "none"),
            ("whisper w_down^T", 1024, 4096, True, "none"),
            ("whisper w_down", 4096, 1024, False, "none"),
            ("whisper lm_head", 1024, 51968, False, "none")):
        cases.append((f"M=4 {label} {K}->{N}", 4, K, N, tr, act, False))
    return cases


def check_mvm(torch, timer, pm, photonic):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, M, K, N, tr, act, extra in mvm_cases():
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        wshape = (N, K) if tr else (K, N)
        wq = torch.randint(-127, 128, wshape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ws = (torch.rand((N,), generator=gen, device="cuda") * 0.05 + 0.01)
        xs = photonic.a8_scale(x)
        kw = dict(transpose=tr, activation=act)
        if extra:
            kw.update(bias=torch.randn((N,), generator=gen, device="cuda").to(
                torch.bfloat16), block_perm=(2, 0, 3, 1), block=128)
        got = pm.photonic_mvm_fused(x, wq, xs, ws, **kw)
        want = pm.photonic_mvm_fused_plain(x, wq, xs, ws, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        if not (err <= MVM_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"photonic_mvm_fused {label}: rel-L2 {err} "
                                 f"> {MVM_TOL}")
        big = M * K * N > 1e12
        reps = 5 if big else 20
        ms = timer.ms(lambda: pm.photonic_mvm_fused(x, wq, xs, ws, **kw),
                      reps)
        plain_ms = timer.ms(
            lambda: pm.photonic_mvm_fused_plain(x, wq, xs, ws, **kw),
            3 if big else 10)
        xq = torch.clamp(torch.round(x / xs.to(x.dtype)), -128, 127).to(
            torch.int8)
        lib_ms = int_mm_ms(torch, timer, xq, wq, tr, reps)
        nbytes = (M * K * 2 + K * N + 4 * N + M * N * 2
                  + (2 * N if extra else 0))
        ops = 2.0 * M * K * N
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / INT8_TOPS * 1e3
        row = {"case": label, "kernel": "photonic_mvm_fused",
               "regime": pm.launch_plan(M, K, N, tr).regime,
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch._int_mm on the int8 operands (product "
                          "only; rows padded to >= 32)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        emit(row)
        rows.append(row)
    return rows


def int_mm_ms(torch, timer, xq, wq, transpose, reps):
    """Yardstick: cuBLAS int8 x int8 -> int32 (``torch._int_mm``) on the
    same quantized operands.  It needs more than 16 rows, so decode widths
    pad the rows to 32 with zeros; it takes no K or N that is not a
    multiple of 8, so those cases have none (None)."""
    if xq.shape[1] % 8 or wq.shape[0 if transpose else 1] % 8:
        return None
    if xq.shape[0] < 32:
        xq = torch.cat([xq, xq.new_zeros((32 - xq.shape[0], xq.shape[1]))])
    w = wq.t() if transpose else wq
    return timer.ms(lambda: torch._int_mm(xq, w), reps)


def flash_cases():
    """(label, B, Sq, L, q_offset, kv_len, H, KV, hd, hd_v, dtype,
    garbage, causal): minitron-4b attention (24 query heads, 8 KV heads: G
    = 3, hd 128) as a monolithic 2048-token causal prefill, two 600-token
    prompts, and a 512-wide chunk at q_offset 512 against the 2048-slot
    capacity buffer with kv_len < L, once more with NaN and inf in that
    buffer past kv_len (garbage: the output must be finite and equal the
    clean one); one hd_v != hd case, all bf16 (the tensor-core variant);
    and a float32 hd 16 case, the CUDA-core variant that the float32 smoke
    models run.  Since slice 10, deepseek-v2-lite-16b's MLA prefill (16
    heads, KV = H, q/k of nope 128 + rope 64 = 192 against v 128: the
    (192, 128) instantiation) as a 2048-token causal prefill and as the
    same chunk, clean and with garbage past kv_len, in bf16; the small
    bf16 MLA model of ``small_mla_check`` (hd 48, hd_v 32); and the float32
    MLA smoke model's hd 12 / hd_v 8 on the CUDA-core kernel.  Since slice
    11 the non-causal calls, none of whose key lengths is a multiple of
    the 64-key tile: llama-3.2-vision-11b's cross-attention over its 1601
    image tokens (32 heads, 8 KV heads, hd 128) from a 600-token prompt
    and a 2048-token one, whisper-medium's encoder (Sq = L = 1500, 16
    heads, KV = H, hd 64) and its decoder's cross-attention from a
    600-token prompt over the 1500 frames; each at its own key length and
    again in a 2048-row buffer whose rows past the memory (kv_len) hold
    NaN and inf."""
    cases = [("B=1 Sq=L=2048 causal", 1, 2048, 2048, 0, 2048,
              24, 8, 128, 128, "bfloat16", False),
             ("B=2 Sq=L=600 causal", 2, 600, 600, 0, 600, 24, 8, 128, 128,
              "bfloat16", False),
             ("B=1 chunk Sq=512 q_offset=512 L=2048 kv_len=1024", 1, 512,
              2048, 512, 1024, 24, 8, 128, 128, "bfloat16", False),
             ("B=1 chunk Sq=512 q_offset=512 L=2048 kv_len=1024, NaN/inf "
              "past kv_len", 1, 512, 2048, 512, 1024, 24, 8, 128, 128,
              "bfloat16", True),
             ("B=1 Sq=L=300 hd=64 hd_v=96 G=4", 1, 300, 300, 0, 300,
              8, 2, 64, 96, "bfloat16", False),
             ("B=2 Sq=L=128 hd=16 G=2 float32", 2, 128, 128, 0, 128,
              4, 2, 16, 16, "float32", False),
             ("MLA B=1 Sq=L=2048 causal hd=192 hd_v=128", 1, 2048, 2048, 0,
              2048, 16, 16, 192, 128, "bfloat16", False),
             ("MLA B=1 chunk Sq=512 q_offset=512 L=2048 kv_len=1024", 1, 512,
              2048, 512, 1024, 16, 16, 192, 128, "bfloat16", False),
             ("MLA B=1 chunk Sq=512 q_offset=512 L=2048 kv_len=1024, NaN/inf "
              "past kv_len", 1, 512, 2048, 512, 1024, 16, 16, 192, 128,
              "bfloat16", True),
             ("MLA B=2 Sq=L=96 hd=48 hd_v=32", 2, 96, 96, 0, 96, 4, 4, 48, 32,
              "bfloat16", False),
             ("MLA B=2 Sq=L=128 hd=12 hd_v=8 float32", 2, 128, 128, 0, 128,
              4, 4, 12, 8, "float32", False)]
    cases = [c + (True,) for c in cases]
    for name, Sq, M, H, KV, hd in (("vlm cross", 600, 1601, 32, 8, 128),
                                   ("vlm cross", 2048, 1601, 32, 8, 128),
                                   ("whisper encoder", 1500, 1500, 16, 16,
                                    64),
                                   ("whisper cross", 600, 1500, 16, 16, 64)):
        label = f"{name} B=1 Sq={Sq} L={M} hd={hd} G={H // KV} non-causal"
        cases.append((label, 1, Sq, M, 0, M, H, KV, hd, hd, "bfloat16",
                      False, False))
        cases.append((f"{label}, in L=2048 with NaN/inf past kv_len={M}", 1,
                      Sq, 2048, 0, M, H, KV, hd, hd, "bfloat16", True,
                      False))
    return cases


def sdpa_backend(torch, q, k, v, mask):
    """The backend ``F.scaled_dot_product_attention`` picks for these
    inputs (``torch._fused_sdp_choice``), by name."""
    from torch.nn.attention import SDPBackend
    try:
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, False,
                                         enable_gqa=True)
    except (AttributeError, TypeError, RuntimeError) as err:
        return f"not known ({type(err).__name__})"
    return SDPBackend(choice).name


def poison_past(t, kv_len):
    """Fill rows kv_len.. of a (BH, L, d) capacity buffer with NaN, inf and
    -inf: keys no query may see."""
    t[:, kv_len::3] = float("nan")
    t[:, kv_len + 1::3] = float("inf")
    t[:, kv_len + 2::3] = -float("inf")


def check_flash(torch, timer, fa):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (label, B, Sq, L, off, kv_len, H, KV, hd, hdv, dtype,
         garbage, causal) in flash_cases():
        dt = getattr(torch, dtype)
        q = torch.randn((B * H, Sq, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B * KV, L, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B * KV, L, hdv), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
        want = fa.flash_attention_plain(q, k, v, **kw)
        clean = fa.flash_attention(q, k, v, **kw)
        if garbage:
            poison_past(k, kv_len)
            poison_past(v, kv_len)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        if not (err <= FLASH_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {label}: rel-L2 {err} "
                                 f"> {FLASH_TOL}")
        if garbage and not torch.equal(got, clean):
            raise AssertionError(f"flash_attention {label}: keys past "
                                 f"kv_len changed the output")
        ms = timer.ms(lambda: fa.flash_attention(q, k, v, **kw), 10)
        plain_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            5)
        # SDPA yardstick on the same data: (B, H, S, hd) views, the causal
        # mask (if any) on absolute positions, keys past kv_len masked
        # (and, in the garbage case, clean keys: SDPA would spread the NaN)
        q4 = q.view(B, H, Sq, hd)
        k4 = (k.nan_to_num(0.0, 0.0, 0.0) if garbage else k).view(B, KV, L,
                                                                  hd)
        v4 = (v.nan_to_num(0.0, 0.0, 0.0) if garbage else v).view(B, KV, L,
                                                                  hdv)
        qi = off + torch.arange(Sq, device="cuda")[:, None]
        kj = torch.arange(L, device="cuda")[None, :]
        mask = ((kj <= qi) if causal else (qi >= 0)) & (kj < kv_len)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True), 10)
        lib_backend = sdpa_backend(torch, q4, k4, v4, mask)
        pairs = int(mask.sum())                 # visible (query, key) pairs
        flops = 2.0 * (hd + hdv) * pairs * B * H
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + got.numel())
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / (BF16_FLOPS if dt == torch.bfloat16
                         else FP32_FLOPS) * 1e3
        row = {"case": label, "kernel": "flash_attention",
               "variant": fa.flash_variant(dt, hd, hdv), "dtype": dtype,
               "causal": causal,
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "library_backend": lib_backend,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": flops}
        if garbage:
            row["garbage_equals_clean"] = True
        emit(row)
        rows.append(row)
    return rows


# -------------------------------------------------------------------------
# phase 3: the serving path
# -------------------------------------------------------------------------
def small_model_check(torch):
    """A small dense model (the reference's prefill-test shape, float32)
    with flash engaged: the GPU kernels against the CPU plain path on the
    same weights, held to the repository's W8A8 bound, plus a greedy-token
    comparison (reported, not gated: the kernel's exact int32 product and
    the plain fp32 decomposition may round one A8 boundary differently)."""
    from repro_torch import api
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.backend import Backend
    from repro_torch.models import transformer as tfm

    cfg = ModelConfig(name="small", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=97, compute_dtype="float32")
    params = tfm.init_model(cfg, seed=3, device="cpu")
    bk = Backend("photonic", flash_min_seq=64)
    gpu = api.Program.build(cfg, params, execution=bk)
    cpu = api.Program.build(cfg, params, execution=bk, device="cpu")
    exact = api.Program.build(cfg, params, device="cpu",
                              execution=exact_backend(flash_min_seq=64))
    toks = np.random.default_rng(3).integers(0, 97, (2, 96))
    lg_gpu, _ = gpu.prefill({"tokens": toks}, 112)
    lg_cpu, _ = cpu.prefill({"tokens": toks}, 112)
    lg_exact, _ = exact.prefill({"tokens": toks}, 112)
    err = rel_l2(lg_gpu.cpu(), lg_cpu)
    if not (err <= W8A8_BOUND and torch.isfinite(lg_gpu).all()):
        raise AssertionError(f"small model GPU vs CPU rel-L2 {err}")
    err_exact = rel_l2(lg_gpu.cpu(), lg_exact)
    if not err_exact <= EXACT_ARITH_TOL:
        raise AssertionError(f"small model GPU vs the CPU program with the "
                             f"kernels' arithmetic: rel-L2 {err_exact} > "
                             f"{EXACT_ARITH_TOL}")
    same = bool((gpu.generate(toks, 8).cpu() == cpu.generate(toks, 8)).all())
    return {"small_model_gpu_vs_cpu_rel_l2": err,
            "small_model_gpu_vs_exact_arith_rel_l2": err_exact,
            "small_model_plain_vs_exact_arith_rel_l2": rel_l2(lg_cpu,
                                                              lg_exact),
            "small_model_greedy_tokens_equal": same}


def mma_flash_emulated(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    """The tensor-core flash kernel's arithmetic on any device, for bf16
    q/k/v in its layout ((BH_q, Sq, hd), (BH_kv, L, hd), (BH_kv, L,
    hd_v)): float32 scores scaled by log2(e) / sqrt(hd), 64-key tiles with
    a running max, P = exp2(s - max) rounded to bf16 before the PV product
    and summed into l from the rounded values, the output rounded to bf16
    once.  Where the plain version keeps P in float32 (~2e-3 rel-L2 apart
    per call), this differs from the kernel only by float32 summation
    order."""
    import math
    import torch
    BHq, Sq, hd = q.shape
    _, L, _ = k.shape
    G = BHq // k.shape[0]
    k = k.repeat_interleave(G, dim=0).float()
    v = v.repeat_interleave(G, dim=0).float()
    kv_len = L if kv_len is None else kv_len
    s = torch.einsum("bqh,bkh->bqk", q.float(), k) * (
        1.4426950408889634 / math.sqrt(hd))
    kj = torch.arange(L, device=q.device)[None, :]
    vis = kj < kv_len
    if causal:
        vis = vis & (q_offset + torch.arange(Sq, device=q.device)[:, None]
                     >= kj)
    m = torch.full((BHq, Sq, 1), -1e30, device=q.device)
    l = torch.zeros((BHq, Sq, 1), device=q.device)
    acc = torch.zeros((BHq, Sq, v.shape[-1]), device=q.device)
    for k0 in range(0, L, 64):
        st = s[..., k0:k0 + 64].masked_fill(~vis[None, :, k0:k0 + 64], -1e30)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(st > -5e29, torch.exp2(st - m_new),
                        torch.zeros((), device=q.device))
        p = p.to(torch.bfloat16).float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[:, k0:k0 + 64].nan_to_num(0.0, 0.0, 0.0)
        m = m_new
    return (acc / l).to(q.dtype)


def a8_flips(x_own, x_card):
    """Where two inputs of one MVM call (the CPU program's own and the
    card's, the same up to float32 rounding) quantize to different A8
    codes: (count, largest distance in A8 steps from either unrounded value
    to the rounding boundary between the two codes, largest code
    difference).  A flip of one code whose values lie on either side of a
    boundary, within float32 noise of it, is float32 noise on a coarse grid,
    not a kernel error."""
    from repro_torch.core.photonic import quantize_symmetric
    q1, s1 = quantize_symmetric(x_own, 8)
    q2, s2 = quantize_symmetric(x_card, 8)
    differ = q1 != q2
    n = int(differ.sum())
    if not n:
        return 0, 0.0, 0
    a, b = q1[differ].float(), q2[differ].float()
    bound = (a + b) / 2
    dist = max(float((x_own[differ] / s1 - bound).abs().max()),
               float((x_card[differ] / s2 - bound).abs().max()))
    return n, dist, int((a - b).abs().max())


BF16_FLIP_ULPS = 4.0        # a bf16 flip's values lie within this many
                            # bf16 ulps of the boundary they straddle (the
                            # taught bf16 inputs differ by a few ulps at
                            # single elements)
A8_FLIP_BAND = 2e-3         # a flip's two unrounded values lie within this
                            # many A8 steps of the boundary they straddle
                            # (float32 noise at |x / scale| <= 127: 1e-5
                            # rel-L2 of x is 1.3e-3 steps)


def a8_flip_ulps(x_own, x_card) -> float:
    """Where two bf16 inputs of one MVM call quantize to different A8
    codes: the largest distance from either unrounded value to the
    boundary between the two codes, in bf16 ulps of that value (a bf16
    activation carries 8 bits of mantissa, so bf16 noise of a few ulps at
    one element moves it across a boundary only from within those few
    ulps).  0.0 without a flip."""
    import torch
    from repro_torch.core.photonic import quantize_symmetric
    q1, s1 = quantize_symmetric(x_own, 8)
    q2, s2 = quantize_symmetric(x_card, 8)
    differ = q1 != q2
    if not bool(differ.any()):
        return 0.0
    bound = (q1[differ].float() + q2[differ].float()) / 2
    worst = 0.0
    for x, s in ((x_own, s1), (x_card, s2)):
        v = x[differ].float() / s
        ulp = torch.exp2(v.abs().clamp(min=2.0 ** -126).log2().floor() - 7)
        worst = max(worst, float(((v - bound).abs() / ulp).max()))
    return worst


def exact_backend(mma_flash: bool = False, teacher=None, flips=None,
                  input_tol: float = EXACT_ARITH_TOL, **kw):
    """A photonic ``Backend`` whose matmuls run the MVM kernels' arithmetic
    on the CPU (``photonic_mvm.exact_mvm``: the exact integer product,
    rescaled once) where the plain versions keep the reference's offset
    decomposition; the rest (A8 grid, epilogue, attention) is the plain
    path's, except that with ``mma_flash`` a bf16 attention that takes the
    flash path runs the tensor-core kernel's rounding
    (:func:`mma_flash_emulated`).  With ``teacher`` (a deque of the card's
    inputs to each of its MVM calls, in order: ``recording_backend``) each
    call checks its own input against the card's (rel-L2 within
    ``EXACT_ARITH_TOL``; codes that differ must be one-step flips within
    ``A8_FLIP_BAND`` of their boundary, counted into the dict ``flips``)
    and then multiplies the card's: a flip does not carry on through the
    layers, so the logits can be held at kernel-level arithmetic.  A bf16
    program's inputs are held at ``input_tol`` instead, and each flip to
    within ``BF16_FLIP_ULPS`` bf16 ulps of its boundary
    (:func:`a8_flip_ulps`); each
    call's flip count is kept in order (``flips["per_call"]``).  Only
    this script's checks use it."""
    import torch
    from repro_torch.core import backend as backend_lib
    from repro_torch.core.photonic import quantize_symmetric
    from repro_torch.kernels import photonic_mvm as pm

    def force(x):
        card = teacher.popleft()
        if tuple(card.shape) != tuple(x.shape):
            raise AssertionError(f"teacher input {tuple(card.shape)} for an "
                                 f"MVM call on {tuple(x.shape)}")
        err = rel_l2(x, card)
        n, dist, step = a8_flips(x, card)
        flips["calls"] = flips.get("calls", 0) + 1
        flips["max_input_rel_l2"] = max(flips.get("max_input_rel_l2", 0.0),
                                        err)
        flips["a8_flips"] = flips.get("a8_flips", 0) + n
        flips["max_flip_distance"] = max(flips.get("max_flip_distance", 0.0),
                                         dist)
        flips.setdefault("per_call", []).append(n)
        if x.dtype == torch.bfloat16:
            ulps = a8_flip_ulps(x, card)
            flips["max_flip_bf16_ulps"] = max(
                flips.get("max_flip_bf16_ulps", 0.0), ulps)
            far = ulps > BF16_FLIP_ULPS
        else:
            far = dist > A8_FLIP_BAND
        if err > input_tol or step > 1 or far:
            raise AssertionError(f"an MVM input on the card differs from the "
                                 f"CPU program's past float32 noise: rel-L2 "
                                 f"{err}, {n} A8 codes, up to {step} steps, "
                                 f"{dist} steps from their boundary")
        return card

    class ExactBackend(backend_lib.Backend):
        def attention(self, q, k, v, *, causal=True, q_offset=None):
            B, Sq, H, hd = q.shape
            if not (mma_flash and self.use_flash(Sq)
                    and q.dtype == torch.bfloat16):
                return super().attention(q, k, v, causal=causal,
                                         q_offset=q_offset)
            _, L, KV, hdv = v.shape
            o = mma_flash_emulated(
                q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd),
                k.permute(0, 2, 1, 3).reshape(B * KV, L, hd),
                v.permute(0, 2, 1, 3).reshape(B * KV, L, hdv),
                causal=causal, q_offset=int(q_offset or 0))
            return o.reshape(B, H, Sq, hdv).permute(0, 2, 1, 3).reshape(
                B, Sq, H * hdv)

        def _photonic_matmul(self, x, wq, wscale, *, transpose, bias,
                             block_perm, block, activation, bank_tag):
            if self.noise_active:
                raise ValueError("the exact arithmetic has no fault model")
            if teacher is not None:
                x = force(x)
            q, xs = quantize_symmetric(x, 8)
            y = pm.exact_mvm(q.reshape(-1, x.shape[-1]), wq, xs,
                             wscale.reshape(1, -1), transpose)
            y = y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])
            return backend_lib._epilogue_unfused(y, bias, block_perm, block,
                                                 activation)

    return ExactBackend("photonic", **kw)


def recording_backend(records: list, **kw):
    """A photonic ``Backend`` that appends a CPU copy of the input of each
    of its MVM calls to ``records`` (the teacher of ``exact_backend``); not
    for a captured step (the copy waits for the device)."""
    from repro_torch.core import backend as backend_lib

    class RecordingBackend(backend_lib.Backend):
        def _photonic_matmul(self, x, wq, wscale, **k):
            records.append(x.detach().to("cpu", copy=True))
            return super()._photonic_matmul(x, wq, wscale, **k)

    return RecordingBackend("photonic", **kw)


KERNEL_GROUPS = (
    # (kernel of the port, substrings of its CUDA kernels' names)
    ("photonic_mvm_fused", ("::gemv_kernel", "::gemv_t_kernel",
                            "::mma_kernel", "::quantize_kernel")),
    ("photonic_mvm", ("::split_gemv_kernel", "::split_mma_kernel")),
    ("photonic_mvm_t", ("::split_t_gemv_kernel", "::split_t_mma_kernel")),
    ("photonic_mvm_resident", ("::resident_mma_kernel",)),
    ("blend_shuffle", ("::blend_kernel", "::blend_vec_kernel")),
    ("flash_attention", ("::flash_kernel", "::flash_mma_kernel")),
    ("ssd_chunk", ("::ssd_mma_kernel",)),
    ("decode_attention", ("::decode_attention_kernel",)))


def kernel_group(name: str) -> str:
    """The port kernel a profiled CUDA kernel belongs to (by its name), or
    "other torch kernels"."""
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other torch kernels"


def profile_generate(torch, prog, prompt, extras=None):
    """Where the device time goes: ``torch.profiler`` over one
    ``Program.generate`` (one prefill + 7 decode steps; with the modality
    ``extras`` of a vlm or audio model), kernel time summed
    by port kernel, the ten largest CUDA kernels inside "other torch
    kernels" by name (time and launches), and the device's idle share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.generate(prompt, 8, extras=extras)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    other = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        group = kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + ev.self_device_time_total
        if group == "other torch kernels":
            other.append(ev)
    busy = sum(groups.values())
    other.sort(key=lambda ev: -ev.self_device_time_total)
    return {"phase": "profile", "what": f"generate {tuple(prompt.shape)} "
            f"+ 8 tokens", "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
            "kernel_ms": {k: v / 1e3 for k, v in sorted(groups.items())},
            "other_top10": [{"kernel": ev.key[:200],
                             "ms": ev.self_device_time_total / 1e3,
                             "launches": ev.count} for ev in other[:10]]}


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def cross_leaves(tree) -> list:
    """The cross-attention K/V leaves (keys ``ck``, ``cv``) of a cache
    tree, which a decode step reads and must not write."""
    if not isinstance(tree, dict):
        return []
    return [x for k in sorted(tree) for x in
            ([tree[k]] if k in ("ck", "cv") else cross_leaves(tree[k]))]


PROFILE_PRELUDE = 1024      # one-cycle spin kernels ahead of a profiled step


@functools.lru_cache(maxsize=1)
def prelude_graph():
    """A CUDA graph of PROFILE_PRELUDE one-cycle spin kernels, built once:
    replayed first in a profile, it is one host call and no aten op."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PROFILE_PRELUDE):
            torch.cuda._sleep(1)
    return graph


def profile_step(torch, step) -> list:
    """``torch.profiler`` events of one synchronized call of ``step``.  The
    profiler loses the first kernel records of a session (a few, and in
    some processes enough to take the first two fused launches of a
    deepseek decode replay: PERF.md §6, PR 20), so ``prelude_graph``'s
    spin kernels run first, take that loss, and are left out."""
    from torch.profiler import ProfilerActivity, profile
    prelude = prelude_graph()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prelude.replay()
        step()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if "spin_kernel" not in e.key]


def port_kernels(evs) -> dict:
    """CUDA kernels among profiled events, counted per port kernel
    (``KERNEL_GROUPS``); the fused MVM's mma regime also runs
    ``quantize_kernel``, not a launch of its own."""
    from torch.autograd import DeviceType
    kernels = dict.fromkeys((g for g, _ in KERNEL_GROUPS), 0)
    for e in evs:
        group = kernel_group(e.key)
        if (e.device_type == DeviceType.CUDA and group in kernels
                and "::quantize_kernel" not in e.key):
            kernels[group] += e.count
    return kernels


def kernel_ms(evs) -> dict:
    """Device ms of the profiled CUDA kernels by port kernel
    (``KERNEL_GROUPS``; the rest under "other torch kernels")."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in evs:
        if e.device_type == DeviceType.CUDA:
            group = kernel_group(e.key)
            out[group] = out.get(group, 0.0) + e.self_device_time_total / 1e3
    return out


def step_costs(torch, step) -> dict:
    """Host and device cost of one decode step ``step()``: the aten ops it
    dispatches (counted with a ``TorchDispatchMode``; CUDA kernels, graph
    replays among them, are not aten ops), its wall time (median of 5
    synchronized steps) and one profiled step's device busy time, its CUDA
    kernels counted and timed by port kernel (``KERNEL_GROUPS``) and its
    costliest host ops (the launch side of the step; with one
    ``cudaGraphLaunch`` of the profile's prelude)."""
    from torch.autograd import DeviceType
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    evs = profile_step(torch, step)
    cuda = [e for e in evs if e.device_type == DeviceType.CUDA]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    host = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]
    return {"aten_ops": Count.n, "wall_ms_median": statistics.median(times),
            "profiled_device_busy_ms": sum(e.self_device_time_total
                                           for e in cuda) / 1e3,
            "profiled_cuda_kernels": sum(e.count for e in cuda),
            "profiled_kernels": port_kernels(evs),
            "profiled_kernel_ms": kernel_ms(evs),
            "profiled_host_op_self_ms": sum(e.self_cpu_time_total
                                            for e in cpu) / 1e3,
            "top_host_ops": [{"op": e.key, "calls": e.count,
                              "self_cpu_ms": e.self_cpu_time_total / 1e3}
                             for e in host]}


def decode_step_costs(torch, prog):
    """One decode step at the scheduler's shape (capacity 4, 2048-slot
    caches holding seeded random values, rows at positions 700, 0, 300 and
    1500), through ``Program.decode_sample``: eagerly (caches without a
    decode cell), then replayed (the same caches registered to a
    ``DecodeCell``: one warm-up step, the capture, then replays), each with
    ``step_costs``.  From the same caches the replay's logits and caches
    must equal the eager step's bit for bit, and the profiled replay must
    run each port kernel's CUDA kernel as often as the cell adds to its
    launch count per replay.  The eager step must leave the cross-attention
    K/V (vlm, audio) as they were.  A Program the cell does not capture
    reports the rule's reason instead of a replay."""
    caches = prog.empty_caches(4, 2048)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for leaf in tree_leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    saved = [leaf.clone() for leaf in tree_leaves(caches)]

    def restore():
        for leaf, s in zip(tree_leaves(caches), saved):
            leaf.copy_(s)

    toks = np.array([[11], [22], [33], [44]], np.int64)
    pos = np.array([700, 0, 300, 1500])
    out = {"phase": "decode_step", "capacity": 4, "max_len": 2048,
           "eager": step_costs(torch, lambda: prog.decode_sample(
               toks, caches, pos))}
    restore()
    cross = [leaf.clone() for leaf in cross_leaves(caches)]
    want, _ = prog.decode(toks, caches, pos)
    want_caches = [leaf.clone() for leaf in tree_leaves(caches)]
    if cross:
        out["cross_kv_untouched"] = all(
            torch.equal(a, b) for a, b in zip(cross_leaves(caches), cross))
        if not out["cross_kv_untouched"]:
            raise AssertionError("a decode step wrote the cross K/V")
    cell = prog.decode_cell(caches)
    out["decode_graph"] = cell.reason is None
    if cell.reason is not None:
        out["decode_graph_reason"] = cell.reason
        return out
    restore()
    prog.decode(toks, caches, pos)                 # warm-up and capture
    restore()
    got, _ = prog.decode(toks, caches, pos)        # a replay
    same = bool(torch.equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(caches), want_caches))
    if not (same and cell.graph is not None):
        raise AssertionError("the replayed decode step differs from the "
                             "eager step on the same inputs and caches")
    out["replay_logits_bit_equal"] = same
    out["replay"] = step_costs(torch, lambda: prog.decode_sample(
        toks, caches, pos))
    seen = out["replay"]["profiled_kernels"]
    added = {group: cell.delta[group] for group in seen}
    out["replay_kernels_equal_counted"] = seen == added
    if seen != added or not seen["photonic_mvm_fused"]:
        raise AssertionError(f"a profiled replay ran the CUDA kernels {seen}"
                             f"; the cell counts {added} per replay")
    cell.release()
    return out


@contextlib.contextmanager
def eager_cells():
    """Decode cells stepped inside run their static-buffer code eagerly,
    as on the CPU: ``graphs.eager_reason`` gives a reason for every
    Program meanwhile (the comparison drain)."""
    from repro_torch import graphs
    rule = graphs.eager_reason
    graphs.eager_reason = lambda program: "eager comparison drain"
    try:
        yield
    finally:
        graphs.eager_reason = rule


def drain_graph_vs_eager(torch, prog, requests, sched_kw):
    """The requests (rid, prompt, max_new[, extras]) through a scheduler with
    its
    decode graph, the path's main drain, then through one whose decode
    cell stays eager (``eager_cells``): completions token for token
    equal, the same launch counts, and one capture for the graph
    scheduler.  The counters are read just after the graph drain and set
    back to that reading after the eager one, which only compares.
    Returns (the graph drain's completions, the counters just after it, a
    report)."""
    from repro_torch import graphs
    from repro_torch.kernels import counts
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    runs = {}
    for graph in (True, False):
        sched = ContinuousScheduler(prog, **sched_kw)
        for rid, prompt, max_new, *extras in requests:
            sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new,
                                 extras=extras[0] if extras else None))
        before, captures = counts.snapshot(), graphs.CAPTURE_COUNTS["decode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if graph else eager_cells():
            done = sched.drain()
        torch.cuda.synchronize()
        after = counts.snapshot()
        runs[graph] = (done, time.perf_counter() - t0,
                       counts.difference(before, after),
                       graphs.CAPTURE_COUNTS["decode"] - captures, sched,
                       after)
    done, graph_s, launches, captures, sched, window = runs[True]
    eager = runs[False]
    counts.restore(window)
    same = (sorted((c.rid, c.tokens.tolist()) for c in done)
            == sorted((c.rid, c.tokens.tolist()) for c in eager[0]))
    report = {"decode_graph": sched.decode_cell.reason is None,
              "drain_graph_s": graph_s, "drain_eager_s": eager[1],
              "drain_decode_steps": sched.stats.decode_steps,
              "drain_prefill_chunks": sched.stats.prefill_chunks,
              "drain_captures": captures,
              "drain_tokens_equal_eager": same,
              "drain_launches_equal_eager": launches == eager[2]}
    if not (same and launches == eager[2] and report["decode_graph"]
            and captures == 1 and eager[3] == 0):
        raise AssertionError(f"graph drain vs eager drain: {report}, "
                             f"launches {launches} vs {eager[2]}")
    return done, window, report


def generate_captured(torch, prog, prompts, max_new, extras=None):
    """``Program.generate`` timed, with its one decode-graph capture (a
    Program whose cell does not capture makes none)."""
    from repro_torch import graphs
    captures = graphs.CAPTURE_COUNTS["decode"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prog.generate(prompts, max_new, extras=extras)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    B, S = prompts.shape
    if tuple(out.shape) != (B, S + max_new) or not bool(
            (out[:, :S].cpu() == torch.as_tensor(prompts)).all()):
        raise AssertionError(f"generate returned {tuple(out.shape)}")
    made = graphs.CAPTURE_COUNTS["decode"] - captures
    if made != (1 if graphs.eager_reason(prog) is None else 0):
        raise AssertionError(f"generate made {made} decode-graph captures")
    return out, gen_s


def serve(torch, gpu):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("minitron-4b", reuse=True)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = prog.bank_stats()
    emit({"phase": "build", "arch": cfg.name, "R": cfg.reuse.num_basic,
          "T": cfg.reuse.reuse_times, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "padded_vocab": cfg.padded_vocab,
          "dtype": cfg.compute_dtype, "build_s": build_s,
          "bank_int8_bytes": stats["int8_bytes"],
          "bank_fp_bytes": stats["fp_bytes"],
          "verify_banks": prog.verify_banks(),
          "mem_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    prompts = rng.integers(0, V, (2, 600))
    # ContinuousScheduler: monolithic einsum (40, 300), monolithic flash
    # (512) and chunked flash (1300, 1900) admissions, 16 tokens each
    lens = (40, 300, 512, 1300, 1900)
    requests = [(rid, rng.integers(0, V, n), 16) for rid, n in enumerate(lens)]

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    # -- Program.generate: two 600-token prompts (monolithic flash prefill)
    out, gen_s = generate_captured(torch, prog, prompts, 16)
    done, launches, drain = drain_graph_vs_eager(
        torch, prog, requests, dict(capacity=4, max_len=2048,
                                    prefill_chunk=512))
    mvm_launches = launches["photonic_mvm_fused"]
    flash_launches = launches["flash_attention"]

    # outside the counted window: the logits of one 600-token prefill, and
    # the launches of that prefill pass and of one decode step (the
    # dryrun phase holds its planned calls to them)
    reset_counts()
    logits, caches = prog.prefill({"tokens": prompts[:1]}, 616)
    per_prefill = kernel_counts()
    reset_counts()
    prog.decode(out[:1, 600:601], caches, 600)
    per_pass = {"prefill": per_prefill, "decode": kernel_counts()}
    del caches
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite prefill logits")

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    gemv = launches["photonic_mvm_fused_gemv"]
    if not (0 < gemv < mvm_launches and flash_launches > 0
            and launches["flash_attention_mma"] == flash_launches):
        raise AssertionError(f"kernels not on the serving path (both fused "
                             f"regimes, the tensor-core flash): {launches}")
    # generate: 15 decode steps; the drain's; one launch a layer each
    check_decode_attention_launches(
        cfg, launches, 15 + drain["drain_decode_steps"])
    gen_tokens = 2 * 16
    sched_tokens = 16 * len(lens)
    sched_s = drain["drain_graph_s"]
    result = {"phase": "serve", "gpu": gpu, "generate_s": gen_s,
              "generate_tokens_per_s": gen_tokens / gen_s,
              "scheduler_s": sched_s,
              "scheduler_tokens_per_s": sched_tokens / sched_s,
              "scheduler_prompt_tokens": sum(lens),
              "scheduler_decode_steps": drain["drain_decode_steps"],
              "scheduler_prefill_chunks": drain["drain_prefill_chunks"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches, "drain": drain,
              "launches_per_pass": per_pass}
    result.update(small_model_check(torch))
    emit(result)
    emit(profile_generate(torch, prog, prompts[:1]))
    emit(decode_step_costs(torch, prog))
    return launches, per_pass


# -------------------------------------------------------------------------
# phase 3l: the serving launcher with its telemetry (slice 12)
# -------------------------------------------------------------------------
LAUNCH_ARGS = ["--arch", "minitron-4b", "--reuse", "--execution", "photonic",
               "--capacity", "4", "--max-prompt", "1024"]
LAUNCH_MAIN = ["--requests", "12", "--new-tokens", "32"]
LAUNCH_NOISE = "gain=0.01,ct=0.002,dac=0.25,drift=0.05"
FLASH_MIN_SEQ = 512          # Backend.attention's flash threshold


def percentiles(snap) -> dict:
    """p50 / p95 / p99 of the tracker's four latency histograms (ms)."""
    return {k: {q: snap["histograms"][f"serve.{k}"][q]
                for q in ("p50", "p95", "p99")}
            for k in ("ttft_ms", "tpot_ms", "e2e_ms", "queue_ms")}


def launcher_run(torch, launch, prog, argv, obs=None):
    """``launch.serve`` of ``argv`` on the built Program, timed to the
    device's end: (completions, wall seconds)."""
    args = launch.parse_args(argv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = launch.serve(prog, args, obs)
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def check_launcher_trace(path, rids) -> dict:
    """One named row per rid holding its queue, prefill and decode spans
    and its finish instant; ``decode_step`` spans and the
    ``active_slots`` counter track on row 0."""
    evs = json.loads(Path(path).read_text())["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    if rows != {rid: f"req {rid}" for rid in rids}:
        raise AssertionError(f"trace rows {rows}")
    phases = ("queue", "prefill", "decode", "finish")
    for rid in rids:      # row 0 also holds the scheduler's step spans
        got = sorted(e["name"] for e in evs if e["tid"] == rid
                     and e["ph"] in ("X", "i") and e["name"] in phases)
        if got != sorted(phases):
            raise AssertionError(f"trace row of request {rid}: {got}")
    steps = sum(e["name"] == "decode_step" and e["ph"] == "X" for e in evs)
    track = sum(e["name"] == "active_slots" and e["ph"] == "C" for e in evs)
    if not (steps and track):
        raise AssertionError(f"{steps} decode_step spans, {track} "
                             f"active_slots samples")
    return {"events": len(evs), "decode_step_spans": steps,
            "active_slots_samples": track}


def serve_launcher(torch, gpu):
    """``repro_torch.launch.serve`` on minitron-4b R&B at full width and
    depth: the continuous scheduler over 12 requests of 256-1024 tokens
    with --stats, --trace-out and --metrics-out (the counted window), the
    same Program and trace drained again with telemetry off (token for
    token equal), then 4 requests each through the wave batcher, the
    engine and the fault model (noise, bank streaming under an array
    budget below the Program's tiles, calibration)."""
    import tempfile
    from repro_torch import graphs
    from repro_torch.kernels import counts
    from repro_torch.launch import serve as launch
    from repro_torch.obs import check_schema
    from repro_torch.obs import metrics as metrics_lib

    out = Path(tempfile.mkdtemp(prefix="serve_launcher-",
                                dir=ROOT / "build"))
    trace_path, metrics_path = out / "trace.json", out / "metrics.json"
    telemetry = ["--stats", "--stats-every", "8", "--trace-out",
                 str(trace_path), "--metrics-out", str(metrics_path)]
    main_argv = LAUNCH_ARGS + LAUNCH_MAIN + telemetry
    metrics_lib.reset_default_registry()
    args = launch.parse_args(main_argv)
    t0 = time.perf_counter()
    cfg, prog = launch.build_program(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tiles = prog.bank_stats()["mrr_tiles_128"]
    reqs = launch._make_trace(cfg, 12, 1024, 32, device=prog.device)
    buckets = [-(-len(r.prompt) // 16) * 16 for r in reqs]
    if not (min(buckets) < FLASH_MIN_SEQ <= max(buckets)):
        raise AssertionError(f"prefills not on both sides of flash: "
                             f"{buckets}")

    # -- the counted window: telemetry on
    obs = launch.make_obs(cfg, args)
    captures = graphs.CAPTURE_COUNTS["decode"]
    counts.reset()
    done, on_s = launcher_run(torch, launch, prog, main_argv, obs)
    launches = counts.snapshot()
    captured = graphs.CAPTURE_COUNTS["decode"] - captures
    snap = json.loads(metrics_path.read_text())

    got = [(c.rid, len(c.tokens), c.finish_reason) for c in done]
    want = [(r.rid, len(r.prompt) + r.max_new, "length") for r in reqs]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    if check_schema.main([str(metrics_path),
                          str(check_schema.SCHEMA_PATH)]) != 0:
        raise AssertionError("the metrics snapshot fails the schema")
    hist, ctr = snap["histograms"], snap["counters"]
    tpot_want = sum(r.max_new - 1 for r in reqs)
    if (hist["serve.ttft_ms"]["count"], hist["serve.tpot_ms"]["count"]) != (
            12, tpot_want):
        raise AssertionError(f"ttft / tpot samples "
                             f"{hist['serve.ttft_ms']['count']} / "
                             f"{hist['serve.tpot_ms']['count']}, want 12 / "
                             f"{tpot_want}")
    steps = ctr['program.steps{kind="decode_sample"}']
    if not (steps == ctr["serve.decode_steps"] > 0 and captured == 1):
        raise AssertionError(f"program.steps {steps} vs decode steps "
                             f"{ctr['serve.decode_steps']}, {captured} "
                             f"captures")
    gemv, fused = launches["photonic_mvm_fused_gemv"], \
        launches["photonic_mvm_fused"]
    flash = launches["flash_attention"]
    if not (0 < gemv < fused and flash > 0
            and launches["flash_attention_mma"] == flash):
        raise AssertionError(f"kernels not on the launcher's path (both "
                             f"fused regimes, the tensor-core flash): "
                             f"{launches}")
    for name in ("photonic_mvm_fused", "flash_attention"):
        key = f'kernel.launches{{kernel="{name}"}}'
        if ctr[key] != launches[name]:
            raise AssertionError(f"{key} {ctr[key]} != {launches[name]}")
    trace = check_launcher_trace(trace_path, [r.rid for r in reqs])

    # -- the same Program and trace with telemetry off, on and off again
    # (not counted): equal tokens, and drain walls in turns, since the
    # window's drain also pays the Program's first calls
    walls = {"on": [on_s], "off": []}
    for on in (False, True, False):
        argv = main_argv if on else LAUNCH_ARGS + LAUNCH_MAIN
        again, wall = launcher_run(
            torch, launch, prog, argv,
            launch.make_obs(cfg, launch.parse_args(argv)) if on else None)
        if [c.tokens.tolist() for c in again] != [c.tokens.tolist()
                                                  for c in done]:
            raise AssertionError(f"tokens differ with telemetry "
                                 f"{'on' if on else 'off'}")
        walls["on" if on else "off"].append(wall)
    energy = snap["energy"]
    result = {
        "phase": "serve_launcher", "gpu": gpu, "arch": cfg.name,
        "argv": main_argv[:-4], "build_s": build_s,
        "prompt_lens": [len(r.prompt) for r in reqs],
        "max_new": [r.max_new for r in reqs],
        "percentiles_ms": percentiles(snap),
        "mean_occupancy": hist["serve.active_slots"]["mean"],
        "idle_fraction": ctr["serve.idle_slot_steps"]
        / (ctr["serve.decode_steps"] * 4),
        "overhead": 1.0 - ctr["serve.useful_steps"]
        / ctr["serve.slot_steps"],
        "decode_steps": ctr["serve.decode_steps"],
        "program_steps": {k: v for k, v in ctr.items()
                          if k.startswith("program.steps")},
        "reuse_ratio": energy["reuse_ratio"],
        "write_energy_saved_uJ": energy["write_energy_saved_uJ"],
        "drain_s_telemetry_on": walls["on"],
        "drain_s_telemetry_off": walls["off"],
        "tokens_equal_telemetry_off": True, "decode_captures": captured,
        "launches": launches, "trace": trace}
    # the fault-model run's array budget: half the Program's tiles, so
    # the hybrid mapping streams some banks
    from repro_torch import resident
    budget = tiles // 2
    plan = resident.plan_hybrid_mapping(resident.specs_from_program(prog),
                                        budget)
    if not (plan.resident and plan.streamed):
        raise AssertionError(f"budget {budget} of {tiles} tiles: "
                             f"{len(plan.resident)} resident, "
                             f"{len(plan.streamed)} streamed banks")
    del prog
    gc.collect()

    # -- cheaper runs: 4 requests each, full width
    short = ["--requests", "4", "--new-tokens", "32"]
    for scheduler in ("wave", "engine"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = launch.main(LAUNCH_ARGS + short + ["--scheduler", scheduler]
                          + (["--stats"] if scheduler == "wave" else []))
        torch.cuda.synchronize()
        if len(got) != 4 or metrics_lib.enabled():
            raise AssertionError(f"{scheduler}: {len(got)} completions")
        result[f"{scheduler}_s"] = time.perf_counter() - t0
    noisy_path = out / "noisy.json"
    noisy_argv = LAUNCH_ARGS + [
        "--requests", "4", "--new-tokens", "8", "--noise", LAUNCH_NOISE,
        "--calibrate-every", "4", "--array-budget", str(budget), "--stats",
        "--metrics-out", str(noisy_path)]
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = launch.main(noisy_argv)
    torch.cuda.synchronize()
    noisy_s = time.perf_counter() - t0
    noisy = counts.snapshot()
    nsnap = json.loads(noisy_path.read_text())
    gauges = nsnap["gauges"]
    if len(got) != 4 or check_schema.validate(
            nsnap, check_schema.load_schema()):
        raise AssertionError("fault-model launcher run")
    if not (noisy["photonic_mvm"] > 0 and noisy["photonic_mvm_t"] > 0
            and noisy["photonic_mvm_fused"] == 0):
        raise AssertionError(f"the fault model's split kernels: {noisy}")
    if not (gauges["residency.used_tiles"] <= budget
            and gauges["calibration.sweeps"] > 0):
        raise AssertionError(f"residency over budget or no calibration: "
                             f"{gauges}")
    result.update({
        "fault_model": {"argv": noisy_argv[:-2], "array_budget": budget,
                        "mrr_tiles_128": tiles, "wall_s": noisy_s,
                        "banks_resident_streamed": [len(plan.resident),
                                                    len(plan.streamed)],
                        "residency_hit_rate": gauges["residency.hit_rate"],
                        "calibration_sweeps": gauges["calibration.sweeps"],
                        "reuse_ratio": nsnap["energy"]["reuse_ratio"],
                        "write_energy_saved_uJ":
                            nsnap["energy"]["write_energy_saved_uJ"],
                        "launches": noisy}})
    emit(result)
    shutil.rmtree(out)
    return launches


# -------------------------------------------------------------------------
# phase 2, slice 2: the split MVMs and the blend
# -------------------------------------------------------------------------
# -------------------------------------------------------------------------
# phase 3s: sharded execution as ranks on the card (slice 15)
# -------------------------------------------------------------------------
# one prefill of 4 x 600 tokens per mesh: two rows per data shard on 2x1
# (and on 2x2, run at full width until slice 17 cut it for the script's
# time); since slice 18 the 2x1 ranks also run the first 2 rows, one a
# rank (before the batch-invariant decode attention, a rank left one row
# took another float32 einsum path than two rows did, and drifted from
# the unsharded logits after the first decode step)
SHARD_ROWS = 4
SHARD_TWO_ROWS = 2
SHARD_PROMPT = 600
SHARD_DECODE = 8              # then 8 decode steps on the unsharded tokens
SHARD_MESHES = ("1x2", "2x1")
# the 2x1 drain's prompts stay under flash_min_seq, so the unsharded
# scheduler prefills on the einsum path too (flash is off on a mesh)
SHARD_DRAIN_LENS = (40, 200, 300, 450)
SHARD_DRAIN_NEW = 8
# a row-parallel dot rounds each rank's partial to bf16 before the sum:
# against the single-device kernel on the same input, within that rounding
SHARD_SPLIT_TOL = 2.0 ** -8
SHARD_FSDP_DECODE = 2         # the 2x1 FSDP build: the prefill, 2 steps
                              # (4 until the SSM / MLA 1x2 runs joined the
                              # phase: the script's 1200 s limit)


def bank_bytes(bank) -> int:
    """The bytes a rank holds of a Program's bank (every field of a
    programmed bank, every float leaf)."""
    from repro_torch.core import prepared
    total = 0
    for leaf in prepared.tree_leaves(bank):
        ts = ([getattr(leaf, f) for f in prepared.FIELDS]
              if isinstance(leaf, prepared.PreparedTensor) else [leaf])
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def fsdp_serving(mesh, cfg, prompts, tokens, want, dense_bytes):
    """minitron-4b R&B built again with ``cfg.fsdp`` on the same ranks (one
    rank at a time): every bank field and float leaf cut over "data" on its
    "embed" dim and gathered at each use (a float leaf of a stack where
    its block runs).  The prefill and
    ``SHARD_FSDP_DECODE`` decode steps on the same tokens must give the
    logits ``want`` of the build without FSDP bit for bit, with the same
    fused launches per pass.  Returns the rank's bank bytes, peak, walls
    and launches."""
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.kernels import counts
    from repro_torch.models import transformer as tfm

    fcfg = dataclasses.replace(cfg, fsdp=True)
    t0 = time.perf_counter()
    for r in range(mesh.size):
        if r == mesh.rank:
            params = tfm.init_model(fcfg, seed=0, device=mesh.device)
            prog = api.Program.build(fcfg, params, execution="photonic",
                                     mesh=mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prog.prefill({"tokens": prompts},
                                  SHARD_PROMPT + SHARD_DECODE)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = [logits.float().cpu()]
    t0 = time.perf_counter()
    for i, tok in enumerate(tokens[:SHARD_FSDP_DECODE]):
        lg, caches = prog.decode(torch.as_tensor(tok)[:, None].cuda(),
                                 caches, SHARD_PROMPT + i)
        got.append(lg.float().cpu())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts.snapshot()
    per = (fused_per_pass(cfg, prefill=True)
           + fused_per_pass(cfg, prefill=False) * SHARD_FSDP_DECODE)
    out = {"bank_bytes": bank_bytes(prog.bank),
           "bank_bytes_without_fsdp": dense_bytes,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "build_s": build_s, "prefill_s": prefill_s,
           "decode_s": decode_s, "fused_launches": launches[
               "photonic_mvm_fused"], "fused_gemv_launches": launches[
               "photonic_mvm_fused_gemv"], "fused_expected": per,
           "flash_launches": launches["flash_attention"],
           "logits_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(got, want))}
    if not (out["logits_bit_equal"] and len(got) == len(want)
            and out["fused_launches"] == per and not out["flash_launches"]
            and out["bank_bytes"] < dense_bytes):
        raise AssertionError(f"rank {mesh.rank}: the FSDP build {out}")
    return out


def taught_dots(prog, whole, records):
    """``prog``'s backend made to check each sharded photonic dot: after
    the rank's sharded dot, the single-device kernel runs on the same input
    rows at the same A8 scale (the step's max over the data axes) against
    the whole bank ``whole`` (tag -> PreparedTensor), and ``records`` gets
    (rule, rel-L2, bit-equal).  A paired dot's block input (``local_in``)
    is gathered for the single-device call, and a ``local_out`` result is
    held to the rank's block of it.  Returns the backend to restore."""
    from repro_torch.core import backend as backend_lib
    from repro_torch.core.photonic import a8_scale_from_amax
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives as coll

    class Taught(type(prog.backend)):
        def _photonic_matmul_sharded(self, x, prep, pair, *, transpose, bias,
                                     block_perm, block, activation, tp_hint,
                                     local_in=False, local_out=False):
            y = super()._photonic_matmul_sharded(
                x, prep, pair, transpose=transpose, bias=bias,
                block_perm=block_perm, block=block, activation=activation,
                tp_hint=tp_hint, local_in=local_in, local_out=local_out)
            if local_in:
                x = coll.all_gather(x, self.mesh, "model", dim=-1)
            if prep is None:                  # quantized in the step
                wq, ws = pair
            else:
                w = whole[prep.tag]
                for i in prep.placement.index:
                    w = w[i]
                wq, ws = ((w.wq_t, w.scale_t) if transpose
                          else (w.wq, w.scale))
            xs = a8_scale_from_amax(self._rows_amax(x))
            y1 = ops.photonic_matmul_fused(
                x, wq, ws, x_scale=xs, transpose=transpose, bias=bias,
                block_perm=block_perm, block=block,
                activation=activation or "none")
            if local_out:
                y1 = backend_lib._piece(y1, -1, self.mesh)
            rule = backend_lib.partition_rule(
                self.mesh.axis_size("model"), x.shape[-1],
                wq.shape[0] if transpose else wq.shape[1],
                block_perm=block_perm, tp_hint=tp_hint,
                collective=self.tp_collective)
            records.append((rule, rel_l2(y, y1), bool((y == y1).all())))
            return y

    base = prog.backend
    prog.backend = Taught(**{f.name: getattr(base, f.name)
                             for f in dataclasses.fields(base)})
    return base


@contextlib.contextmanager
def taught_decode_attention(mesh, records):
    """Each decode attention on a rank's own KV heads checked against the
    unsharded call: its inputs all-gathered over "model" on their head
    dim, the kernel run on every head, and ``records`` gets whether the
    rank's heads of that call equal the rank's own call bit for bit."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.sharding import collectives as coll

    import torch
    own = da.decode_attention

    def taught(q, ck, cv, k_new, v_new, pos):
        out = own(q, ck, cv, k_new, v_new, pos)
        whole = own(*(coll.all_gather(t.contiguous(), mesh, "model", dim=2)
                      for t in (q, ck, cv, k_new, v_new)), pos)
        B, _, H, hd = q.shape
        i = mesh.index("model")
        mine = whole.reshape(B, 1, -1, hd)[:, :, i * H:(i + 1) * H]
        records.append(bool(torch.equal(mine.reshape(out.shape), out)))
        return out

    da.decode_attention = taught
    try:
        yield
    finally:
        da.decode_attention = own


def kv_bytes(caches, names=("k", "v")) -> tuple:
    """(bytes of a rank's pieces of the cache leaves ``names`` (default:
    the self-attention K/V), bytes of the whole caches they are cut from:
    ``partition.piece_of``)."""
    from repro_torch import api
    from repro_torch.sharding import partition
    held = whole = 0
    for name, leaf in api._cache_leaves(caches):
        if name in names:
            held += leaf.numel() * leaf.element_size()
            shape = partition.piece_of(leaf)[1]
            whole += int(np.prod(shape)) * leaf.element_size()
    return held, whole


@contextlib.contextmanager
def row_trace(records):
    """Record, per call of each op a decode step runs row by row (the
    embedding, the norms, RoPE, each fused MVM, the decode attention), a
    digest of each row of its output: ``records`` gets (op, [sha1 of row
    0, row 1, ...]).  Two runs of the same steps on other batch sizes line
    up call by call, and the first call whose row digests differ names the
    op whose output depends on the batch."""
    import hashlib
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm

    targets = [(tfm, "embed"), (tfm, "apply_norm"), (attention, "apply_rope"),
               (ops, "photonic_matmul_fused"), (da, "decode_attention")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def traced(name, fn):
        def call(*args, **kw):
            y = fn(*args, **kw)
            rows = y.detach().float().cpu().numpy()
            records.append((name, [hashlib.sha1(r.tobytes()).hexdigest()
                                   for r in rows]))
            return y
        return call

    for mod, name, fn in saved:
        setattr(mod, name, traced(name, fn))
    try:
        yield records
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def first_row_difference(got, want, row: int):
    """The first traced call (index, op) whose digest of ``got``'s only row
    differs from ``want``'s row ``row``, or None."""
    for i, ((op, g), (_, w)) in enumerate(zip(got, want)):
        if g[0] != w[row]:
            return {"call": i, "op": op}
    return None


def two_row_run(prog, prompts, tokens):
    """The prefill of ``prompts`` (2 rows: one a rank on 2x1) and a decode
    step per row of ``tokens``: the logits of every step on the CPU, and
    the decode steps' ``row_trace``."""
    import torch
    logits, caches = prog.prefill({"tokens": torch.as_tensor(prompts)
                                   .cuda()}, SHARD_PROMPT + SHARD_DECODE)
    out = [logits.float().cpu()]
    with row_trace([]) as trace:
        for i, tok in enumerate(tokens):
            lg, caches = prog.decode(torch.as_tensor(tok)[:, None].cuda(),
                                     caches, SHARD_PROMPT + i)
            out.append(lg.float().cpu())
    return out, trace


def sharded_rank(mesh, job):
    """One rank of the full-width sharded runs (``launch.mesh.init_ranks``
    starts it, ranks sharing the card over gloo): minitron-4b R&B built on
    the rank's mesh (one rank at a time, to cap the card's peak), then
    ``job["prompts"]`` prefilled and ``SHARD_DECODE`` decode steps on
    ``job["tokens"]`` (the unsharded run's greedy tokens), and with
    ``job["drain"]`` a ``ContinuousScheduler`` drain.  The counted window
    holds exactly those steps: every fused-MVM input on the card, and the
    rank's fused launches equal to ``fused_per_pass`` per pass
    (reduce_scatter: one kernel a dot), no flash, ``attention_per_decode``
    decode-attention launches a decode step; the prefill's collectives
    are recorded (bytes by kind) and its K/V caches must be half the
    unsharded ones' bytes (the rank's KV heads on 1x2, its rows on 2x1).
    Then, outside it, the prefill and one decode step again with each dot
    taught (``taught_dots``) against the whole bank and, on 1x2, each
    decode attention against the whole heads' call
    (``taught_decode_attention``); with ``job["two_rows"]`` (prompts,
    tokens) the 2-row run (``two_row_run``).  Returns the logits and
    completions, the launch counts and the rank's report."""
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core import prepared
    from repro_torch.kernels import counts
    from repro_torch.kernels import photonic_mvm as pm
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.sharding import collectives as coll

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("minitron-4b", reuse=True)
    t0 = time.perf_counter()
    for r in range(mesh.size):
        if r == mesh.rank:
            params = tfm.init_model(cfg, seed=0, device=mesh.device)
            whole = {leaf.tag: leaf for leaf in prepared.tree_leaves(
                prepared.prepare_params(params, cfg.compute_dtype, True))
                if isinstance(leaf, prepared.PreparedTensor)}
            prog = api.Program.build(cfg, params, execution="photonic",
                                     mesh=mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    build_s = time.perf_counter() - t0
    per_prefill = fused_per_pass(cfg, prefill=True)
    per_decode = fused_per_pass(cfg, prefill=False)
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "transport": mesh.describe(), "build_s": build_s}

    wq_shapes, off_card = set(), []
    fused = pm.photonic_mvm_fused

    def on_card(x, wq, x_scale, w_scale, **kw):
        for t in (x, wq, x_scale, w_scale, kw.get("bias")):
            if t is not None and t.device.type != "cuda":
                off_card.append(tuple(t.shape))
        wq_shapes.add(tuple(wq.shape))
        return fused(x, wq, x_scale, w_scale, **kw)

    prompts = torch.as_tensor(job["prompts"]).cuda()
    torch.cuda.reset_peak_memory_stats()
    pm.photonic_mvm_fused = on_card
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with coll.recording() as moved:
        logits, caches = prog.prefill({"tokens": prompts},
                                      SHARD_PROMPT + SHARD_DECODE)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_collective_bytes"] = {
        kind: sum(n for k, n in moved if k == kind)
        for kind in sorted({k for k, _ in moved})}
    out["kv_bytes"], out["kv_bytes_unsharded"] = kv_bytes(caches)
    if counts.snapshot()["photonic_mvm_fused"] != per_prefill:
        raise AssertionError(f"rank {mesh.rank}: prefill fused launches "
                             f"{counts.snapshot()} != {per_prefill}")
    steps = [logits.float().cpu()]
    t0 = time.perf_counter()
    for i, tok in enumerate(job["tokens"]):
        lg, caches = prog.decode(torch.as_tensor(tok)[:, None].cuda(),
                                 caches, SHARD_PROMPT + i)
        steps.append(lg.float().cpu())
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    out["logits"] = steps
    out["cache_rows"] = int(caches["main"]["l0"]["k"].shape[2])
    want = per_prefill + per_decode * len(job["tokens"])
    if "drain" in job:
        sched = ContinuousScheduler(prog, capacity=4, max_len=512)
        for rid, prompt, max_new in job["drain"]:
            sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        t0 = time.perf_counter()
        done = sched.drain()
        torch.cuda.synchronize()
        out["drain_s"] = time.perf_counter() - t0
        out["tokens"] = {c.rid: c.tokens.tolist() for c in done}
        out["drain_decode_steps"] = sched.stats.decode_steps
        out["pool_rows"], out["pool_lo"] = sched.pool.rows, sched.pool.lo
        want += (per_prefill * len(job["drain"])
                 + per_decode * sched.stats.decode_steps)
    launches = counts.snapshot()
    pm.photonic_mvm_fused = fused
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if off_card:
        raise AssertionError(f"rank {mesh.rank}: fused-MVM inputs off the "
                             f"card: {off_card[:4]}")
    if launches["photonic_mvm_fused"] != want or launches[
            "flash_attention"] != 0:
        raise AssertionError(f"rank {mesh.rank}: launches {launches}, "
                             f"fused expected {want}, flash 0 on a mesh")
    decode_steps = len(job["tokens"]) + out.get("drain_decode_steps", 0)
    check_decode_attention_launches(cfg, launches, decode_steps)
    tp = mesh.axis_size("model")
    if 2 * out["kv_bytes"] != out["kv_bytes_unsharded"]:
        raise AssertionError(f"rank {mesh.rank}: K/V {out['kv_bytes']} B of "
                             f"{out['kv_bytes_unsharded']} (half a rank)")

    # outside the counted window: each dot of a prefill and a decode step
    # against the single-device kernel on the same input, and (KV heads
    # over "model") each decode attention against every head's call
    records, attn = [], []
    base = taught_dots(prog, whole, records)
    _, caches = prog.prefill({"tokens": prompts}, SHARD_PROMPT + 1)
    with taught_decode_attention(mesh, attn) if tp > 1 \
            else contextlib.nullcontext():
        prog.decode(torch.as_tensor(job["tokens"][0])[:, None].cuda(),
                    caches, SHARD_PROMPT)
    prog.backend = base
    out["decode_attention_taught"] = {"calls": len(attn),
                                      "bit_equal": sum(attn)}
    if tp > 1 and not (len(attn) == attention_per_decode(cfg)
                       and all(attn)):
        raise AssertionError(f"rank {mesh.rank}: decode attention on its "
                             f"heads {out['decode_attention_taught']} "
                             f"(every call bit-equal to the whole heads')")
    if "two_rows" in job:
        out["two_rows_logits"], out["two_rows_trace"] = two_row_run(
            prog, *job["two_rows"])
    taught = {}
    for rule, rel, same in records:
        t = taught.setdefault(rule, {"calls": 0, "bit_equal": 0,
                                     "max_rel_l2": 0.0})
        t["calls"] += 1
        t["bit_equal"] += same
        t["max_rel_l2"] = max(t["max_rel_l2"], rel)
    for rule, t in taught.items():
        ok = (t["bit_equal"] == t["calls"] if rule in ("column",
                                                       "replicated")
              else t["max_rel_l2"] <= job["split_tol"])
        if not ok:
            raise AssertionError(f"rank {mesh.rank}: taught {rule} dots "
                                 f"{t} (column/replicated bit-equal, row "
                                 f"rules within {job['split_tol']})")
    if len(records) != per_prefill + per_decode:
        raise AssertionError(f"rank {mesh.rank}: {len(records)} taught "
                             f"dots, {per_prefill + per_decode} expected")
    if job.get("act_modes"):
        out["act_modes"] = act_mode_prefills(prog, cfg, prompts)
    if job.get("fsdp"):
        dense_bytes = bank_bytes(prog.bank)
        del prog, whole, caches
        gc.collect()
        torch.cuda.empty_cache()
        out["fsdp"] = fsdp_serving(mesh, cfg, prompts, job["tokens"],
                                   steps[:SHARD_FSDP_DECODE + 1],
                                   dense_bytes)
    out.update({"launches": launches, "fused_expected": want,
                "fused_per_prefill": per_prefill,
                "fused_per_decode": per_decode, "taught_dots": taught,
                "wq_shapes": sorted(wq_shapes),
                "rank_wall_s": time.perf_counter() - t_rank})
    return out


# the residual cut over "model" (slice 20): minitron's 1x2 prefill with
# the "seq" and "hidden" specs against the serving spec's on each rank
ACT_HIDDEN_TOL = 2.0 ** -8    # a "hidden" layer's residual piece vs the
                              # serving spec's channels (bf16)


def act_mode_prefills(prog, cfg, prompts) -> dict:
    """On a rank's Program (its placed bank), the functional prefill
    (``api.prefill_step_fn`` over the bank) of ``prompts`` under the
    serving spec ("replicated") and the "seq" and "hidden" specs: per
    mode the wall, the fused launches (each held to its plain version,
    ``checked_kernels``), and every layer's residual as the rank holds it
    (``transformer.apply_layer``'s output): its bytes, and against the
    serving spec's layer output (the rank's block of positions, bit for
    bit, or of channels, within ``ACT_HIDDEN_TOL``).  The last logits
    under "seq" and "hidden" must equal the serving spec's bit for bit.
    Raises on a failed gate."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import counts
    from repro_torch.models import transformer as tfm

    bk = prog.backend
    mesh = bk.mesh
    B = prompts.shape[0]
    layer = tfm.apply_layer
    base, out, bad = {}, {}, []
    for mode in ("replicated", "seq", "hidden"):
        ap = (api._serve_act_pspec(bk, B) if mode == "replicated"
              else api._act_pspec_of(bk, B, mode))
        fn = api.prefill_step_fn(cfg, SHARD_PROMPT + 1, act_pspec=ap,
                                 execution=bk)
        hs = []

        def recorded(*a, **k):
            h, c, aux = layer(*a, **k)
            hs.append(h)
            return h, c, aux

        worst = {}
        tfm.apply_layer = recorded
        counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with checked_kernels(worst):
                logits, caches = fn(prog.bank, {"tokens": prompts})
            torch.cuda.synchronize()
        finally:
            tfm.apply_layer = layer
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        del caches
        r = {"wall_s": wall, "act_pspec": [str(e) for e in ap],
             "fused_launches": launches["photonic_mvm_fused"],
             "flash_launches": launches["flash_attention"],
             "calls_vs_plain": {k: {"calls": c, "max_rel_l2": e}
                                for k, (c, e) in worst.items()},
             "layers": len(hs),
             "residual_bytes": hs[0].numel() * hs[0].element_size(),
             "residual_shape": list(hs[0].shape)}
        calls = worst.get("photonic_mvm_fused", (0, 1.0))
        if not (calls[0] == r["fused_launches"] > 0
                and calls[1] <= MVM_TOL and r["flash_launches"] == 0):
            bad.append(f"{mode}: launches {r}")
        if mode == "replicated":
            base = {"logits": logits, "hs": hs}
            out[mode] = r
            continue
        tp = mesh.axis_size("model")
        m = mesh.index("model")
        rels, same = [], 0
        for got, whole in zip(hs, base["hs"]):
            if mode == "seq":
                n = whole.shape[1] // tp
                want = whole[:, m * n:(m + 1) * n]
            else:
                n = whole.shape[-1] // tp
                want = whole[..., m * n:(m + 1) * n]
            same += bool(torch.equal(got, want))
            rels.append(rel_l2(got, want))
        r.update({"layers_bit_equal": same, "max_layer_rel_l2": max(rels),
                  "residual_bytes_replicated": base["hs"][0].numel()
                  * base["hs"][0].element_size(),
                  "logits_bit_equal": bool(torch.equal(logits,
                                                       base["logits"]))})
        out[mode] = r
        if not r["logits_bit_equal"]:
            bad.append(f"{mode}: logits differ from the serving spec's")
        if len(hs) != len(base["hs"]) or 2 * r["residual_bytes"] != \
                r["residual_bytes_replicated"]:
            bad.append(f"{mode}: residual {r['residual_bytes']} B a layer "
                       f"of {r['residual_bytes_replicated']} (half)")
        if mode == "seq" and same != len(hs):
            bad.append(f"seq: {same} of {len(hs)} layers bit-equal")
        if mode == "hidden" and not max(rels) <= ACT_HIDDEN_TOL:
            bad.append(f"hidden: a layer at {max(rels)} rel-L2")
        del hs
    del base
    if bad:
        raise AssertionError(f"rank {mesh.rank}: act modes {bad}")
    return out


# the SSM and MLA caches by ``cache_pspecs`` (slice 19): mamba2-780m R&B
# and deepseek-v2-lite-16b R&B at full width on 1x2 ranks
TP_CACHE_MESH = "1x2"
TP_SSM_HEADS = 24             # a rank's share of mamba2's 48 SSM heads
TP_MLA_TOL = 2.0 ** -8        # an MLA decode layer on the rank's latent
                              # positions, taught, vs the unsharded layer
TP_MLA_DECODE = 2             # the MLA run's decode steps (3.5 s each a
                              # rank over gloo; 4 until slice 23: the
                              # script's 1200 s limit),
                              # in caches of SHARD_PROMPT + SHARD_DECODE


@contextlib.contextmanager
def layer_calls(module, name, seen=None, teach=None, out=None):
    """``module.<name>``, a mixer called as ``fn(p, cfg, x, ...)``, wrapped
    for the window: the i-th call's x replaced by ``teach[i]`` (taught),
    ``seen`` given each call's x (on the CPU) and ``out`` its result."""
    own = getattr(module, name)
    n = [0]

    def call(p, cfg, x, *args, **kw):
        if teach is not None:
            x = teach[n[0]].to(x.device)
        n[0] += 1
        if seen is not None:
            seen.append(x.detach().cpu())
        y = own(p, cfg, x, *args, **kw)
        if out is not None:
            out.append(y)
        return y

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, own)


def tp_cache_cfg(arch: str):
    """The 1x2 run's model: mamba2-780m R&B (12 x 4), or deepseek-v2-lite
    R&B at ``serve_mla``'s depth (``mla_config``), both at full width."""
    from repro_torch.configs import get_arch
    return get_arch("mamba2-780m", reuse=True) if arch == "ssm" \
        else mla_config()


def tp_cache_rank(mesh, job):
    """One rank of a 1x2 run of ``job["arch"]`` ("ssm": mamba2-780m, "mla":
    deepseek-v2-lite-16b; ``tp_cache_cfg``), each rank built in turn: the
    4 x 600 prefill of ``job["prompts"]`` and a decode step on each of
    ``job["tokens"]`` in the counted window (fused launches equal to
    the unsharded Program's per pass, no flash; SSM: ``ssd_chunk`` once a
    layer, each launch on the rank's ``TP_SSM_HEADS`` heads), the caches'
    pieces half the whole caches' bytes.  Outside it, a prefill and a
    decode step with every dot taught (``taught_dots``) and each mixer
    taught the unsharded run's input (``job["taught"]``, a file): SSM, each
    layer's ``h`` / ``conv`` after the prefill bit-equal to the unsharded
    Program's heads / channels; MLA, each decode layer within
    ``TP_MLA_TOL``."""
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import prepared
    from repro_torch.kernels import counts, ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import partition

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    ssm = job["arch"] == "ssm"
    cfg = tp_cache_cfg(job["arch"])
    t0 = time.perf_counter()
    for r in range(mesh.size):
        if r == mesh.rank:
            params = tfm.init_model(cfg, seed=0, device=mesh.device)
            whole = {leaf.tag: leaf for leaf in prepared.tree_leaves(
                prepared.prepare_params(params, cfg.compute_dtype, True))
                if isinstance(leaf, prepared.PreparedTensor)}
            prog = api.Program.build(cfg, params, execution="photonic",
                                     mesh=mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "transport": mesh.describe(),
           "build_s": time.perf_counter() - t0}
    per_prefill, per_decode = job["fused_per_pass"]
    L = SHARD_PROMPT + SHARD_DECODE
    prompts = torch.as_tensor(job["prompts"]).cuda()
    heads = []
    own_ssd = ops.ssd_chunk

    def ssd_heads(x, dA, B, C):
        heads.append(int(x.shape[3]))
        return own_ssd(x, dA, B, C)

    ops.ssd_chunk = ssd_heads
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with coll.recording() as moved:
        logits, caches = prog.prefill({"tokens": prompts}, L)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_collective_bytes"] = {
        kind: sum(n for k, n in moved if k == kind)
        for kind in sorted({k for k, _ in moved})}
    out["prefill_launches"] = counts.snapshot()
    steps = [logits.float().cpu()]
    t0 = time.perf_counter()
    for i, tok in enumerate(job["tokens"]):
        lg, caches = prog.decode(torch.as_tensor(tok)[:, None].cuda(),
                                 caches, SHARD_PROMPT + i)
        steps.append(lg.float().cpu())
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    launches = counts.snapshot()
    ops.ssd_chunk = own_ssd
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["logits"] = steps
    out["launches"] = launches
    out["ssd_heads"] = sorted(set(heads))
    want = per_prefill + per_decode * len(job["tokens"])
    if launches["photonic_mvm_fused"] != want or launches[
            "flash_attention"] or launches["decode_attention"]:
        raise AssertionError(f"rank {mesh.rank} {cfg.name}: launches "
                             f"{launches}, fused expected {want}, flash and "
                             f"decode attention 0")
    if launches["ssd_chunk"] != (cfg.num_layers if ssm else 0) or (
            ssm and heads != [TP_SSM_HEADS] * cfg.num_layers):
        raise AssertionError(f"rank {mesh.rank} {cfg.name}: ssd_chunk "
                             f"{launches['ssd_chunk']} launches on "
                             f"{sorted(set(heads))} heads")
    out["cache_bytes"] = {}
    for name in (("h", "conv") if ssm else ("ckv", "kr")):
        held, whole_b = kv_bytes(caches, (name,))
        out["cache_bytes"][name] = [held, whole_b]
        if 2 * held != whole_b:
            raise AssertionError(f"rank {mesh.rank} {cfg.name}: {name} "
                                 f"{held} B of {whole_b} (half a rank)")
    del caches, logits

    tok0 = torch.as_tensor(job["tokens"][0])[:, None].cuda()
    # outside the counted window: a prefill and a decode step with each
    # mixer taught the unsharded input and each dot taught against the
    # single-device kernel on its own input (``taught_dots``)
    data = torch.load(job["taught"], map_location="cpu")
    records = []
    base = taught_dots(prog, whole, records)
    if ssm:
        with layer_calls(ssm_lib, "ssm_forward", teach=data["inputs"]):
            _, caches = prog.prefill({"tokens": prompts}, L)
        layers = {}
        for (name, got), want in zip(api._cache_leaves(caches),
                                     data["leaves"]):
            want_t = partition.local_slice(want, partition.piece_of(got)[0],
                                           mesh)
            same = [bool(torch.equal(got[r, t].cpu(), want_t[r, t]))
                    for r in range(got.shape[0])
                    for t in range(got.shape[1])]
            n = layers.setdefault(name, {"layers": 0, "bit_equal": 0})
            n["layers"] += len(same)
            n["bit_equal"] += sum(same)
        prog.decode(tok0, caches, SHARD_PROMPT)
        prog.backend = base
        out["taught_layers"] = layers
        if not all(v["bit_equal"] == v["layers"] == cfg.num_layers
                   for v in layers.values()):
            raise AssertionError(f"rank {mesh.rank}: taught h / conv "
                                 f"pieces {layers} (every layer bit-equal "
                                 f"to the unsharded heads / channels)")
    else:
        ys = []
        with layer_calls(attn_lib, "mla_forward", teach=data["inputs"]):
            _, caches = prog.prefill({"tokens": prompts}, L)
        with layer_calls(attn_lib, "mla_decode",
                         teach=data["decode_inputs"], out=ys):
            prog.decode(tok0, caches, SHARD_PROMPT)
        prog.backend = base
        rels = [rel_l2(y[0].float().cpu(), w)
                for y, w in zip(ys, data["decode_outputs"])]
        out["taught_layers"] = {"calls": len(rels), "rel_l2": rels,
                                "max_rel_l2": max(rels), "tol": TP_MLA_TOL}
        if len(rels) != len(data["decode_outputs"]) or max(rels) > \
                TP_MLA_TOL:
            raise AssertionError(f"rank {mesh.rank}: taught MLA decode "
                                 f"layers {out['taught_layers']}")
    del data, caches
    taught = {}
    for rule, rel, same in records:
        t = taught.setdefault(rule, {"calls": 0, "bit_equal": 0,
                                     "max_rel_l2": 0.0})
        t["calls"] += 1
        t["bit_equal"] += same
        t["max_rel_l2"] = max(t["max_rel_l2"], rel)
    out["taught_dots"] = taught
    for rule, t in taught.items():
        ok = (t["bit_equal"] == t["calls"] if rule in ("column",
                                                       "replicated")
              else t["max_rel_l2"] <= job["split_tol"])
        if not ok:
            raise AssertionError(f"rank {mesh.rank}: taught {rule} dots "
                                 f"{t} (column/replicated bit-equal, row "
                                 f"rules within {job['split_tol']})")
    if len(records) != per_prefill + per_decode:
        raise AssertionError(f"rank {mesh.rank}: {len(records)} taught "
                             f"dots, {per_prefill + per_decode} expected")
    out["rank_wall_s"] = time.perf_counter() - t_rank
    return out


def tp_cache_runs(torch, gpu) -> dict:
    """The sharded phase's (a) mamba2-780m R&B and (b) deepseek-v2-lite-16b
    R&B (``serve_mla``'s depth) at full width on 1x2 ranks
    (``tp_cache_rank``), each against the unsharded Program on the card on
    the same weights: its logits of a 4 x 600 prefill and ``SHARD_DECODE``
    (SSM) or ``TP_MLA_DECODE`` (MLA) greedy decode steps (the einsum attention route a mesh runs), its fused
    launches per pass, and, written to a file under ``build/`` for the
    ranks, its mixer inputs (every SSM prefill layer; every MLA layer of
    the prefill and of the first decode step, with the decode layers'
    outputs) and its SSM caches after the prefill.  The ranks' logits must
    be equal.  The SSM run's logits must equal the unsharded Program's bit
    for bit at every step (its cut is exact and each of its dots runs the
    unsharded rule, column where "model" divides the output); the MLA
    run's are printed, not gated (its scatter ``wo`` and the decode join
    round otherwise: Queue C 1).  The SSM run's ``ssd_chunk`` launches a
    rank are held to the dry-run's planned calls for a 1x2 rank
    (48 a prefill pass, each on 24 heads: its planned operations)."""
    from repro_torch import api
    from repro_torch.kernels import counts
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tfm

    scratch = ROOT / "build" / "chip_smoke_tp_caches"
    scratch.mkdir(parents=True, exist_ok=True)
    results = {}
    try:
        for arch in ("ssm", "mla"):
            t0 = time.perf_counter()
            ssm = arch == "ssm"
            cfg = tp_cache_cfg(arch)
            rng = np.random.default_rng(17 if ssm else 18)
            prompts = rng.integers(0, cfg.vocab_size,
                                   (SHARD_ROWS, SHARD_PROMPT))
            params = tfm.init_model(cfg, seed=0)
            prog = api.Program.build(cfg, params, execution="photonic")
            del params
            prog.backend = dataclasses.replace(prog.backend, flash=False)
            mod, fn = (ssm_lib, "ssm_forward") if ssm else (attn_lib,
                                                            "mla_forward")
            seen, dec_in, dec_out = [], [], []
            counts.reset()
            with layer_calls(mod, fn, seen=seen):
                logits, caches = prog.prefill(
                    {"tokens": prompts}, SHARD_PROMPT + SHARD_DECODE)
            per_prefill = counts.snapshot()["photonic_mvm_fused"]
            # a copy: the decode steps below update the caches in place
            leaves = ([v.to("cpu", copy=True) for _, v in
                       api._cache_leaves(caches)] if ssm else None)
            ref, tokens = [logits.float().cpu()], []
            for i in range(SHARD_DECODE if ssm else TP_MLA_DECODE):
                tok = torch.argmax(ref[-1], dim=-1).numpy()
                tokens.append(tok)
                counts.reset()
                with (layer_calls(attn_lib, "mla_decode", seen=dec_in,
                                  out=dec_out) if i == 0 and not ssm
                      else contextlib.nullcontext()):
                    lg, caches = prog.decode(
                        torch.as_tensor(tok)[:, None].cuda(), caches,
                        SHARD_PROMPT + i)
                if i == 0:
                    per_decode = counts.snapshot()["photonic_mvm_fused"]
                ref.append(lg.float().cpu())
            path = scratch / f"{arch}.pt"
            torch.save({"inputs": seen, "leaves": leaves,
                        "decode_inputs": dec_in,
                        "decode_outputs": [y[0].float().cpu()
                                           for y in dec_out]}, path)
            del prog, caches, logits, lg, seen, leaves, dec_in, dec_out
            gc.collect()
            torch.cuda.empty_cache()
            unsharded_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            job = {"arch": arch, "prompts": prompts, "tokens": tokens,
                   "taught": str(path), "split_tol": SHARD_SPLIT_TOL,
                   "fused_per_pass": (per_prefill, per_decode)}
            ranks = mesh_lib.init_ranks(tp_cache_rank, TP_CACHE_MESH,
                                        device="cuda", args=(job,))
            path.unlink()
            rels = [rel_l2(got, want) for got, want in
                    zip(ranks[0]["logits"], ref)]
            same = all(all(torch.equal(a, b) for a, b in
                           zip(r["logits"], ranks[0]["logits"]))
                       for r in ranks)
            # the SSM cut is exact and every dot of its steps runs the
            # single device's rule on the same input: gated bit-equal
            bit_equal = all(torch.equal(a, b)
                            for a, b in zip(ranks[0]["logits"], ref))
            reading = {"prefill_rel_l2": rels[0], "decode_rel_l2": rels[1:],
                       "ranks_equal": same, "bit_equal": bit_equal,
                       "gated": ssm}
            if ssm:
                calls, planned_ops = planned_calls(
                    cfg, "prefill", SHARD_ROWS, SHARD_PROMPT,
                    mesh=TP_CACHE_MESH, with_ops=True)
                s = cfg.ssm
                nc = -(-SHARD_PROMPT // s.chunk)
                one = 2 * SHARD_ROWS * nc * TP_SSM_HEADS * (
                    s.chunk ** 2 * (s.d_state + s.head_dim)
                    + s.chunk * s.d_state * s.head_dim)
                reading["ssd_planned_calls"] = calls["ssd_chunk"]
                reading["ssd_planned_ops"] = planned_ops["ssd_chunk"]
                reading["ssd_planned_ops_at_24_heads"] = one * cfg.num_layers
                if not (calls["ssd_chunk"] == ranks[0]["launches"][
                        "ssd_chunk"] == cfg.num_layers and planned_ops[
                        "ssd_chunk"] == one * cfg.num_layers):
                    raise AssertionError(f"ssd_chunk: planned {calls}, "
                                         f"{planned_ops['ssd_chunk']} ops, "
                                         f"measured {ranks[0]['launches']}")
            for r in ranks:
                r.pop("logits")
                emit({"phase": f"sharded_{arch}_rank", "gpu": gpu,
                      "mesh": TP_CACHE_MESH, "arch": cfg.name, **r})
            wall = {"unsharded_s": unsharded_s,
                    "ranks_s": time.perf_counter() - t1,
                    "wall_s": time.perf_counter() - t0}
            emit({"phase": f"sharded_{arch}_reading", "gpu": gpu,
                  "mesh": TP_CACHE_MESH, "arch": cfg.name,
                  "fused_per_pass": [per_prefill, per_decode],
                  **reading, **wall})
            if not same or not all(np.isfinite(rels)) or (
                    ssm and not bit_equal):
                raise AssertionError(f"{cfg.name} on {TP_CACHE_MESH}: ranks "
                                     f"equal {same}, rel-L2 {rels} (SSM: "
                                     f"bit-equal to the unsharded logits)")
            results[arch] = dict(reading, **wall)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return results


def seq_readings(rep) -> dict:
    """Worst rel-L2 over ranks and steps of shardcheck's sequence-split
    gate, per case."""
    return {str(case): max(rel_l2(a, b) for r in rep["ranks"]
                           for a, b in zip(r["seq"][case]["logits"], want))
            for case, want in rep["unsharded_seq"].items()}


def sharded_phase(torch, gpu):
    """(a) The small float32 model's shardcheck gates as 2x2 ranks on the
    card (parity, collectives, DP serving, dropped rules, refusals, the R&B
    and MoE variants, the sequence-split caches), then its sequence-split
    gate on 1x2 on xla (within 1e-5).  (b) minitron-4b R&B at full width
    on 1x2 and 2x1 ranks (2x2 as well until slice 17): one 4 x 600 prefill
    and 8 decode steps on the unsharded run's tokens, each rank's fused
    launches held to ``fused_per_pass``, and every dot of a prefill and a
    decode step taught against the single-device kernel on the same input
    (``sharded_rank``).  The 2x1 (data-parallel) logits must equal the
    unsharded Program's bit for bit, at 4 rows and at 2 (one a rank), and
    its drain of 4 requests the unsharded scheduler's tokens at the
    same capacity; its ranks then build the model again with ``cfg.fsdp``
    (``fsdp_serving``), whose prefill and 4 decode steps must give the
    same logits bit for bit from half the bank bytes a rank.  The 1x2
    readings are printed beside the
    unsharded Program's own distance between its two attention routes
    (flash, and the einsum a mesh runs): at full width with random
    weights, one float rounding moved anywhere carries the logits that far
    (per-tensor A8 scales couple every row), past the 0.055 bound, so
    those readings are not gated end to end; the taught dots are.  (c)
    mamba2-780m R&B and deepseek-v2-lite-16b R&B on 1x2 with their SSM
    states and MLA latents cut by ``cache_pspecs`` (``tp_cache_runs``: the
    SSM logits gated bit-equal to the unsharded Program's).  Last,
    ``launch.serve``'s ``--mesh 1x2`` serves 4 requests.  Since slice 20
    the 1x2 minitron ranks also prefill under the "seq" and "hidden"
    residual specs (``act_mode_prefills``): logits bit-equal to the
    serving spec's, every "seq" layer's residual block bit-equal and every
    "hidden" one within ``ACT_HIDDEN_TOL``, half the residual bytes, each
    fused launch held to its plain version."""
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardcheck as sc
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    t0 = time.perf_counter()
    fails, rep = sc.run("2x2", "photonic", serve=True, collectives=True,
                        dropped=True, refusals=True, variants=True, seq=True,
                        device="cuda")
    if fails:
        raise AssertionError(f"shardcheck on the card: {fails}")
    lr, dr = rep["unsharded"]
    r0 = rep["ranks"][0]
    emit({"phase": "sharded_small", "gpu": gpu, "mesh": "2x2",
          "transport": r0["transport"],
          "prefill_rel_l2": rel_l2(r0["prefill"], lr),
          "decode_rel_l2": rel_l2(r0["decode"], dr),
          "variants_rel_l2": {
              k: [rel_l2(v[0], rep["unsharded_variants"][k][0]),
                  rel_l2(v[1], rep["unsharded_variants"][k][1])]
              for k, v in r0["variants"].items()},
          "seq_rel_l2": seq_readings(rep),
          "wall_s": time.perf_counter() - t0})
    # the sequence branch on xla, float32: within 1e-5 (shardcheck's gate)
    t1 = time.perf_counter()
    fails, rep = sc.run("1x2", "xla", seq=True, device="cuda")
    if fails:
        raise AssertionError(f"shardcheck --seq on the card: {fails}")
    emit({"phase": "sharded_seq", "gpu": gpu, "mesh": "1x2",
          "execution": "xla", "arch": sc.seq_cfg().name,
          "kv_heads": sc.seq_cfg().num_kv_heads,
          "k_shapes": {str(c): rep["ranks"][0]["seq"][c]["k_shape"]
                       for c in sc.SEQ_CASES},
          "seq_rel_l2": seq_readings(rep), "gate": sc.SEQ_TOL,
          "wall_s": time.perf_counter() - t1})

    t_minitron = time.perf_counter()
    cfg = get_arch("minitron-4b", reuse=True)
    rng = np.random.default_rng(15)
    V = cfg.vocab_size
    prompts = rng.integers(0, V, (SHARD_ROWS, SHARD_PROMPT))
    drain = [(rid, rng.integers(1, V, n).astype(np.int32), SHARD_DRAIN_NEW)
             for rid, n in enumerate(SHARD_DRAIN_LENS)]
    # the unsharded Program on the card, same weights (seed 0), on both
    # attention routes: flash at 600 rows (its default) and the einsum a
    # mesh runs (use_flash is off there, as in the reference)
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    flash_on = prog.backend
    runs = {}
    for route in ("einsum", "flash"):
        prog.backend = dataclasses.replace(flash_on,
                                           flash=route == "flash")
        logits, caches = prog.prefill({"tokens": prompts},
                                      SHARD_PROMPT + SHARD_DECODE)
        ref, tokens = [logits.float().cpu()], []
        for i in range(SHARD_DECODE):
            tok = (torch.argmax(ref[-1], dim=-1).numpy() if route == "einsum"
                   else runs["einsum"][1][i])
            tokens.append(tok)
            lg, caches = prog.decode(torch.as_tensor(tok)[:, None].cuda(),
                                     caches, SHARD_PROMPT + i)
            ref.append(lg.float().cpu())
        runs[route] = (ref, tokens)
    prog.backend = flash_on
    ref, tokens = runs["einsum"]
    route_gap = [rel_l2(a, b) for a, b in zip(runs["flash"][0], ref)]
    # the 2-row case on the einsum route (one row a 2x1 rank): its greedy
    # tokens, then its logits and row trace on those tokens
    prog.backend = dataclasses.replace(flash_on, flash=False)
    two = prompts[:SHARD_TWO_ROWS]
    logits, caches = prog.prefill({"tokens": two},
                                  SHARD_PROMPT + SHARD_DECODE)
    tokens2 = [torch.argmax(logits.float().cpu(), dim=-1).numpy()]
    for i in range(SHARD_DECODE - 1):
        lg, caches = prog.decode(torch.as_tensor(tokens2[-1])[:, None]
                                 .cuda(), caches, SHARD_PROMPT + i)
        tokens2.append(torch.argmax(lg.float().cpu(), dim=-1).numpy())
    ref2, trace2 = two_row_run(prog, two, tokens2)
    prog.backend = flash_on
    sched = ContinuousScheduler(prog, capacity=4, max_len=512)
    for rid, prompt, max_new in drain:
        sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    want_tokens = {c.rid: c.tokens.tolist() for c in sched.drain()}
    del prog, caches, sched, logits
    gc.collect()
    torch.cuda.empty_cache()

    readings = {}
    for shape in SHARD_MESHES:
        job = {"prompts": prompts, "tokens": tokens,
               "split_tol": SHARD_SPLIT_TOL}
        if shape == "2x1":
            job["drain"] = drain
            job["fsdp"] = True
            job["two_rows"] = (two, tokens2)
        else:
            job["act_modes"] = True
        ranks = mesh_lib.init_ranks(sharded_rank, shape, device="cuda",
                                    args=(job,))
        if shape == "1x2":
            act_modes = [r.pop("act_modes") for r in ranks]
        rels = [rel_l2(got, want) for got, want in
                zip(ranks[0]["logits"], ref)]
        same = all(all(torch.equal(a, b) for a, b in
                       zip(r["logits"], ranks[0]["logits"])) for r in ranks)
        exact = all(torch.equal(a, b) for a, b in
                    zip(ranks[0]["logits"], ref))
        readings[shape] = {"prefill_rel_l2": rels[0],
                           "decode_rel_l2": rels[1:],
                           "bit_equal_to_unsharded": exact,
                           "ranks_equal": same}
        if shape == "2x1":
            # each rank holds one of the 2 rows: its logits gathered, its
            # trace its own row's
            two_rels = [[rel_l2(a, b) for a, b in
                         zip(r["two_rows_logits"], ref2)] for r in ranks]
            readings[shape]["two_rows"] = {
                "rel_l2": two_rels,
                "bit_equal_to_unsharded": all(
                    all(torch.equal(a, b) for a, b in
                        zip(r["two_rows_logits"], ref2)) for r in ranks),
                "traced_calls": len(trace2),
                "first_difference": [first_row_difference(
                    r["two_rows_trace"], trace2, i)
                    for i, r in enumerate(ranks)]}
        drains = [r.pop("tokens", None) for r in ranks]
        for r in ranks:
            r.pop("logits")
            r.pop("two_rows_logits", None)
            r.pop("two_rows_trace", None)
            emit({"phase": "sharded_rank", "gpu": gpu, "mesh": shape, **r})
        emit({"phase": "sharded_reading", "gpu": gpu, "mesh": shape,
              **readings[shape]})
        if not same or not all(np.isfinite(rels)):
            raise AssertionError(f"{shape}: ranks equal {same}, rel-L2 "
                                 f"{rels}")
        if shape == "2x1":
            # data parallel: the abs-max over "data" makes every dot the
            # unsharded one, so logits and tokens are the unsharded ones
            if not exact:
                raise AssertionError(f"2x1 logits not bit-equal to the "
                                     f"unsharded Program: {rels}")
            two_rows = readings[shape]["two_rows"]
            if not two_rows["bit_equal_to_unsharded"]:
                # ``first_difference`` names the first op whose output rows
                # moved with the batch
                raise AssertionError(f"2x1 at {SHARD_TWO_ROWS} rows (one a "
                                     f"rank) not bit-equal to the unsharded "
                                     f"Program: {two_rows}")
            for r, got in zip(ranks, drains):
                if got != want_tokens:
                    bad = sorted(k for k in want_tokens
                                 if got.get(k) != want_tokens[k])
                    raise AssertionError(f"2x1 rank {r['rank']}: drain "
                                         f"tokens differ from the unsharded "
                                         f"scheduler's (rids {bad})")
    seconds = {"minitron_s": time.perf_counter() - t_minitron}
    # the SSM states and MLA latents by cache_pspecs on 1x2 (slice 19)
    t1 = time.perf_counter()
    tp_caches = tp_cache_runs(torch, gpu)
    seconds["ssm_mla_s"] = time.perf_counter() - t1
    # the launcher's --mesh, as a user runs it: it spawns its ranks, each
    # serves the trace, rank 0 reports and returns its completions
    from repro_torch.launch import serve as launch
    t1 = time.perf_counter()
    got = launch.main(LAUNCH_ARGS + ["--mesh", "1x2", "--requests", "4",
                                     "--max-prompt", "256",
                                     "--new-tokens", "8"])
    if not (len(got) == 4 and all(
            c.finish_reason == "length" and len(c.tokens) > c.prompt_len
            for c in got)):
        raise AssertionError(f"launcher --mesh 1x2: {got}")
    seconds["launcher_s"] = time.perf_counter() - t1
    emit({"phase": "sharded_launcher", "gpu": gpu, "mesh": "1x2",
          "requests": len(got),
          "new_tokens": [len(c.tokens) - c.prompt_len for c in got],
          "wall_s": seconds["launcher_s"]})
    result = {"phase": "sharded", "gpu": gpu, "arch": cfg.name,
              "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
              "d_model": cfg.d_model, "d_ff": cfg.d_ff,
              "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
              "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
              "readings": readings,
              "act_modes_1x2": act_modes,
              "unsharded_route_gap_rel_l2": route_gap,
              "drain_2x1_token_identical": True,
              "drain_requests": len(drain),
              "transport": ranks[0]["transport"],
              "ssm_mla_1x2": tp_caches,
              "sub_phase_s": seconds,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


def split_cases():
    """(label, M, K, N, transpose): the split pipeline's matmuls at the
    fused kernel's serving shapes — minitron-4b's 3072->3072 (wq, wo),
    3072->1024 (wk, wv), 3072->9216 (w_gate, w_up), 9216->3072 (w_down)
    and the 3072->256000 lm head — in both orientations, at decode M = 4
    and prefill M = 2048.  Then the row counts the fault-model path gives
    the kernels: M = 1 (its generate's decode), 40 and 512 (the
    scheduler's short prompt and prefill chunk) and 600 (the generate
    prompt: a partly filled last row tile), at 3072->3072, 3072->9216 and
    9216->3072; and ragged shapes: K = 4100 (rows not 16-byte aligned), N
    = 300 and 200 (part-filled column tiles), at M = 5 and 8 (the 8-row
    decode stream) and 600."""
    shapes = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072),
              (3072, 256000)]
    cases = [(M, K, N) for M in (4, 2048) for K, N in shapes]
    cases += [(M, K, N) for M in (1, 40, 512, 600)
              for K, N in ((3072, 3072), (3072, 9216), (9216, 3072))]
    cases += [(5, 4100, 300), (8, 4100, 300), (600, 4100, 200)]
    return [(f"M={M} {K}->{N}{' ^T' if tr else ''}", M, K, N, tr)
            for M, K, N in cases for tr in (False, True)]


def check_split(torch, timer, pm, photonic, ops):
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, M, K, N, tr in split_cases():
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        xq, xs = photonic.quantize_symmetric(x, 8)
        wq = torch.randint(-127, 128, (N, K) if tr else (K, N),
                           generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.05 + 0.01
        kernel = pm.photonic_mvm_t if tr else pm.photonic_mvm
        plain = pm.photonic_mvm_t_plain if tr else pm.photonic_mvm_plain
        name = "photonic_mvm_t" if tr else "photonic_mvm"
        plan = (pm.split_t_launch_plan if tr else pm.split_kn_launch_plan)(
            M, K, N)
        got = kernel(xq, wq, xs, ws)
        want = plain(xq, wq, xs, ws)
        # the fused-vs-split gate at kernel level: the split output cast to
        # x's dtype against the fused kernel on the same x
        fused = ops.photonic_matmul_fused(x, wq, ws, transpose=tr)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got - want).abs().max())
        if not (err <= MVM_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"{name} {label}: rel-L2 {err} > {MVM_TOL}")
        if not torch.equal(got.to(x.dtype), fused):
            raise AssertionError(f"{name} {label}: cast to {x.dtype}, "
                                 f"differs from the fused kernel")
        del fused
        # each orientation against the other on the transposed bank: one
        # integer product, one rescale
        other = (pm.photonic_mvm if tr else pm.photonic_mvm_t)(
            xq, wq.t().contiguous(), xs, ws)
        other_name = "photonic_mvm" if tr else "photonic_mvm_t"
        if not torch.equal(got, other):
            raise AssertionError(f"{name} {label}: differs from {other_name} "
                                 f"on the transposed bank")
        del other
        big = M * K * N > 1e12
        reps = 5 if big else 20
        ms = timer.ms(lambda: kernel(xq, wq, xs, ws), reps)
        plain_ms = timer.ms(lambda: plain(xq, wq, xs, ws), 3 if big else 10)
        lib_ms = int_mm_ms(torch, timer, xq, wq, tr, reps)
        # the fused kernel on the same bank (its A8 scale precomputed): the
        # yardstick of the decode regime, which runs its stream
        xs_fused = photonic.a8_scale(x)
        fused_ms = timer.ms(lambda: pm.photonic_mvm_fused(
            x, wq, xs_fused, ws, transpose=tr), reps)
        nbytes = M * K + K * N + 4 * N + 4 + 4 * M * N
        ops_n = 2.0 * M * K * N
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops_n / INT8_TOPS * 1e3
        row = {"case": label, "kernel": name, "regime": plan.regime,
               "splits": plan.splits,
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch._int_mm on the int8 operands (product "
                          "only; rows padded to >= 32)",
               "fused_ms": fused_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops_n,
               "split_cast_equals_fused": True,
               f"equals_{other_name}_on_transposed_bank": True}
        emit(row)
        rows.append(row)
        del got, want, x, xq, wq
    return rows


def blend_cases():
    """(label, M, C, block, dtype, act, with_bias, offset):
    ``Backend.shuffle``'s blocked shuffle of minitron-4b's 3072 channels in
    blocks of 128 (24 blocks, no bias, no activation), bf16, at decode M =
    4 and a 2048-row prefill, and once with a bias and silu (the vector
    pass).  Then each side of the kernel's choice of pass: float32 (4-wide
    vectors), 3000 channels in blocks of 100 (a multiple of 4 float32 but
    not of 8 bf16: the element pass in bf16), and an x that is contiguous
    but starts one element into its buffer (not 16-byte aligned: the
    element pass)."""
    cases = [(M, 3072, 128, "bfloat16", act, b, 0) for M in (4, 2048)
             for act, b in (("none", False), ("silu", True))]
    cases += [(2048, 3072, 128, "float32", "none", False, 0),
              (4, 3072, 128, "float32", "silu", True, 0),
              (2048, 3000, 100, "bfloat16", "none", False, 0),
              (2048, 3000, 100, "bfloat16", "silu", True, 0),
              (2048, 3000, 100, "float32", "none", False, 0),
              (2048, 3072, 128, "bfloat16", "none", False, 1),
              (4, 3072, 128, "bfloat16", "silu", True, 1)]
    return [(f"M={M} C={C} block={block} {act}{' +bias' if b else ''}"
             f"{'' if dt == 'bfloat16' else ' ' + dt}"
             f"{f' x at +{off}' if off else ''}", M, C, block, dt, act, b,
             off) for M, C, block, dt, act, b, off in cases]


def check_blend(torch, timer, blend):
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for label, M, C, block, dt, act, with_bias, off in blend_cases():
        dtype = getattr(torch, dt)
        perm = tuple(torch.randperm(C // block, generator=torch.Generator()
                                    .manual_seed(5)).tolist())
        idx = torch.as_tensor(blend.gather_index(perm, block), device="cuda")
        # an (M, C) view of a flat buffer from element `off` on: contiguous,
        # and not 16-byte aligned when off > 0
        flat = torch.randn((M * C + off,), generator=gen, device="cuda").to(
            dtype)
        x = flat[off:].view(M, C)
        bias = (torch.randn((C,), generator=gen, device="cuda").to(dtype)
                if with_bias else None)
        kw = dict(block=block, activation=act)
        got = blend.blend_shuffle(x, bias, perm, **kw)
        want = blend.blend_shuffle_plain(x, bias, perm, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        ok = (bool(torch.equal(got, want)) if act == "none"
              else err <= BLEND_TOL)
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"blend_shuffle {label}: rel-L2 {err}")
        ms = timer.ms(lambda: blend.blend_shuffle(x, bias, perm, **kw), 20)
        plain_ms = timer.ms(
            lambda: blend.blend_shuffle_plain(x, bias, perm, **kw), 20)
        lib_ms = (timer.ms(lambda: x.index_select(-1, idx), 20)
                  if act == "none" and bias is None else None)
        esize = x.element_size()
        nbytes = (2 * M * C * esize + 4 * (C // block)
                  + (esize * C if bias is not None else 0))
        row = {"case": label, "kernel": "blend_shuffle",
               "pass": ("vector" if blend.vector_path(block, x, bias)
                        else "element"),
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "x.index_select(-1, idx) (no bias/activation "
                          "only)",
               "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
               "bytes": nbytes, "ops": 0}
        emit(row)
        rows.append(row)
    return rows


# -------------------------------------------------------------------------
# phase 3b: the fault-model serving path
# -------------------------------------------------------------------------
NOISE_SPEC = dict(gain_sigma=0.01, crosstalk=0.002, dac_sigma=0.25,
                  drift_gain_per_nm=0.05)
WRITES_PER_ACCESS = 2e4     # drift stress per serving access: the first
                            # sweep (4th decode step) finds stale banks


def kernel_counts() -> dict:
    """Every wrapper's launch count (``kernels/counts.py``; a replayed
    decode graph adds its captured launches)."""
    from repro_torch.kernels import counts
    return counts.snapshot()


def attention_per_decode(cfg) -> int:
    """Decode-attention launches of one decode pass of ``cfg``: one per
    self-attention layer application of the decoder (MLA decodes in its
    latent space, an SSM layer has no attention, cross-attention reads its
    memory with the einsum)."""
    from repro_torch.models import transformer as tfm
    if cfg.mla is not None:
        return 0
    return sum(spec.num_groups * sum(k in ("attn", "attn_cross")
                                     for k in spec.mixer_kinds)
               for spec in tfm.build_segments(cfg)
               if spec.stream != "encoder")


def check_decode_attention_launches(cfg, launches, decode_steps) -> None:
    """The window's decode-attention launches: ``attention_per_decode`` a
    decode step, on the card (the wrapper counts launches only)."""
    want = attention_per_decode(cfg) * decode_steps
    if launches["decode_attention"] != want:
        raise AssertionError(f"decode_attention launches "
                             f"{launches['decode_attention']} != {want} "
                             f"({decode_steps} decode steps of {cfg.name})")


def reset_counts() -> None:
    from repro_torch.kernels import counts
    counts.reset()


def serve_noisy(torch, gpu):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.core.backend import Backend
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.obs.meter import PhotonicMeter, StackProfile
    from repro_torch.resident import (BankResidencyManager, DriftClock,
                                      ProgramResidency, specs_from_program)
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.calibration import CalibrationLoop
    from repro_torch.serve.scheduler import ContinuousScheduler

    cfg = get_arch("minitron-4b", reuse=True)
    cfg = dataclasses.replace(cfg, reuse=dataclasses.replace(
        cfg.reuse, shuffle_block=128))
    noise = NoiseConfig(**NOISE_SPEC)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(
        cfg, params, execution=Backend("photonic", fused=False, noise=noise))
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    specs = specs_from_program(prog)
    manager = BankResidencyManager(sum(s.tiles for s in specs))
    meter = PhotonicMeter(StackProfile.from_cfg(cfg))
    residency = ProgramResidency(manager, specs)
    residency.bind_meter(meter)
    clock = DriftClock(manager, writes_per_access=WRITES_PER_ACCESS)
    loop = CalibrationLoop(prog, manager, clock=clock, every_steps=4,
                           meter=meter)
    sched = ContinuousScheduler(prog, capacity=4, max_len=2048,
                                prefill_chunk=512, residency=residency,
                                calibration=loop)
    rng = np.random.default_rng(1)
    lens = (40, 300, 1300)
    for rid, n in enumerate(lens):
        sched.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                                          n), max_new=16))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = sched.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = kernel_counts()

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    for name in ("photonic_mvm", "photonic_mvm_t", "blend_shuffle",
                 "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} not on the fault-model path: "
                                 f"{launches}")
    if launches["photonic_mvm_fused"] != 0:
        raise AssertionError(f"the fused kernel ran on the split path: "
                             f"{launches}")
    cal = loop.report()
    if not (cal["sweeps"] > 0 and cal["reprograms"] > 0):
        raise AssertionError(f"calibration did not repair: {cal}")
    res = manager.report()
    installs = res["install_writes_mats"] + res["streamed_writes_mats"]
    if not (meter.bank_writes == installs + res["calibration_writes_mats"]
            and meter.calibration_writes == res["calibration_writes_mats"]):
        raise AssertionError(f"write ledger: meter {meter.bank_writes} vs "
                             f"installs {installs} + calibration "
                             f"{res['calibration_writes_mats']}")
    for c in done:
        if not (np.asarray(c.tokens) >= 0).all():
            raise AssertionError("negative token id")
    # the stated rule: the fault model's decode step is not captured
    from repro_torch import graphs
    if not (sched.decode_cell.reason == graphs.NOISE_RULE
            and sched.decode_cell.graph is None):
        raise AssertionError("the fault-model decode step was captured")
    emit({"phase": "serve_fault_model", "gpu": gpu, "arch": cfg.name,
          "decode_graph": False,
          "decode_graph_reason": sched.decode_cell.reason,
          "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
          "shuffle_block": cfg.reuse.shuffle_block, "dtype": cfg.compute_dtype,
          "noise": NOISE_SPEC, "build_s": build_s, "drain_s": drain_s,
          "prompt_tokens": sum(lens), "generated_tokens": 16 * len(lens),
          "tokens_per_s": 16 * len(lens) / drain_s,
          "decode_steps": sched.stats.decode_steps,
          "prefill_chunks": sched.stats.prefill_chunks,
          "launches": launches, "calibration": cal,
          "max_readback_err": cal["max_readback_err"],
          "residency": {k: v for k, v in res.items() if k != "endurance"},
          "meter": meter.report(),
          "live_bank_ages": len(prog.backend.noise.bank_ages),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    prompt = rng.integers(0, cfg.vocab_size, (1, 600))
    emit(profile_generate(torch, prog, prompt))
    emit(decode_step_costs(torch, prog))
    return launches


# -------------------------------------------------------------------------
# phase 3c: a small model on the card
# -------------------------------------------------------------------------
def small_model_fault_checks(torch):
    """The drift bench's model (``smoke_variant("deepseek-7b")``, float32):
    fused vs split logits with noise off; the drift bench's gates on the
    card (three rungs, against the port's xla path); crosstalk-only noise,
    which draws nothing at random, on the card vs the CPU plain path."""
    from repro_torch import api, drift_bench
    from repro_torch.configs import smoke_variant
    from repro_torch.core.backend import Backend
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.models import transformer as tfm

    cfg = smoke_variant("deepseek-7b")
    params = tfm.init_model(cfg, seed=0, device="cpu")
    # the drift bench's prompt shape (B=2, T=12); the W8A8 gap to xla on
    # this model is prompt-dependent (0.035-0.063 over seeds on the CPU):
    # these prompts read 0.048 there, the reference bench's own 0.0479
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12))
    out = {"phase": "small_model_fault", "arch": cfg.name,
           "dtype": cfg.compute_dtype}

    def build(backend, device=None):
        return api.Program.build(cfg, params, execution=backend,
                                 device=device)

    pf, pu = build(Backend("photonic")), build(Backend("photonic",
                                                       fused=False))
    lf, cf = pf.prefill({"tokens": toks}, 14)
    lu, cu = pu.prefill({"tokens": toks}, 14)
    df, _ = pf.decode(toks[:, :1], cf, 12)
    du, _ = pu.decode(toks[:, :1], cu, 12)
    errs = (rel_l2(lu, lf), rel_l2(du, df))
    out["fused_vs_split_bitwise"] = bool(torch.equal(lf, lu)
                                         and torch.equal(df, du))
    out["fused_vs_split_rel_l2"] = max(errs)
    if not max(errs) <= MVM_TOL:
        raise AssertionError(f"fused vs split rel-L2 {errs} > {MVM_TOL}")

    noise0, ages, step = drift_bench.drift_noise(rungs=3)
    rows, loop, meter, manager = drift_bench.run_sweeps(
        build(Backend("photonic", noise=noise0)), build("xla"),
        {"tokens": toks}, cfg=cfg, noise0=noise0, ages=ages, rung_step=step,
        cache_len=14)
    drift_bench.check_gates(rows, loop, meter, manager)
    out["drift_rungs"] = [{k: r[k] for k in ("age_writes", "uncal_rel_l2",
                                             "cal_rel_l2", "readback_err",
                                             "reprogrammed_banks")}
                          for r in rows]

    ct = Backend("photonic", fused=False, noise=NoiseConfig(crosstalk=0.003))
    gpu, cpu = build(ct), build(ct, device="cpu")
    lg, _ = gpu.prefill({"tokens": toks}, 14)
    lc, _ = cpu.prefill({"tokens": toks}, 14)
    err = rel_l2(lg.cpu(), lc)
    same = bool((gpu.generate(toks, 6).cpu() == cpu.generate(toks, 6)).all())
    out["crosstalk_gpu_vs_cpu_rel_l2"] = err
    out["crosstalk_greedy_tokens_equal"] = same
    if not (err <= W8A8_BOUND and same):
        raise AssertionError(f"crosstalk-only GPU vs CPU: rel-L2 {err}, "
                             f"tokens equal {same}")
    emit(out)


# -------------------------------------------------------------------------
# phase 2, slice 3: the reuse-resident MVM
# -------------------------------------------------------------------------
def resident_cases():
    """(label, T, M, K, N): granite-moe-1b-a400m's blended expert banks
    (d 1024, d_ff_expert 512) with T = E / R_e = 4 streams per bank:
    gate/up 1024->512 and down 512->1024 at M = G * C rows per stream —
    8 in a capacity-4 decode step, 160 in a 512-token chunk, 640 in a
    2048-row prefill; jamba-v0.1-52b's blended ``w_down`` (d_ff_expert
    14336 -> d 4096, a 58.7 MB bank, K past the 4096 the first kernel held
    in shared memory) and ``w_gate`` (4096 -> 14336) with two streams of
    64 rows; and ragged shapes: K = 4100 (rows not 16-byte aligned), N =
    40 and 200 (part-filled column tiles), one stream of 5 rows and three
    of 50 (a row tile that straddles streams)."""
    return [(f"T=4 M={M} {K}->{N}", 4, M, K, N)
            for M in (8, 160, 640) for K, N in ((1024, 512), (512, 1024))] + \
        [("T=2 M=64 14336->4096 (jamba w_down)", 2, 64, 14336, 4096),
         ("T=2 M=64 4096->14336 (jamba w_gate)", 2, 64, 4096, 14336),
         ("T=1 M=5 4100->40", 1, 5, 4100, 40),
         ("T=3 M=50 4100->200", 3, 50, 4100, 200)]


RESIDENT_SPLITS = (1, 2, 4, 8)


def check_resident(torch, timer, pm, photonic):
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for label, T, M, K, N in resident_cases():
        x = torch.randn((T, M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        xq, xs = photonic.quantize_symmetric(x, 8, axis=(1, 2))
        xs = xs.reshape(T)
        wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                           dtype=torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.05 + 0.01
        got = pm.photonic_mvm_resident(xq, wq, xs, ws)
        want = pm.photonic_mvm_resident_plain(xq, wq, xs, ws)
        split = [pm.photonic_mvm(xq[t], wq, xs[t], ws) for t in range(T)]
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got - want).abs().max())
        if not (err <= MVM_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"photonic_mvm_resident {label}: rel-L2 "
                                 f"{err} > {MVM_TOL}")
        if not all(torch.equal(got[t], split[t]) for t in range(T)):
            raise AssertionError(f"photonic_mvm_resident {label}: a stream "
                                 f"differs from the split kernel's output")
        ms = timer.ms(lambda: pm.photonic_mvm_resident(xq, wq, xs, ws), 20)
        plain_ms = timer.ms(
            lambda: pm.photonic_mvm_resident_plain(xq, wq, xs, ws), 10)
        split_ms = timer.ms(lambda: [pm.photonic_mvm(xq[t], wq, xs[t], ws)
                                     for t in range(T)], 20)
        lib_ms = int_mm_ms(torch, timer, xq.reshape(T * M, K), wq, False, 20)
        # the kernel under every K split the bank allows, bit for bit the
        # plan's output: what a split costs, measured beside the plan
        by_splits = {}
        for n in RESIDENT_SPLITS:
            made = pm.resident_launch_plan(T, M, K, N, splits=n).splits
            if made in by_splits:
                continue
            alt = pm.photonic_mvm_resident(xq, wq, xs, ws, splits=n)
            if not torch.equal(alt, got):
                raise AssertionError(f"photonic_mvm_resident {label}: "
                                     f"{made} K splits change the output")
            del alt
            by_splits[made] = timer.ms(lambda: pm.photonic_mvm_resident(
                xq, wq, xs, ws, splits=n), 20)
        nbytes = T * M * K + K * N + 4 * T + 4 * N + 4 * T * M * N
        ops_n = 2.0 * T * M * K * N
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops_n / INT8_TOPS * 1e3
        row = {"case": label, "kernel": "photonic_mvm_resident",
               "regime": pm.resident_launch_plan(T, M, K, N).regime,
               "splits": pm.resident_launch_plan(T, M, K, N).splits,
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch._int_mm on the stacked (T*M, K) int8 rows "
                          "(product only; rows padded to >= 32)",
               "t_split_ms": split_ms, "streams_equal_split": True,
               "by_splits": by_splits,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops_n}
        emit(row)
        rows.append(row)
        del got, want, split, x, xq, wq
    return rows


# -------------------------------------------------------------------------
# phase 3d: the MoE path (blended experts)
# -------------------------------------------------------------------------
def moe_resident_per_pass(cfg) -> int:
    """Resident launches one forward pass makes: each non-transposed MoE
    layer runs its gate, up and down banks through ``reuse_dot`` once per
    basic expert, each transposed layer only its up bank."""
    from repro_torch.models import transformer as tfm
    nb = cfg.moe.num_basic_experts
    n = 0
    for spec in tfm.build_segments(cfg):
        shared = tfm.shareds_for(cfg)[spec.name]
        moe_layers = sum(k == "moe" for k in spec.ffn_kinds)
        for t in range(shared.reuse_times):
            banks = 1 if shared.transpose_flags[t] else 3
            n += shared.num_physical * moe_layers * banks * nb
    return n


def serve_moe(torch, gpu):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("granite-moe-1b-a400m", reuse=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_basic_experts=8))
    per_pass = moe_resident_per_pass(cfg)
    if per_pass != 480:
        raise AssertionError(f"resident launches per pass {per_pass} != 480")
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = prog.bank_stats()
    rng = np.random.default_rng(2)
    V = cfg.vocab_size

    lens = (40, 300, 512, 1300)
    requests = [(rid, rng.integers(0, V, n), 16) for rid, n in enumerate(lens)]
    prompts = rng.integers(0, V, (2, 600))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    out, gen_s = generate_captured(torch, prog, prompts, 8)
    done, launches, drain = drain_graph_vs_eager(
        torch, prog, requests, dict(capacity=4, max_len=2048,
                                    prefill_chunk=512))
    sched_s = drain["drain_graph_s"]

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    # generate: one prefill + 7 decode steps; the scheduler: monolithic
    # prefills (prompts up to the chunk width), chunks and decode steps
    passes = (8 + sum(n <= 512 for n in lens)
              + drain["drain_prefill_chunks"] + drain["drain_decode_steps"])
    if launches["photonic_mvm_resident"] != per_pass * passes:
        raise AssertionError(f"resident launches {launches} != {per_pass} x "
                             f"{passes} forward passes")
    if launches["photonic_mvm_fused"] <= 0 or launches["flash_attention"] <= 0:
        raise AssertionError(f"kernels not on the MoE path: {launches}")
    check_decode_attention_launches(cfg, launches,
                                    7 + drain["drain_decode_steps"])
    logits, _ = prog.prefill({"tokens": prompts[:1]}, 608)
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite MoE prefill logits")
    emit({"phase": "serve_moe", "gpu": gpu, "arch": cfg.name,
          "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "num_basic_experts": cfg.moe.num_basic_experts,
          "d_model": cfg.d_model, "d_ff_expert": cfg.moe.d_ff_expert,
          "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
          "build_s": build_s, "bank_int8_bytes": stats["int8_bytes"],
          "bank_fp_bytes": stats["fp_bytes"],
          "verify_banks": prog.verify_banks(),
          "generate_s": gen_s, "generate_tokens_per_s": 2 * 8 / gen_s,
          "scheduler_s": sched_s,
          "scheduler_tokens_per_s": 16 * len(lens) / sched_s,
          "scheduler_prompt_tokens": sum(lens),
          "scheduler_decode_steps": drain["drain_decode_steps"],
          "scheduler_prefill_chunks": drain["drain_prefill_chunks"],
          "forward_passes": passes, "resident_per_pass": per_pass,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "drain": drain})
    emit(profile_generate(torch, prog, prompts[:1]))
    emit(decode_step_costs(torch, prog))
    return launches, passes


def small_moe_check(torch):
    """The granite smoke model (float32, 4 experts blended from 2 basic
    ones, R=2 x T=2 with a transposed reuse) on the card against the CPU
    plain path on the same weights: the logits gap (reported; the kernels'
    exact int32 products and the plain fp32 decomposition may round an A8
    boundary differently) and the greedy tokens (required equal)."""
    from repro_torch import api
    from repro_torch.configs import smoke_variant
    from repro_torch.core.prm import ReuseConfig
    from repro_torch.models import transformer as tfm

    cfg = smoke_variant("granite-moe-1b-a400m")
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_basic_experts=2),
        reuse=ReuseConfig(num_basic=2, reuse_times=2,
                          transforms=("identity", "transpose"),
                          shuffle_groups=8))
    params = tfm.init_model(cfg, seed=4, device="cpu")
    gpu = api.Program.build(cfg, params, execution="photonic")
    cpu = api.Program.build(cfg, params, execution="photonic", device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    lg, _ = gpu.prefill({"tokens": toks}, 20)
    lc, _ = cpu.prefill({"tokens": toks}, 20)
    err = rel_l2(lg.cpu(), lc)
    same = bool((gpu.generate(toks, 8).cpu() == cpu.generate(toks, 8)).all())
    out = {"phase": "small_moe", "arch": cfg.name, "dtype": cfg.compute_dtype,
           "gpu_vs_cpu_rel_l2": err, "greedy_tokens_equal": same}
    emit(out)
    if not (err <= W8A8_BOUND and same and torch.isfinite(lg).all()):
        raise AssertionError(f"small MoE model GPU vs CPU: {out}")


# -------------------------------------------------------------------------
# phase 2, slice 4: the intra-chunk SSD
# -------------------------------------------------------------------------
def ssd_cases():
    """(label, b, nc, L, H, P, N, stride0, decay): mamba2-780m's chunks (L
    256, 48 heads of 64, d_state 128) for one prompt of up to 256 tokens,
    one of 300 or 512 (nc 2), a batch of two prompts of 768 tokens and one
    2048-token prompt, each with B/C as the serving path passes them (a
    stride-0 view over the heads: one group) and materialised; a 1x2
    rank's call in the sharded phase (4 rows of 600 tokens, 24 heads); a
    jamba-width chunk pair (128 heads of 64, d_state 16), where a tile
    sized for N 128 must still be right; and a ragged chunk whose every
    tile is partial (L 100, 6 heads, P 40, N 20), both ways.  Each at two
    decays (``ssd_inputs``): mamba2's spread, where only the diagonal and
    the adjacent key tile and the last 64 state rows carry weight, and a
    slow one, where every key tile and every state row does."""
    cases = []
    for decay in ("mamba2", "slow"):
        tail = "" if decay == "mamba2" else " slow decay"
        for b, nc in ((1, 1), (1, 2), (2, 3), (1, 8)):
            for s0 in (True, False):
                cases.append((f"b={b} nc={nc} L=256 H=48 P=64 N=128 "
                              f"{'stride-0' if s0 else 'materialised'} B/C"
                              + tail, b, nc, 256, 48, 64, 128, s0, decay))
        cases.append(("b=1 nc=2 L=256 H=128 P=64 N=16 stride-0 B/C" + tail,
                      1, 2, 256, 128, 64, 16, True, decay))
        # a 1x2 rank's heads of the sharded phase's 4 x 600 prefill
        cases.append(("b=4 nc=3 L=256 H=24 P=64 N=128 stride-0 B/C" + tail,
                      4, 3, 256, 24, 64, 128, True, decay))
        for s0 in (True, False):
            cases.append((f"b=1 nc=1 L=100 H=6 P=40 N=20 "
                          f"{'stride-0' if s0 else 'materialised'} B/C"
                          + tail, 1, 1, 100, 6, 40, 20, s0, decay))
    return cases


def ssd_inputs(torch, gen, b, nc, H, N, stride0, decay, L=256, P=64,
               device="cuda"):
    """dt-folded x, dA = dt * A and B/C shared by every head (stride 0) or
    materialised; dt = softplus(N(0, 1)).  ``decay`` "mamba2": A =
    -linspace(1, 16, H), the model's init, so |cumsum| reaches thousands in
    a chunk and exp(cs_i - cs_j) is below e^-50 two key tiles back;
    "slow": A = -linspace(1e-3, 4e-3, H), |dA| ~ 1e-2 per step or less, so
    every key tile of a query row and every row of the state weighs in."""
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, L, H), generator=gen, device=device))
    lo, hi = (1.0, 16.0) if decay == "mamba2" else (1e-3, 4e-3)
    A = -torch.linspace(lo, hi, H, device=device)
    x = (torch.randn((b, nc, L, H, P), generator=gen, device=device)
         * dt[..., None])
    dA = (dt * A).permute(0, 1, 3, 2)
    Bg = torch.randn((b, nc, L, 1, N), generator=gen, device=device)
    Cg = torch.randn((b, nc, L, 1, N), generator=gen, device=device)
    Bh, Ch = Bg.expand(b, nc, L, H, N), Cg.expand(b, nc, L, H, N)
    if not stride0:
        Bh, Ch = Bh.contiguous(), Ch.contiguous()
    return x, dA, Bh, Ch


def ssd_ops(b, nc, L, H, P, N, stride0):
    """Multiply-adds x 2 of a call: the causal triangle's scores C B^T
    (the upper triangle is zero by definition), once per group (a stride-0
    B/C is one group; materialised, one per head), its product with x and
    the states, per head."""
    pairs = L * (L + 1) // 2
    groups = 1 if stride0 else H
    return 2.0 * b * nc * (pairs * N * groups
                           + H * (pairs * P + L * N * P))


def ssd_bound(b, nc, L, H, P, N, stride0):
    """(bound ms, bound_by, bytes, flops, fp32 bound ms): each input read
    once (a stride-0 B/C is one head's data), y and the states written
    once; the operations of ``ssd_ops`` at the 3xTF32 rate (a third of
    TF32's 495 TFLOP/s, the kernel's arithmetic).  The bound of the first
    CUDA-core kernel beside it: every head's scores, at the CUDA cores'
    67 TFLOP/s fp32."""
    flops = ssd_ops(b, nc, L, H, P, N, stride0)
    bc = 2 * b * nc * L * N * (1 if stride0 else H)
    nbytes = 4 * (2 * b * nc * L * H * P + b * nc * H * L + bc
                  + b * nc * H * N * P)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / TF32X3_FLOPS * 1e3
    pairs = L * (L + 1) // 2
    fp32_ops = 2.0 * b * nc * H * (pairs * (N + P) + L * N * P)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops,
            max(t_bytes, fp32_ops / FP32_FLOPS * 1e3))


def ssd_sass_tf32(ssd):
    """TF32 wgmma instructions in the built SSD library's SASS
    (``cuobjdump -sass``, beside nvcc; raises without it)."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise FileNotFoundError(f"no cuobjdump beside nvcc: {tool}")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("ssd_chunk"))],
                          capture_output=True, text=True, check=True).stdout
    return sum("GMMA" in line and "TF32" in line
               for line in sass.splitlines())


def check_ssd_rank_heads(torch, ssd):
    """A 1x2 rank's ``ssd_chunk`` call on its 24 of mamba2's 48 heads (4
    rows of 600 tokens: b=4, nc=3), as ``models/ssm.ssd_chunked`` passes
    it (x and dA contiguous over the rank's heads, B/C a stride-0 view of
    the one group), bit-equal to those heads of the 48-head call at both
    decays: the kernel's result does not depend on the heads beside a
    head, so the rank's piece of ``h`` is the unsharded one's."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, nc, H, tp = 4, 3, 48, 2
    rows = []
    for decay in ("mamba2", "slow"):
        x, dA, Bh, Ch = ssd_inputs(torch, gen, b, nc, H, 128, True, decay)
        y, st = ssd.ssd_chunk(x, dA, Bh, Ch)
        n = H // tp
        for i in range(tp):
            hs = slice(i * n, (i + 1) * n)
            yi, sti = ssd.ssd_chunk(x[:, :, :, hs].contiguous(),
                                    dA[:, :, hs].contiguous(),
                                    Bh[:, :, :, hs], Ch[:, :, :, hs])
            plan = ssd.ssd_launch_plan(b, nc, 256, n, 64, 128, True)
            same = bool(torch.equal(yi, y[:, :, :, hs])
                        and torch.equal(sti, st[:, :, hs]))
            rows.append({"decay": decay, "heads": [hs.start, hs.stop],
                         "bit_equal": same,
                         "heads_per_block": plan.heads_per_block,
                         "blocks": plan.blocks})
    emit({"phase": "ssd_rank_heads", "cases": rows})
    if not all(r["bit_equal"] for r in rows):
        raise AssertionError(f"ssd_chunk on a rank's heads differs from "
                             f"those heads of the whole call: {rows}")


SSD_GRAD_TOL = 1e-4          # each gradient through the Function vs
                             # autograd through the plain version


def ssd_grad_cases():
    """(label, b, nc, H, decay): mamba2's serving call (one 2048-token
    prompt: b=1, nc=8, all 48 heads) and a 1x2 rank's (b=4, nc=3, its 24
    heads), L=256, P=64, N=128, stride-0 B/C, at both decays of
    ``ssd_inputs``."""
    return [(f"b={b} nc={nc} L=256 H={H} P=64 N=128 stride-0 B/C"
             + ("" if decay == "mamba2" else " slow decay"), b, nc, H, decay)
            for decay in ("mamba2", "slow")
            for b, nc, H in ((1, 8, 48), (4, 3, 24))]


def check_ssd_grad(torch, timer, ssd):
    """``ssd_chunk``'s gradient on the card: the ``autograd.Function``
    (the kernel forward, the explicit float32 VJP backward) against
    autograd through ``ssd_chunk_plain`` on the same CUDA inputs and a
    seeded upstream gradient, dx, ddA, dB and dC (B and C the group's,
    summed over the stride-0 head view) each within ``SSD_GRAD_TOL``
    rel-L2.  Times: the kernel forward, the backward alone
    (``ssd_chunk_vjp`` on the saved inputs) and the plain forward plus
    its autograd backward."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, b, nc, H, decay in ssd_grad_cases():
        x, dA, Bh, Ch = ssd_inputs(torch, gen, b, nc, H, 128, True, decay)
        Bg = Bh[:, :, :, :1].detach().clone().requires_grad_(True)
        Cg = Ch[:, :, :, :1].detach().clone().requires_grad_(True)
        x = x.detach().requires_grad_(True)
        dA = dA.detach().requires_grad_(True)
        gy = torch.randn((b, nc, 256, H, 64), generator=gen, device="cuda")
        gst = torch.randn((b, nc, H, 128, 64), generator=gen, device="cuda")

        def grads(fn):
            y, st = fn(x, dA, Bg.expand(b, nc, 256, H, 128),
                       Cg.expand(b, nc, 256, H, 128))
            return torch.autograd.grad((y, st), (x, dA, Bg, Cg), (gy, gst))

        before = ssd.launches
        got = grads(ssd.ssd_chunk)
        launched = ssd.launches - before
        want = grads(ssd.ssd_chunk_plain)
        torch.cuda.synchronize()
        errs = {k: rel_l2(g, w) for k, g, w in zip(("dx", "ddA", "dB", "dC"),
                                                   got, want)}
        saved = (x.detach(), dA.detach(), Bh, Ch)
        row = {"case": label, "kernel": "ssd_chunk backward",
               "decay": decay, "rel_l2": max(errs.values()),
               "rel_l2_each": errs, "forward_launches": launched,
               "max_abs_err": max(float((g - w).abs().max())
                                  for g, w in zip(got, want)),
               "forward_ms": timer.ms(lambda: ssd.ssd_chunk(*saved), 10),
               "backward_ms": timer.ms(lambda: ssd.ssd_chunk_vjp(
                   *saved, gy, gst), 10),
               "plain_forward_backward_ms": timer.ms(
                   lambda: grads(ssd.ssd_chunk_plain), 3)}
        emit(row)
        rows.append(row)
        if not (row["rel_l2"] <= SSD_GRAD_TOL and launched == 1
                and all(bool(torch.isfinite(g).all()) for g in got)):
            raise AssertionError(f"ssd_chunk gradient {label}: {row}")
        del x, dA, Bh, Ch, Bg, Cg, got, want, saved
    return rows


def check_ssd(torch, timer, ssd):
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for label, b, nc, L, H, P, N, s0, decay in ssd_cases():
        args = ssd_inputs(torch, gen, b, nc, H, N, s0, decay, L=L, P=P)
        y, st = ssd.ssd_chunk(*args)
        want_y, want_st = ssd.ssd_chunk_plain(*args)
        x, dA, Bh, Ch = args
        y2, st2 = ssd.ssd_chunk(x, dA, Bh.contiguous(), Ch.contiguous())
        # groups of 3 heads (partial at H=128), which no plan picks
        y3, st3 = ssd._launch(*args, b, nc, L, H, P, N,
                              ssd._plan(b, nc, L, H, P, N, s0, 3, 3))
        torch.cuda.synchronize()
        err_y, err_st = rel_l2(y, want_y), rel_l2(st, want_st)
        err = max(err_y, err_st)
        max_abs = max(float((y - want_y).abs().max()),
                      float((st - want_st).abs().max()))
        if not (err <= SSD_F32_TOL and torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_chunk {label}: rel-L2 y {err_y}, "
                                 f"states {err_st} > {SSD_F32_TOL}")
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"ssd_chunk {label}: stride-0 and "
                                 f"materialised B/C differ")
        if not (torch.equal(y, y3) and torch.equal(st, st3)):
            raise AssertionError(f"ssd_chunk {label}: groups of 3 heads "
                                 f"change the result")
        ms = timer.ms(lambda: ssd.ssd_chunk(*args), 20)
        plain_ms = timer.ms(lambda: ssd.ssd_chunk_plain(*args), 5)
        bound, by, nbytes, flops, bound_fp32 = ssd_bound(b, nc, L, H, P, N,
                                                         s0)
        plan = ssd.ssd_launch_plan(b, nc, L, H, P, N, s0)
        row = {"case": label, "kernel": "ssd_chunk", "decay": decay,
               "rel_l2": err, "rel_l2_y": err_y, "rel_l2_states": err_st,
               "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None,
               "library": "none: no single PyTorch call computes it (the "
                          "plain version is the einsum/bmm chain)",
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "ops": flops, "bound_fp32_ms": bound_fp32,
               "heads_per_block": plan.heads_per_block,
               "state_heads_per_block": plan.state_heads_per_block,
               "blocks": plan.blocks, "stride0_equals_materialised": True,
               "any_grouping_equal": True}
        emit(row)
        rows.append(row)
        del args, y, st, want_y, want_st, y2, st2, y3, st3
    check_ssd_rank_heads(torch, ssd)
    for g in check_ssd_grad(torch, timer, ssd):
        for r in rows:
            if r["case"] == g["case"]:
                r["backward_ms"] = g["backward_ms"]
    hgmma = ssd_sass_tf32(ssd)
    emit({"phase": "ssd_sass", "tf32_wgmma_instructions": hgmma})
    if not hgmma:
        raise AssertionError("no TF32 wgmma in the SSD library's SASS")
    return rows


# -------------------------------------------------------------------------
# phase 2, slice 18: decode attention
# -------------------------------------------------------------------------
DECODE_ATTN_TOL = 2.0 ** -8      # bf16: the probabilities round to bf16 at
                                 # another point than the plain version's
DECODE_ATTN_F32_TOL = 1e-5       # float32: summation order only
DECODE_ATTN_POS = (40, 300, 1300, 2047)   # per-slot positions of the B=4
                                          # serving calls


def decode_attention_cases():
    """(label, B, L, H, KV, hd, dtype): the decode attention of the serving
    paths at the scheduler's capacity (4 slots, a 2048-position cache,
    positions ``DECODE_ATTN_POS``): minitron-4b (24 heads over 8 KV heads,
    hd 128), llama-3.2-vision-11b's self-attention (32 over 8), whisper-
    medium's decoder (16 over 16, hd 64) and granite-moe-1b-a400m (16 over
    8, hd 64), in bf16; minitron's shape in float32."""
    return [("minitron-4b B=4 L=2048 H=24 KV=8 hd=128", 4, 2048, 24, 8, 128,
             "bfloat16"),
            ("vlm self B=4 L=2048 H=32 KV=8 hd=128", 4, 2048, 32, 8, 128,
             "bfloat16"),
            ("whisper decoder B=4 L=2048 H=16 KV=16 hd=64", 4, 2048, 16, 16,
             64, "bfloat16"),
            ("granite B=4 L=2048 H=16 KV=8 hd=64", 4, 2048, 16, 8, 64,
             "bfloat16"),
            ("minitron-4b float32 B=4 L=2048 H=24 KV=8 hd=128", 4, 2048, 24,
             8, 128, "float32")]


def decode_attention_inputs(torch, gen, B, L, H, KV, hd, dt):
    """Seeded q, cache K / V, the new token's K / V and per-slot positions
    on the card."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    pos = torch.tensor(DECODE_ATTN_POS[:B], dtype=torch.long, device="cuda")
    return r(B, 1, H, hd), r(B, L, KV, hd), r(B, L, KV, hd), \
        r(B, 1, KV, hd), r(B, 1, KV, hd), pos


def check_decode_attention(torch, timer, da):
    """Each case against the plain version (rel-L2 <= 2**-8 in bf16, 1e-5
    in float32); batch invariance (each row of the B=4 call bit-equal to
    the row called alone and within B=2); head invariance (KV heads
    [j KV/tp, (j+1) KV/tp) with their query heads, called alone, bit-equal
    to those heads of the whole call, tp 2 and 4); the partial form over 2
    and 4 position pieces, joined (``join_partials``), at the float gates
    against the plain version; median time, the plain version's, SDPA's
    (``enable_gqa``, a bool mask over the L + 1 keys: the cache rows seen
    and the new token), the bound of the bytes and operations this call's
    positions need and the share of it the kernel reaches (bound / ms)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = []
    for label, B, L, H, KV, hd, dtype in decode_attention_cases():
        dt = getattr(torch, dtype)
        tol = DECODE_ATTN_TOL if dt == torch.bfloat16 else DECODE_ATTN_F32_TOL
        q, ck, cv, kn, vn, pos = decode_attention_inputs(torch, gen, B, L, H,
                                                         KV, hd, dt)
        args = (q, ck, cv, kn, vn, pos)
        want = da.decode_attention_plain(*args)
        got = da.decode_attention(*args)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"decode_attention {label}: rel-L2 {err} "
                                 f"> {tol}")
        # batch invariance: a row alone, and beside one other row
        G = H // KV
        batch_ok = all(
            torch.equal(da.decode_attention(*(t[i:i + 1] for t in args)),
                        got[i:i + 1]) for i in range(B))
        batch_ok &= all(
            torch.equal(da.decode_attention(*(t[[i, (i + 1) % B]]
                                              for t in args)),
                        got[[i, (i + 1) % B]]) for i in range(B))
        heads_ok = {}
        for tp in (2, 4):
            kv_n = KV // tp
            same = True
            for j in range(tp):
                ks, qs_ = slice(j * kv_n, (j + 1) * kv_n), \
                    slice(j * kv_n * G, (j + 1) * kv_n * G)
                part = da.decode_attention(
                    q[:, :, qs_].contiguous(), ck[:, :, ks].contiguous(),
                    cv[:, :, ks].contiguous(), kn[:, :, ks].contiguous(),
                    vn[:, :, ks].contiguous(), pos)
                same &= torch.equal(
                    part, got[..., qs_.start * hd:qs_.stop * hd])
            heads_ok[tp] = bool(same)
        pieces = {}
        for n in (2, 4):
            w = L // n
            parts = [da.decode_attention_partial(
                q, ck[:, j * w:(j + 1) * w], cv[:, j * w:(j + 1) * w], kn,
                vn, pos, offset=j * w, with_new=j == 0) for j in range(n)]
            pieces[n] = rel_l2(da.join_partials(parts, dt), want)
        if not (batch_ok and all(heads_ok.values())
                and max(pieces.values()) <= tol):
            raise AssertionError(f"decode_attention {label}: batch "
                                 f"invariant {batch_ok}, head invariant "
                                 f"{heads_ok}, pieces rel-L2 {pieces} "
                                 f"(gate {tol})")
        ms = timer.ms(lambda: da.decode_attention(*args), 20)
        plain_ms = timer.ms(lambda: da.decode_attention_plain(*args), 5)
        # SDPA on the same keys: the cache and the new token, (B, KV, L+1,
        # hd), the rows past each slot's position masked
        k4 = torch.cat([ck, kn], dim=1).transpose(1, 2).contiguous()
        v4 = torch.cat([cv, vn], dim=1).transpose(1, 2).contiguous()
        q4 = q.transpose(1, 2).contiguous()
        j = torch.arange(L + 1, device="cuda")
        mask = ((j[None, :] < pos[:, None]) | (j[None, :] == L))[:, None,
                                                                 None, :]
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True), 20)
        seen = da.seen_rows(pos.cpu(), B, L)
        ops, nbytes = da.work(B, H, KV, hd, seen, q.element_size())
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        row = {"case": label, "kernel": "decode_attention", "dtype": dtype,
               "positions": list(DECODE_ATTN_POS[:B]),
               "rel_l2": err, "max_abs_err": max_abs,
               "batch_invariant": batch_ok,
               "head_invariant": {str(k): v for k, v in heads_ok.items()},
               "pieces_rel_l2": {str(k): v for k, v in pieces.items()},
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "library_backend": sdpa_backend(torch, q4, k4, v4, mask),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_share": max(t_bytes, t_ops) / ms,
               "bytes": nbytes, "ops": ops,
               "bytes_whole_cache": 2 * ck.numel() * ck.element_size()}
        emit(row)
        rows.append(row)
    return rows


# -------------------------------------------------------------------------
# phase 3f: the SSM path
# -------------------------------------------------------------------------
def serve_ssm(torch, pm, gpu):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("mamba2-780m", reuse=True)
    layers = cfg.num_layers                 # logical SSM layers per pass
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = prog.bank_stats()
    rng = np.random.default_rng(5)
    V = cfg.vocab_size
    prompts = rng.integers(0, V, (2, 600))
    lens = (40, 300, 512, 1300, 1900)
    requests = [(rid, rng.integers(0, V, n), 16) for rid, n in enumerate(lens)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    out, gen_s = generate_captured(torch, prog, prompts, 16)
    done, launches, drain = drain_graph_vs_eager(
        torch, prog, requests, dict(capacity=4, max_len=2048,
                                    prefill_chunk=512))
    sched_s = drain["drain_graph_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    got = sorted((c.rid, len(c.tokens), c.finish_reason, c.padded_to)
                 for c in done)
    want = [(rid, n + 16, "length", n) for rid, n in enumerate(lens)]
    if got != want or drain["drain_prefill_chunks"] != 0:
        raise AssertionError(f"completions {got} != {want} (exact-length, "
                             f"unchunked; {drain['drain_prefill_chunks']} "
                             f"chunks)")
    prefills = 1 + len(lens)
    decodes = 15 + drain["drain_decode_steps"]
    if launches["ssd_chunk"] != layers * prefills:
        raise AssertionError(f"ssd_chunk launches {launches['ssd_chunk']} "
                             f"!= {layers} x {prefills} prefill passes")
    # outside the counted window: fused launches of one prefill pass and of
    # one decode step, and the logits of one prefill
    reset_counts()
    logits, caches = prog.prefill({"tokens": prompts[:1]}, 616)
    per_prefill = pm.launches
    reset_counts()
    prog.decode(out[:1, 600:601], caches, 600)
    per_decode = pm.launches
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite SSM prefill logits")
    if launches["photonic_mvm_fused"] != (per_prefill * prefills
                                          + per_decode * decodes):
        raise AssertionError(f"fused launches {launches} != {per_prefill} x "
                             f"{prefills} + {per_decode} x {decodes}")
    for name in ("photonic_mvm", "photonic_mvm_t", "photonic_mvm_resident",
                 "blend_shuffle", "flash_attention", "decode_attention"):
        if launches[name] != 0:
            raise AssertionError(f"{name} ran on the SSM path: {launches}")
    emit({"phase": "serve_ssm", "gpu": gpu, "arch": cfg.name,
          "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
          "transforms": list(cfg.reuse.transforms), "d_model": cfg.d_model,
          "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk,
          "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
          "build_s": build_s, "bank_int8_bytes": stats["int8_bytes"],
          "bank_fp_bytes": stats["fp_bytes"],
          "verify_banks": prog.verify_banks(),
          "generate_s": gen_s, "generate_tokens_per_s": 2 * 16 / gen_s,
          "scheduler_s": sched_s,
          "scheduler_tokens_per_s": 16 * len(lens) / sched_s,
          "scheduler_prompt_tokens": sum(lens),
          "scheduler_decode_steps": drain["drain_decode_steps"],
          "scheduler_prefill_chunks": drain["drain_prefill_chunks"],
          "prefill_passes": prefills, "decode_steps": decodes,
          "fused_per_prefill": per_prefill, "fused_per_decode": per_decode,
          "peak_mem_gb": peak_gb, "launches": launches, "drain": drain})
    emit(profile_generate(torch, prog, prompts[:1]))
    emit(decode_step_costs(torch, prog))
    return launches, {"prefill_passes": prefills,
                      "fused_per_prefill": per_prefill,
                      "fused_per_decode": per_decode}


def small_ssm_checks(torch):
    """The mamba2 smoke model on an R&B stack (2 x 2, identity then
    shuffle) and the jamba smoke model, float32, photonic: the kernels on
    the card against the CPU plain path on the same weights, logits within
    the W8A8 bound and the same greedy tokens."""
    from repro_torch import api
    from repro_torch.configs import smoke_variant
    from repro_torch.configs.archs import rb
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as tfm

    out = {"phase": "small_ssm"}
    for name in ("mamba2-780m", "jamba-v0.1-52b"):
        cfg = smoke_variant(name)
        if name == "mamba2-780m":
            cfg = rb(cfg, 2, 2)
        params = tfm.init_model(cfg, seed=5, device="cpu")
        gpu = api.Program.build(cfg, params, execution="photonic")
        cpu = api.Program.build(cfg, params, execution="photonic",
                                device="cpu")
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
        before = ssd.launches
        lg, _ = gpu.prefill({"tokens": toks}, 20)
        lc, _ = cpu.prefill({"tokens": toks}, 20)
        err = rel_l2(lg.cpu(), lc)
        same = bool((gpu.generate(toks, 8).cpu()
                     == cpu.generate(toks, 8)).all())
        out[name] = {"dtype": cfg.compute_dtype, "gpu_vs_cpu_rel_l2": err,
                     "greedy_tokens_equal": same,
                     "ssd_launches": ssd.launches - before}
        if not (err <= W8A8_BOUND and same and torch.isfinite(lg).all()
                and ssd.launches > before):
            raise AssertionError(f"small SSM model {name} GPU vs CPU: {out}")
    out["train"] = small_ssm_train_steps(torch)
    emit(out)


SSM_TRAIN_LOSS_TOL = 1e-4   # card vs CPU train step: the loss, relative,
SSM_TRAIN_GRAD_TOL = 1e-3   # and each gradient leaf, rel-L2: a decade over
                            # the kernel's forward gate (1e-4, 3xTF32)
SSM_BF16_SPREADS = 1.0      # the bf16 step's SSM leaves, card vs CPU, within
                            # this many times the CPU bf16 step's own
                            # distance from float32 (on the CPU the port's
                            # bf16 step lies within 0.38 of that spread of
                            # the reference's run op by op:
                            # tests/test_torch_train_ssm.py)


def small_ssm_train_steps(torch):
    """One train step (``trainer.loss_and_grads``, remat) of the mamba2
    and jamba smoke R&B models (2 x 2, float32) on the card against the
    same step on the CPU, same weights and tokens: the loss within
    ``SSM_TRAIN_LOSS_TOL`` and every gradient leaf within
    ``SSM_TRAIN_GRAD_TOL``.  The card's SSM layers run ``ssd_chunk``'s
    kernel forward (counted) and its explicit backward; a leaf that
    carried only the inter-chunk and D terms would miss by far.  Then the
    same step in bf16, the models' stated precision, on both: each SSM
    leaf's (``SSM_PIECE_LEAVES``) card gradient within ``SSM_BF16_SPREADS``
    times the CPU bf16 step's own distance from the float32 one."""
    from repro_torch.configs import smoke_variant
    from repro_torch.configs.archs import rb
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    from repro_torch.train import trainer

    def rels(g, c):
        return {k: float(np.linalg.norm(g[k] - c[k])
                         / (np.linalg.norm(c[k]) + 1e-30)) for k in g}

    out = {}
    for name in ("mamba2-780m", "jamba-v0.1-52b"):
        cfg = rb(smoke_variant(name), 2, 2)
        params = tfm.init_model(cfg, seed=5, device="cpu")
        toks = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (4, 32))).long()
        before = ssd.launches
        gpu = trainer.loss_and_grads(
            adamw.tree_map(lambda t: t.cuda(), params), cfg,
            {"tokens": toks.cuda()})
        torch.cuda.synchronize()
        launched = ssd.launches - before
        cpu = trainer.loss_and_grads(params, cfg, {"tokens": toks})
        g, c = checkpoint._flatten(gpu[3]), checkpoint._flatten(cpu[3])
        errs = rels(g, c)
        worst = max(errs, key=errs.get)
        r = {"dtype": cfg.compute_dtype, "loss_gpu": float(gpu[0]),
             "loss_cpu": float(cpu[0]),
             "loss_rel": abs(float(gpu[0]) - float(cpu[0]))
             / abs(float(cpu[0])),
             "worst_leaf": worst, "worst_rel_l2": errs[worst],
             "worst_ssm_leaf_rel_l2": max(
                 v for k, v in errs.items() if k.rsplit("/", 1)[1]
                 in SSM_PIECE_LEAVES),
             "ssd_launches": launched}
        # bf16
        cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
        g16 = checkpoint._flatten(trainer.loss_and_grads(
            adamw.tree_map(lambda t: t.cuda(), params), cfg16,
            {"tokens": toks.cuda()})[3])
        c16 = checkpoint._flatten(trainer.loss_and_grads(
            params, cfg16, {"tokens": toks})[3])
        ssm = [k for k in c if k.rsplit("/", 1)[1] in SSM_PIECE_LEAVES]
        spread = rels({k: c16[k] for k in ssm}, c)
        card16 = rels({k: g16[k] for k in ssm}, c16)
        ratio = {k: card16[k] / spread[k] for k in ssm}
        top = max(ratio, key=ratio.get)
        r["bf16"] = {"cpu_vs_float32_ssm_rel_l2": [min(spread.values()),
                                                   max(spread.values())],
                     "card_vs_cpu_ssm_rel_l2": [min(card16.values()),
                                                max(card16.values())],
                     "worst_leaf": top, "worst_ratio": ratio[top]}
        out[name] = r
        if not (r["loss_rel"] <= SSM_TRAIN_LOSS_TOL
                and r["worst_rel_l2"] <= SSM_TRAIN_GRAD_TOL and launched > 0
                and np.isfinite(r["loss_gpu"])
                and ratio[top] <= SSM_BF16_SPREADS):
            raise AssertionError(f"small SSM train step {name}: {r}")
    return out


# -------------------------------------------------------------------------
# phase 3j: the MLA path
# -------------------------------------------------------------------------
MLA_TAUGHT_TOL = 1e-2       # small bf16 MLA card logits vs the CPU program
                            # with the kernels' arithmetic and bf16 P, taught
                            # by the card's MVM inputs
MLA_INPUT_TOL = 2.0 ** -8   # its MVM inputs vs the card's (bf16 noise)
MLA_MODEL_TOL = 0.07        # untaught, reported: the gap A8 flips of bf16
                            # noise carry to (PERF.md §6)
MLA_RB = (4, 2)             # serve_mla's cut in depth: the dense ``pre``
                            # layer and 4 x 2 R&B groups (the published
                            # plan is 13 x 2; the script's 1200 s limit)
MLA_FUSED_PER_PASS = (1591, 1600)   # that model: decode, prefill pass or
                                    # chunk


def mla_config():
    """deepseek-v2-lite-16b at its published width, cut in depth to the
    dense ``pre`` layer and ``MLA_RB`` R&B groups x reuses."""
    from repro_torch.configs import get_arch, rb
    g, t = MLA_RB
    base = get_arch("deepseek-v2-lite-16b")
    return rb(dataclasses.replace(base, num_layers=1 + g * t), g, t)


def fused_per_pass(cfg, prefill: bool) -> int:
    """Fused-MVM launches one forward pass of a model without blended
    experts or SSM layers makes, from its config.  Per logical layer:
    self-attention's ``wq``, ``wk``, ``wv`` and ``wo`` (GQA), or MLA's
    ``wq``, ``w_dkv`` and ``wo`` plus, in a prefill pass or chunk, the
    per-call quantized ``w_ukv`` up-projection (the absorbed decode folds
    ``w_ukv`` into torch einsums); cross-attention's ``wq`` and ``wo`` plus,
    in a prefill pass, the memory's ``wk`` and ``wv`` (whisper's decoder
    layer has both attentions); three per SwiGLU FFN, two per gelu FFN,
    per MoE FFN three per routed expert (gate, up and down; no blended
    banks) and three for the shared experts.  Then one for the lm head,
    and in a prefill pass one for the vlm's ``vision_proj`` or whisper's
    ``audio_proj`` and the encoder's layers (whisper)."""
    from repro_torch.models import transformer as tfm
    if cfg.moe and cfg.moe.num_basic_experts:
        raise ValueError("counts stacks without blended experts")
    self_attn = (4 if prefill else 3) if cfg.mla else 4
    cross = 4 if prefill else 2
    per_mixer = {"attn": self_attn, "cross_attn": cross,
                 "attn_cross": self_attn + cross}
    per_ffn = {"dense": 3 if cfg.mlp_act == "swiglu" else 2, "none": 0}
    per_ffn["dense_first"] = per_ffn["dense"]
    if cfg.moe:
        per_ffn["moe"] = 3 * cfg.moe.num_experts + 3 * bool(
            cfg.moe.num_shared)
    n = 1 + (prefill and cfg.family in ("vlm", "audio"))
    for spec in tfm.build_segments(cfg):
        if spec.stream == "encoder" and not prefill:
            continue
        shared = tfm.shareds_for(cfg)[spec.name]
        groups = shared.num_physical * shared.reuse_times
        for mixer, ffn in zip(spec.mixer_kinds, spec.ffn_kinds):
            if mixer not in per_mixer:
                raise ValueError(f"mixer {mixer!r}")
            n += groups * (per_mixer[mixer] + per_ffn[ffn])
    return n


def flash_per_prefill(cfg, rows: int, min_seq: int = 512) -> tuple:
    """(flash launches, the causal ones among them) of one prefill pass of
    ``rows`` query rows of a model whose mixers are attention: every
    decoder self-attention (causal) and cross-attention (not causal) once
    the pass has ``min_seq`` rows or more (``Backend.flash_min_seq``), and
    whisper's encoder layers (not causal, over its frames) whatever the
    prompt's length."""
    from repro_torch.models import transformer as tfm
    causal = other = 0
    for spec in tfm.build_segments(cfg):
        shared = tfm.shareds_for(cfg)[spec.name]
        groups = shared.num_physical * shared.reuse_times
        for mixer in spec.mixer_kinds:
            if spec.stream == "encoder":
                other += groups * (cfg.audio.num_frames >= min_seq)
            elif rows >= min_seq:
                causal += groups * (mixer in ("attn", "attn_cross"))
                other += groups * (mixer in ("cross_attn", "attn_cross"))
    return causal + other, causal


def serve_mla(torch, gpu):
    """deepseek-v2-lite-16b R&B (64 routed experts top-6, 2 shared, one
    dense ``pre`` layer, MLA with kv_lora 512) at full width, cut in depth
    to ``MLA_RB`` (4 x 2, ``mla_config``), photonic, bf16, seeded random
    weights: ``Program.generate`` and a ``ContinuousScheduler`` with
    chunked prefill (its decode graph against an eager cell).  Fused-MVM
    launches are held to the config's count per pass, flash to one launch
    per layer of every pass of 512 rows or more, all on the tensor-core
    variant."""
    from repro_torch import api
    from repro_torch.models import transformer as tfm

    cfg = mla_config()
    per_decode = fused_per_pass(cfg, prefill=False)
    per_prefill = fused_per_pass(cfg, prefill=True)
    if (per_decode, per_prefill) != MLA_FUSED_PER_PASS:
        raise AssertionError(f"fused launches per pass {per_decode} / "
                             f"{per_prefill} != {MLA_FUSED_PER_PASS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = prog.bank_stats()
    rng = np.random.default_rng(7)
    V = cfg.vocab_size
    lens = (40, 300, 512, 1300)
    requests = [(rid, rng.integers(0, V, n), 16) for rid, n in enumerate(lens)]
    prompts = rng.integers(0, V, (2, 600))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    out, gen_s = generate_captured(torch, prog, prompts, 8)
    done, launches, drain = drain_graph_vs_eager(
        torch, prog, requests, dict(capacity=4, max_len=2048,
                                    prefill_chunk=512))
    sched_s = drain["drain_graph_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    # generate: one prefill + 7 decode steps; the scheduler: monolithic
    # prefills (prompts up to the chunk width), chunks and decode steps
    prefills = 1 + sum(n <= 512 for n in lens) + drain["drain_prefill_chunks"]
    decodes = 7 + drain["drain_decode_steps"]
    fused = per_prefill * prefills + per_decode * decodes
    if launches["photonic_mvm_fused"] != fused:
        raise AssertionError(f"fused launches {launches} != {per_prefill} x "
                             f"{prefills} + {per_decode} x {decodes}")
    # flash: every pass of 512 rows or more (the 600-token generate, the
    # 512-token prompt, each 512-wide chunk), once per logical layer
    # (monolithic prompts prefill in buckets of 16 rows: 48, 304, 512)
    flash_passes = 1 + sum(n == 512 for n in lens) + drain[
        "drain_prefill_chunks"]
    if not (launches["flash_attention"] == cfg.num_layers * flash_passes
            and launches["flash_attention_mma"]
            == launches["flash_attention"]):
        raise AssertionError(f"flash launches {launches} != {cfg.num_layers}"
                             f" x {flash_passes}, all tensor-core")
    for name in ("photonic_mvm", "photonic_mvm_t", "photonic_mvm_resident",
                 "blend_shuffle", "ssd_chunk", "decode_attention"):
        if launches[name] != 0:
            raise AssertionError(f"{name} ran on the MLA path: {launches}")
    logits, _ = prog.prefill({"tokens": prompts[:1]}, 608)
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite MLA prefill logits")
    m = cfg.mla
    emit({"phase": "serve_mla", "gpu": gpu, "arch": cfg.name,
          "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
          "params": n_params, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_lora_rank": m.kv_lora_rank,
          "qk_head_dim": m.qk_nope_dim + m.qk_rope_dim,
          "v_head_dim": m.v_head_dim, "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.top_k, "num_shared": cfg.moe.num_shared,
          "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
          "build_s": build_s, "build_peak_mem_gb": build_peak_gb,
          "bank_int8_bytes": stats["int8_bytes"],
          "bank_fp_bytes": stats["fp_bytes"],
          "verify_banks": prog.verify_banks(),
          "generate_s": gen_s, "generate_tokens_per_s": 2 * 8 / gen_s,
          "scheduler_s": sched_s,
          "scheduler_tokens_per_s": 16 * len(lens) / sched_s,
          "scheduler_prompt_tokens": sum(lens),
          "scheduler_decode_steps": drain["drain_decode_steps"],
          "scheduler_prefill_chunks": drain["drain_prefill_chunks"],
          "prefill_passes": prefills, "decode_steps": decodes,
          "fused_per_prefill": per_prefill, "fused_per_decode": per_decode,
          "flash_passes": flash_passes, "peak_mem_gb": peak_gb,
          "launches": launches, "drain": drain})
    emit(profile_generate(torch, prog, prompts[:1]))
    emit(decode_step_costs(torch, prog))
    return launches


def small_mla_model(seed: int):
    """``small_mla_check``'s bf16 MLA model: (config, CPU params, a
    (2, 96) token batch), all from ``seed``."""
    from repro_torch.configs.base import MLAConfig, ModelConfig
    from repro_torch.models import transformer as tfm
    cfg = ModelConfig(name="small-mla", family="dense", num_layers=2,
                      d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
                      vocab_size=97, head_dim=48,
                      mla=MLAConfig(kv_lora_rank=64, qk_nope_dim=32,
                                    qk_rope_dim=16, v_head_dim=32),
                      compute_dtype="bfloat16")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 96))
    return cfg, tfm.init_model(cfg, seed=seed, device="cpu"), toks


def per_layer_flips(cfg, per_call) -> list:
    """A taught prefill's A8 flips per layer: its MVM calls in order are
    ``cfg.num_layers`` equal runs of a layer's calls, then the lm head
    (the last entry)."""
    layers, rest = divmod(len(per_call) - 1, cfg.num_layers)
    if rest:
        raise AssertionError(f"{len(per_call)} MVM calls do not split into "
                             f"{cfg.num_layers} layers and the lm head")
    return [sum(per_call[i * layers:(i + 1) * layers])
            for i in range(cfg.num_layers)] + [per_call[-1]]


def small_mla_check(torch):
    """A small bf16 MLA model (d 256, 4 heads, kv_lora 64, nope 32, rope
    16, v 32: flash at hd 48 / hd_v 32 on the tensor cores from 64 rows):
    its card prefill logits, with the input of each MVM call recorded
    (``recording_backend``), against the CPU program with the MVM kernels'
    integer arithmetic and the tensor-core flash's bf16 P
    (``exact_backend(mma_flash=True)``) taught by those inputs, within
    ``MLA_TAUGHT_TOL``.  Each call's input must lie within
    ``MLA_INPUT_TOL`` rel-L2 of the program's own and each A8 code that
    differs be a one-step flip within ``BF16_FLIP_ULPS`` bf16 ulps of its
    boundary; the flips are counted per layer.  Untaught, the A8 flips
    that bf16 noise causes carry through the layers: the gaps to the
    emulating program and to the plain-flash one are reported beside
    ``MLA_MODEL_TOL``, the bound the untaught check held before (PERF.md
    §6), with greedy-token agreement with each."""
    import collections
    from repro_torch import api
    from repro_torch.core.backend import Backend
    from repro_torch.kernels import flash_attention as fa

    cfg, params, toks = small_mla_model(7)
    records, flips = [], {}
    rec = api.Program.build(cfg, params, execution=recording_backend(
        records, flash_min_seq=64))
    gpu = api.Program.build(cfg, params,
                            execution=Backend("photonic", flash_min_seq=64))
    before = (fa.launches, fa.launches_mma)
    lg, _ = rec.prefill({"tokens": toks}, 112)
    torch.cuda.synchronize()
    flash = (fa.launches - before[0], fa.launches_mma - before[1])
    lg = lg.cpu()
    taught = api.Program.build(cfg, params, device="cpu",
                               execution=exact_backend(
                                   mma_flash=True, flash_min_seq=64,
                                   teacher=collections.deque(records),
                                   flips=flips, input_tol=MLA_INPUT_TOL))
    lt, _ = taught.prefill({"tokens": toks}, 112)
    err = rel_l2(lg, lt)
    plain_lg, _ = gpu.prefill({"tokens": toks}, 112)
    gen = gpu.generate(toks, 8).cpu()
    out = {"phase": "small_mla", "dtype": cfg.compute_dtype,
           "flash_launches": flash[0], "flash_launches_mma": flash[1],
           "tolerance": MLA_TAUGHT_TOL, "input_tolerance": MLA_INPUT_TOL,
           "gpu_vs_taught_exact_mma_flash_rel_l2": err,
           "recording_logits_equal": bool(torch.equal(plain_lg.cpu(), lg)),
           "a8_flips_per_layer_and_lm_head": per_layer_flips(
               cfg, flips["per_call"]),
           **{k: v for k, v in flips.items() if k != "per_call"},
           "untaught_report_bound": MLA_MODEL_TOL}
    exact = {flash_kind: api.Program.build(
        cfg, params, device="cpu", execution=exact_backend(
            mma_flash=flash_kind == "mma", flash_min_seq=64))
        for flash_kind in ("mma", "plain")}
    for name, prog in exact.items():
        lc, _ = prog.prefill({"tokens": toks}, 112)
        out[f"gpu_vs_exact_{name}_flash_rel_l2"] = rel_l2(lg, lc)
        out[f"greedy_tokens_equal_exact_{name}_flash"] = bool(
            (gen == prog.generate(toks, 8)).all())
    emit(out)
    if not (flash == (cfg.num_layers, cfg.num_layers)
            and torch.isfinite(lg).all() and flips["calls"] == len(records)
            and err <= MLA_TAUGHT_TOL):
        raise AssertionError(f"small bf16 MLA model GPU vs CPU: {out}")


# -------------------------------------------------------------------------
# phase 3k: the memory-stream paths (vlm and audio)
# -------------------------------------------------------------------------
VLM_FUSED_PER_PASS = (265, 282)     # llama-3.2-vision-11b R&B: decode,
                                    # prefill pass
AUDIO_FUSED_PER_PASS = (193, 386)   # whisper-medium R&B: decode, prefill


def serve_memory(torch, gpu, name, per_pass, seed):
    """``name`` (llama-3.2-vision-11b or whisper-medium) with its R&B plan
    at full width and depth, photonic, bf16, seeded random weights, each
    request carrying its own seeded stub embeddings (``configs.
    stub_extras``: 1601 image tokens of 7680, or 1500 frames of 128):
    ``Program.generate`` of 2 x 600 tokens (+16) and a
    ``ContinuousScheduler`` over {40, 300, 512, 1300} (+16 each), none
    chunked (a request with extras prefills whole), its decode graph
    against an eager cell.  Fused-MVM launches are held to the config's
    count per pass, flash to its count per prefill (``flash_per_prefill``:
    causal and not), all on the tensor-core variant."""
    from repro_torch import api
    from repro_torch.configs import get_arch, stub_extras
    from repro_torch.models import transformer as tfm

    cfg = get_arch(name, reuse=True)
    per_decode = fused_per_pass(cfg, prefill=False)
    per_prefill = fused_per_pass(cfg, prefill=True)
    if (per_decode, per_prefill) != per_pass:
        raise AssertionError(f"fused launches per pass {per_decode} / "
                             f"{per_prefill} != {per_pass}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    n_params = sum(leaf.numel() for leaf in tree_leaves(params))
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = prog.bank_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    lens = (40, 300, 512, 1300)
    requests = [(rid, rng.integers(0, V, n), 16, stub_extras(cfg, 1, gen))
                for rid, n in enumerate(lens)]
    prompts = rng.integers(0, V, (2, 600))
    extras = stub_extras(cfg, 2, gen)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    out, gen_s = generate_captured(torch, prog, prompts, 16, extras=extras)
    done, launches, drain = drain_graph_vs_eager(
        torch, prog, requests, dict(capacity=4, max_len=2048,
                                    prefill_chunk=512))
    sched_s = drain["drain_graph_s"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want or drain["drain_prefill_chunks"] != 0:
        raise AssertionError(f"completions {got} != {want} (unchunked; "
                             f"{drain['drain_prefill_chunks']} chunks)")
    # generate: one prefill + 15 decode steps; the scheduler: one prefill
    # per request, each in its bucket of 16 rows (48, 304, 512, 1312)
    rows = [600] + [-(-n // 16) * 16 for n in lens]
    prefills = len(rows)
    decodes = 15 + drain["drain_decode_steps"]
    fused = per_prefill * prefills + per_decode * decodes
    if launches["photonic_mvm_fused"] != fused:
        raise AssertionError(f"fused launches {launches} != {per_prefill} x "
                             f"{prefills} + {per_decode} x {decodes}")
    flash = [flash_per_prefill(cfg, r) for r in rows]
    flash_all, flash_causal = (sum(f[0] for f in flash),
                               sum(f[1] for f in flash))
    if not (launches["flash_attention"] == flash_all
            and launches["flash_attention_causal"] == flash_causal
            and launches["flash_attention_mma"] == flash_all):
        raise AssertionError(f"flash launches {launches} != {flash_all} "
                             f"({flash_causal} causal), all tensor-core")
    for kernel in ("photonic_mvm", "photonic_mvm_t",
                   "photonic_mvm_resident", "blend_shuffle", "ssd_chunk"):
        if launches[kernel] != 0:
            raise AssertionError(f"{kernel} ran on the {name} path: "
                                 f"{launches}")
    check_decode_attention_launches(cfg, launches, decodes)
    one = {k: v[:1] for k, v in extras.items()}
    logits, _ = prog.prefill(dict(tokens=prompts[:1], **one), 616)
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"non-finite {name} prefill logits")
    report = {"phase": "serve_" + cfg.family, "gpu": gpu, "arch": cfg.name,
              "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
              "transforms": list(cfg.reuse.transforms), "params": n_params,
              "d_model": cfg.d_model, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
              "d_ff": cfg.d_ff, "norm": cfg.norm, "mlp_act": cfg.mlp_act,
              "memory_rows": tfm.memory_len(cfg),
              "extras": {k: list(v.shape) for k, v in extras.items()},
              "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
              "build_s": build_s, "build_peak_mem_gb": build_peak_gb,
              "bank_int8_bytes": stats["int8_bytes"],
              "bank_fp_bytes": stats["fp_bytes"],
              "verify_banks": prog.verify_banks(),
              "generate_s": gen_s, "generate_tokens_per_s": 2 * 16 / gen_s,
              "scheduler_s": sched_s,
              "scheduler_tokens_per_s": 16 * len(lens) / sched_s,
              "scheduler_prompt_tokens": sum(lens),
              "scheduler_decode_steps": drain["drain_decode_steps"],
              "scheduler_prefill_chunks": drain["drain_prefill_chunks"],
              "prefill_passes": prefills, "decode_steps": decodes,
              "fused_per_prefill": per_prefill,
              "fused_per_decode": per_decode,
              "flash_per_prefill": {str(r): list(f)
                                    for r, f in zip(rows, flash)},
              "peak_mem_gb": peak_gb, "launches": launches, "drain": drain}
    emit(report)
    emit(profile_generate(torch, prog, prompts[:1], extras=one))
    emit(decode_step_costs(torch, prog))
    return launches


def small_memory_model(family: str, seed: int):
    """A small float32 vlm or whisper model on an R&B stack whose second
    reuse is transposed (R=1 x T=2), with memories of at least 64 rows, so
    that every flash call, the non-causal ones with ragged key lengths
    among them, takes the kernel at ``flash_min_seq=64``: (config, CPU
    params, a (2, 96) token batch, seeded CPU stub extras)."""
    from repro_torch.configs import stub_extras
    from repro_torch.configs.archs import rb
    from repro_torch.configs.base import (AudioConfig, ModelConfig,
                                          VisionConfig)
    from repro_torch.models import transformer as tfm
    import torch
    if family == "vlm":
        cfg = ModelConfig(name="small-vlm", family="vlm", num_layers=10,
                          d_model=128, num_heads=4, num_kv_heads=2,
                          d_ff=256, vocab_size=97, group_size=5,
                          vision=VisionConfig(num_image_tokens=80,
                                              d_vision=96,
                                              cross_attn_every=5,
                                              cross_attn_offset=3),
                          compute_dtype="float32")
    else:
        cfg = ModelConfig(name="small-whisper", family="audio", num_layers=2,
                          d_model=128, num_heads=4, num_kv_heads=4,
                          d_ff=256, vocab_size=97, norm="layer",
                          mlp_act="gelu",
                          audio=AudioConfig(num_frames=100, d_audio=40,
                                            encoder_layers=2),
                          compute_dtype="float32")
    cfg = rb(cfg, 1, 2, transforms=("identity", "transpose"))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 96))
    extras = stub_extras(cfg, 2, torch.Generator().manual_seed(seed))
    return cfg, tfm.init_model(cfg, seed=seed, device="cpu"), toks, extras


def small_memory_checks(torch):
    """The small float32 vlm and whisper models (``small_memory_model``)
    with flash from 64 rows.  The card's prefill logits against the CPU
    program with the MVM kernels' integer arithmetic (``exact_backend``)
    within ``EXACT_ARITH_TOL``, that program taught at each MVM call by the
    card's input (``recording_backend``): a per-tensor A8 code that
    float32 noise moves across a rounding boundary is counted and checked
    to lie within ``A8_FLIP_BAND`` of it instead of carrying on (untaught,
    such a flip carried through ten layers reads 0.0185 on the small vlm:
    PERF.md, slice 11).  The untaught program's gap is reported, its
    greedy tokens must equal the card's, and one prefill's flash launches
    must equal the config's count (the causal ones apart)."""
    import collections
    from repro_torch import api
    from repro_torch.core.backend import Backend
    from repro_torch.kernels import counts

    out = {"phase": "small_memory", "tolerance": EXACT_ARITH_TOL,
           "a8_flip_band": A8_FLIP_BAND}
    for family, seed in (("vlm", 13), ("audio", 14)):
        cfg, params, toks, extras = small_memory_model(family, seed)
        batch = dict(tokens=toks, **extras)
        records, flips = [], {}
        rec = api.Program.build(cfg, params,
                                execution=recording_backend(
                                    records, flash_min_seq=64))
        before = counts.snapshot()
        lg, _ = rec.prefill(batch, 112)
        torch.cuda.synchronize()
        d = counts.difference(before, counts.snapshot())
        lg = lg.cpu()
        taught = api.Program.build(
            cfg, params, device="cpu", execution=exact_backend(
                flash_min_seq=64, teacher=collections.deque(records),
                flips=flips))
        lt, _ = taught.prefill(batch, 112)
        exact = api.Program.build(cfg, params, device="cpu",
                                  execution=exact_backend(flash_min_seq=64))
        lc, _ = exact.prefill(batch, 112)
        gpu = api.Program.build(cfg, params,
                                execution=Backend("photonic",
                                                  flash_min_seq=64))
        same = bool((gpu.generate(toks, 8, extras=extras).cpu()
                     == exact.generate(toks, 8, extras=extras)).all())
        err = rel_l2(lg, lt)
        want = flash_per_prefill(cfg, toks.shape[1], min_seq=64)
        out[cfg.name] = {"gpu_vs_taught_exact_rel_l2": err,
                         "gpu_vs_exact_rel_l2": rel_l2(lg, lc),
                         "greedy_tokens_equal_exact": same,
                         "flash_launches": d["flash_attention"],
                         "flash_launches_causal": d["flash_attention_causal"],
                         "flash_expected": list(want), **flips}
        if not (err <= EXACT_ARITH_TOL and same
                and flips["calls"] == len(records)
                and bool(torch.isfinite(lg).all())
                and (d["flash_attention"], d["flash_attention_causal"])
                == want):
            emit(out)
            raise AssertionError(f"small {family} model GPU vs CPU: {out}")
    emit(out)


# -------------------------------------------------------------------------
# phase 3m: training (slice 13)
# -------------------------------------------------------------------------
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
TRAIN_FUSED_PER_PASS = 2401     # granite R&B: 1 + 24 x (4 + 3 x 32)


@contextlib.contextmanager
def timed_calls(module, name: str, sink: list):
    """Every call of ``module.name`` meanwhile appends its wall seconds to
    ``sink`` (after a ``torch.cuda.synchronize`` on either side)."""
    import torch
    fn = getattr(module, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` for the block: the embedding
    and gather gradients sum in a fixed order instead of by atomics, so a
    resumed run can be held bit-equal to a straight one.  cuBLAS on one
    stream is deterministic already; the workspace setting it asks for is
    set for the check.  Uninitialised memory is left unfilled."""
    import os
    det = torch.utils.deterministic
    old = (torch.are_deterministic_algorithms_enabled(),
           det.fill_uninitialized_memory,
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        det.fill_uninitialized_memory = old[1]
        if old[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old[2]


@contextlib.contextmanager
def plain_kernels():
    """The fused MVM's and flash's wrappers run their plain PyTorch
    versions meanwhile, on the card too (no launch is counted): a full
    width forward through them is the plain reference of the same pass
    through the kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import photonic_mvm as pm
    kernels = (pm.photonic_mvm_fused, fa.flash_attention)

    def flash_plain(q, k, v, *, causal=True, q_offset=None, kv_len=None):
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        q_offset=int(q_offset or 0),
                                        kv_len=kv_len)

    pm.photonic_mvm_fused = pm.photonic_mvm_fused_plain
    fa.flash_attention = flash_plain
    try:
        yield
    finally:
        pm.photonic_mvm_fused, fa.flash_attention = kernels


@contextlib.contextmanager
def checked_kernels(worst: dict):
    """Each fused-MVM and flash launch meanwhile also runs its plain
    version on the same inputs: per kernel, the calls and the largest
    rel-L2 of a launch's output against its plain version go into
    ``worst``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import photonic_mvm as pm
    kernels = (pm.photonic_mvm_fused, fa.flash_attention)

    def note(name, got, want):
        calls, err = worst.get(name, (0, 0.0))
        worst[name] = (calls + 1, max(err, rel_l2(got, want)))

    def mvm(x, wq, x_scale, w_scale, **kw):
        y = kernels[0](x, wq, x_scale, w_scale, **kw)
        note("photonic_mvm_fused", y,
             pm.photonic_mvm_fused_plain(x, wq, x_scale, w_scale, **kw))
        return y

    def flash(q, k, v, *, causal=True, q_offset=None, kv_len=None):
        o = kernels[1](q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len)
        note("flash_attention", o, fa.flash_attention_plain(
            q, k, v, causal=causal, q_offset=int(q_offset or 0),
            kv_len=kv_len))
        return o

    pm.photonic_mvm_fused, fa.flash_attention = mvm, flash
    try:
        yield
    finally:
        pm.photonic_mvm_fused, fa.flash_attention = kernels


def backward_device_us(evs) -> float:
    """Device time of the kernels launched inside autograd's backward
    functions (the remat recomputation among them): the profiled events
    named ``autograd::engine::evaluate_function`` with no such ancestor."""
    key = "autograd::engine::evaluate_function"
    total = 0.0
    for e in evs:
        if not e.name.startswith(key):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(key):
            parent = parent.cpu_parent
        if parent is None:
            total += getattr(e, "device_time_total", 0.0)
    return total


def profile_train_step(torch, step_fn, params, opt, batch) -> dict:
    """``torch.profiler`` over one train step (the step's own
    ``float(loss)`` sync ends it): wall, device busy and idle share,
    backward's share of the device time, and the ten largest CUDA kernels
    by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    bwd = backward_device_us(prof.events())
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "backward_device_ms": bwd / 1e3,
            "backward_share_of_busy": bwd / busy if busy else None,
            "cuda_kernels": sum(e.count for e in kernels),
            "top10": [{"kernel": e.key[:160],
                       "ms": e.self_device_time_total / 1e3,
                       "launches": e.count} for e in kernels[:10]]}


def train_phase(torch, gpu):
    """granite-moe-1b-a400m R&B (6 x 4) at full published width through
    ``repro_torch.launch.train.run``: bf16 compute over float32 masters,
    the copy task, batch 8 x 1024 tokens in 2 microbatches, remat per
    reuse, AdamW.  A straight 6-step run, then a 3-step run (its final
    checkpoint at step 3) resumed to step 6 in a scratch directory
    under ``build/`` (removed afterwards), all three deterministic: the
    resumed params and Adam state must equal the straight run's bit for
    bit.  Then one profiled step, and the held-out eval through
    ``Program.loss`` on xla and on photonic over the launcher's held-out
    batch (pipeline seed + 1, step 10000): fused-MVM and flash launches
    counted in the photonic call against the config's exact count, each
    launch of the same pass held to its plain version on its own inputs
    (``checked_kernels``) and the photonic CE to the xla one at the W8A8
    bound.  The logits gaps are reported, not gated: on this
    random-weight MoE stack a rounding difference in one call moves
    near-tied routing choices that carry through the layers, so even the
    pass through the plain versions lies far from the kernels' (PERF.md
    §6, slice 13)."""
    import tempfile
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import counts
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint, trainer

    cfg = get_arch(TRAIN_ARCH, reuse=True)
    per_pass = fused_per_pass(cfg, prefill=True)
    flash_want = flash_per_prefill(cfg, TRAIN_SEQ)
    if per_pass != TRAIN_FUSED_PER_PASS:
        raise AssertionError(f"fused launches per pass {per_pass} != "
                             f"{TRAIN_FUSED_PER_PASS}")
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    disk_free_gb = shutil.disk_usage(scratch).free / 1e9

    def tcfg(name, every):
        return TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1,
                           microbatch=2, checkpoint_every=every,
                           checkpoint_dir=str(scratch / name))

    def run(name, steps, every, record=None):
        return launch.run(cfg, tcfg(name, every), batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, steps=steps, log_every=1,
                          record=record)

    saves, restores, straight = [], [], []
    try:
        with timed_calls(checkpoint, "save", saves), \
                timed_calls(checkpoint, "restore", restores), \
                deterministic(torch):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, losses = run("straight", TRAIN_STEPS, 0, straight)
            straight_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            ckpt_bytes = sum(f.stat().st_size for f in
                             (scratch / "straight").rglob("*.npz"))
            shutil.rmtree(scratch / "straight")
            # one save at step 3 (``checkpoint_every=3`` would write the
            # same step twice: its periodic save and the final one)
            run("resumed", 3, 0)
            rp, ro, rlosses = run("resumed", TRAIN_STEPS, 0)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves({"p": params, "m": opt.m, "v": opt.v}),
            tree_leaves({"p": rp, "m": ro.m, "v": ro.v}))) and int(
                ro.step) == TRAIN_STEPS
        del rp, ro
        gnorms = [float(r["grad_norm"]) for r in straight]
        lrs = [float(r["lr"]) for r in straight]
        walls = [r["s"] for r in straight]
        n_params = sum(leaf.numel() for leaf in tree_leaves(params))
        out = {"phase": "train", "gpu": gpu, "arch": cfg.name,
               "R": cfg.reuse.num_basic, "T": cfg.reuse.reuse_times,
               "params": n_params, "d_model": cfg.d_model,
               "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
               "padded_vocab": cfg.padded_vocab, "dtype": cfg.compute_dtype,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatch": 2,
               "steps": TRAIN_STEPS, "deterministic": True,
               "losses": losses, "grad_norms": gnorms, "lrs": lrs,
               "step_walls_s": walls,
               "step_wall_median_s": statistics.median(walls),
               "step_wall_median_after_first_s": statistics.median(
                   walls[1:]),
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / statistics.median(
                   walls[1:]),
               "straight_run_s": straight_s, "peak_mem_gb": peak_gb,
               "checkpoint_bytes": ckpt_bytes, "disk_free_gb": disk_free_gb,
               "checkpoint_save_s": saves, "checkpoint_restore_s": restores,
               "resumed_losses": rlosses,
               "resumed_bit_equal": bool(same)}
        if not (same and rlosses == losses[3:]
                and all(np.isfinite(losses + gnorms))):
            emit(out)
            raise AssertionError("the resumed run differs from the straight "
                                 "run, or a loss is not finite")

        # one profiled step (not deterministic: the run's own kernels)
        pipe = SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, seed=0))
        step_fn = trainer.make_train_step(cfg, tcfg("profile", 0))
        batch = pipe.device_batch(TRAIN_STEPS)
        step_fn(params, opt, batch)                 # warm, not deterministic
        out["profiled_step"] = profile_train_step(torch, step_fn, params, opt,
                                                  batch)
        del opt

        # the held-out eval
        held = SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, seed=1)).device_batch(10_000)
        xla = api.Program.build(cfg, params, execution="xla")
        pho = api.Program.build(cfg, params, execution="photonic")
        del params
        ce_x, _ = xla.loss(held)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ce_p, aux_p = pho.loss(held)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = counts.snapshot()
        worst = {}
        with torch.no_grad():
            lx = tfm.forward(xla.bank, cfg, held, execution=xla.backend)[0]
            with checked_kernels(worst):
                lp = tfm.forward(pho.bank, cfg, held,
                                 execution=pho.backend)[0]
            with plain_kernels():
                lpp = tfm.forward(pho.bank, cfg, held,
                                  execution=pho.backend)[0]
        ce_rel = abs(float(ce_p) - float(ce_x)) / abs(float(ce_x))
        calls, err = worst.get("photonic_mvm_fused", (0, 0.0))
        mvm_calls = (calls, err <= MVM_TOL)
        calls, err = worst.get("flash_attention", (0, 0.0))
        flash_calls = (calls, err <= FLASH_TOL)
        out["eval_logits_photonic_vs_xla_rel_l2"] = rel_l2(lp, lx)
        out["eval_logits_plain_photonic_vs_xla_rel_l2"] = rel_l2(lpp, lx)
        out["eval_logits_kernels_vs_plain_rel_l2"] = rel_l2(lp, lpp)
        out.update({"eval_ce_xla": float(ce_x), "eval_ce_photonic": float(
            ce_p), "eval_aux_photonic": float(aux_p),
            "eval_photonic_s": eval_s,
            "eval_ce_photonic_vs_xla_rel": ce_rel,
            "eval_calls_vs_plain": {k: {"calls": c, "max_rel_l2": e}
                                    for k, (c, e) in worst.items()},
            "eval_fused_per_pass": per_pass,
            "eval_flash_expected": list(flash_want),
            "eval_launches": launches})
        emit(out)
        others = [k for k in ("photonic_mvm", "photonic_mvm_t",
                              "photonic_mvm_resident", "blend_shuffle",
                              "ssd_chunk", "photonic_mvm_fused_gemv")
                  if launches[k]]
        if not (launches["photonic_mvm_fused"] == per_pass
                and launches["flash_attention"] == flash_want[0]
                and launches["flash_attention_causal"] == flash_want[1]
                and launches["flash_attention_mma"] == flash_want[0]
                and not others and ce_rel <= W8A8_BOUND
                and mvm_calls == (per_pass, True)
                and flash_calls == (flash_want[0], True)
                and np.isfinite(float(ce_p)) and np.isfinite(float(ce_x))):
            raise AssertionError(f"the photonic held-out eval: {launches}, "
                                 f"calls against their plain versions "
                                 f"{worst}, CE {float(ce_p)} against "
                                 f"{float(ce_x)} on xla")
        return {"launches": launches, "losses": losses,
                "peak_mem_gb": peak_gb,
                "step_wall_median_after_first_s": statistics.median(
                    walls[1:])}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


# -------------------------------------------------------------------------
# phase 3m2: training on a mesh of ranks, with and without FSDP (slice 16)
# -------------------------------------------------------------------------
TRAIN_MESH = "2x1"
TRAIN_SEQ_MESH = "1x2"       # the reference's train layout ("seq"), slice 20
TRAIN_MESH_STEPS = 1         # 1 step (2 until slice 23, 3 before): the
                             # script's 1200 s limit
TRAIN_MESH_TOL = 1e-3       # DP step 0 vs the train phase's step 0; the
                            # mesh eval's CE vs the unsharded einsum route


def state_digest(tree) -> dict:
    """sha256 of each leaf's bytes, by path (a bit-for-bit fingerprint
    that crosses processes without moving the arrays)."""
    import hashlib
    from repro_torch.train import checkpoint
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in checkpoint._flatten(tree).items()}


def train_mesh_rank(mesh, job):
    """One rank of ``train_mesh``: ``launch.train.run(..., mesh=mesh)`` on
    granite-moe-1b-a400m R&B at full width, the train phase's setup, for
    ``TRAIN_MESH_STEPS`` steps from seed 0, first data-parallel, then with
    ``cfg.fsdp`` (each in its own checkpoint directory, deterministic
    algorithms on).  Per run: the losses, grad norms, step walls, peak,
    the bytes of the rank's params plus Adam state, the FSDP all-gathers
    and reduce-scatters a step beside ``fsdp.planned``'s, and the most
    gathered bytes alive (``fsdp.track_live``).  Then the two runs'
    gathered params and moments compared bit for bit, the FSDP state's
    digest, and the held-out eval through ``Program.loss`` of the FSDP
    build on this mesh on photonic: fused launches counted, each held to
    its plain version (``checked_kernels``)."""
    import torch
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import counts
    from repro_torch.launch import train as launch
    from repro_torch.sharding import fsdp as fsdp_lib
    from repro_torch.sharding import partition
    from repro_torch.train import trainer

    base = get_arch(TRAIN_ARCH, reuse=True)
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "transport": mesh.describe()}
    live = fsdp_lib.track_live()
    gathered = {}
    for fsdp in (False, True):
        cfg = dataclasses.replace(base, fsdp=fsdp)
        tcfg = TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1,
                           microbatch=2, checkpoint_every=0,
                           checkpoint_dir=job["dirs"][fsdp])
        specs = trainer.param_specs(cfg, mesh)
        planned = (fsdp_lib.planned(cfg, partition.data_specs(specs, mesh))
                   if fsdp else {k: 0 for k in fsdp_lib.COUNTS})
        record = []
        fsdp_lib.reset_counts()
        fsdp_lib.reset_live()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with deterministic(torch):
            params, opt, losses = launch.run(
                cfg, tcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_MESH_STEPS, mesh=mesh, log_every=1,
                record=record)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        made = fsdp_lib.snapshot()
        held = tree_leaves({"p": params, "m": opt.m, "v": opt.v})
        # the whole state, leaf by leaf, to host memory: the next run's
        # peak holds none of it
        gathered[fsdp] = tuple(partition.map_with_specs(
            lambda t, spec: partition.gather_leaf(t, spec, mesh).cpu(),
            tree, specs) for tree in (params, opt.m, opt.v)) + (
                int(opt.step),)
        out["fsdp" if fsdp else "dp"] = {
            "losses": losses,
            "grad_norms": [float(r["grad_norm"]) for r in record],
            "lrs": [float(r["lr"]) for r in record],
            "step_walls_s": [r["s"] for r in record], "run_s": run_s,
            "peak_mem_gb": peak_gb,
            "params_adam_bytes": sum(t.numel() * t.element_size()
                                     for t in held),
            "leaves_cut": sum(1 for x in _spec_list(specs) if x),
            "fsdp_collectives_per_step": {
                k: v / TRAIN_MESH_STEPS for k, v in made.items()},
            "fsdp_planned_per_step": {k: v * tcfg.microbatch
                                      for k, v in planned.items()},
            "gathered_max_bytes": live["max"],
            "gathered_blocks_max": live["blocks_max"],
            "gathered_left_bytes": live["now"]}
        del params, opt, held
    a, b = gathered[False], gathered[True]
    out["fsdp_bit_equal_to_dp"] = (
        out["dp"]["losses"] == out["fsdp"]["losses"]
        and out["dp"]["grad_norms"] == out["fsdp"]["grad_norms"]
        and a[3] == b[3] and all(
            torch.equal(x, y) for x, y in zip(
                tree_leaves(dict(zip("pmv", a[:3]))),
                tree_leaves(dict(zip("pmv", b[:3]))))))
    out["digest"] = state_digest(
        (b[0], {"m": b[1], "v": b[2], "step": np.int32(b[3])}))
    del gathered, a

    # the held-out eval on this mesh, photonic, through the FSDP build
    cfg = dataclasses.replace(base, fsdp=True)
    prog = api.Program.build(cfg, b[0], execution="photonic", mesh=mesh)
    del b
    held = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=1)).device_batch(10_000)
    worst = {}
    counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), checked_kernels(worst):
        ce, aux = prog.loss(held)
    torch.cuda.synchronize()
    launches = counts.snapshot()
    out["eval"] = {"ce": float(ce), "aux": float(aux),
                   "wall_s": time.perf_counter() - t0,
                   "fused_launches": launches["photonic_mvm_fused"],
                   "fused_gemv_launches": launches["photonic_mvm_fused_gemv"],
                   "flash_launches": launches["flash_attention"],
                   "calls_vs_plain": {k: {"calls": c, "max_rel_l2": e}
                                      for k, (c, e) in worst.items()}}
    return out



@contextlib.contextmanager
def model_gathers(sink: list):
    """Record ``(shape, bytes)`` of every all-gather over "model" alone
    while the context is open (``collectives.all_gather``, which every
    differentiable gather calls)."""
    from repro_torch.sharding import collectives as coll

    real = coll.all_gather

    def spy(x, mesh, axes, dim=-1):
        out = real(x, mesh, axes, dim=dim)
        if coll._axes(axes) == ("model",) and mesh.axis_size(axes) > 1:
            sink.append((tuple(out.shape), out.numel() * out.element_size()))
        return out

    coll.all_gather = spy
    try:
        yield sink
    finally:
        coll.all_gather = real


def held_piece_shapes(cfg) -> set:
    """The whole and per-block shapes of the leaves a train step's rank
    runs as its "model" pieces and must not gather: expert banks cut on
    their experts, the SSM's conv kernel and per-head vectors."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import partition

    out = set()

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif set(partition.leaf_axes(path, tree.ndim)) & {
                "experts", "ssm_conv", "ssm_heads"}:
            out.update((tuple(tree.shape), tuple(tree.shape[1:])))

    walk(tfm.abstract_params(cfg), ())
    return out


MAMBA_TRAIN_RB = (4, 4)      # train_mesh's mamba2-780m: 4 physical blocks
                             # x 4 reuses (published 12 x 4: the depth cut)
MAMBA_TRAIN_BATCH = 4        # 4 x 1024 tokens in 2 microbatches
MAMBA_TRAIN_DTYPE = "float32"   # the gated 1x2 run.  In bf16 these SSM
                                # leaves' gradients lie far from float32
                                # in the reference too (the smoke model's
                                # witness: tests/test_torch_train_ssm.py),
                                # so a split's order change reads as bf16
                                # noise there; printed beside the gap
SSM_PIECE_LEAVES = ("conv_k", "A_log", "D", "dt_bias")   # a rank's pieces


def mamba2_train_config(dtype=MAMBA_TRAIN_DTYPE):
    """mamba2-780m R&B at its published width, cut in depth to
    ``MAMBA_TRAIN_RB``, computing in ``dtype``."""
    from repro_torch.configs import get_arch, rb
    r, t = MAMBA_TRAIN_RB
    return rb(dataclasses.replace(get_arch("mamba2-780m"), num_layers=r * t,
                                  compute_dtype=dtype), r, t)


def mamba2_train_step(mesh=None, dtype=MAMBA_TRAIN_DTYPE, microbatch=2):
    """One train step of ``mamba2_train_config(dtype)`` from seed 0 on a
    ``MAMBA_TRAIN_BATCH`` x ``TRAIN_SEQ`` copy-task batch in ``microbatch``
    microbatches (remat), unsharded (``mesh`` None) or on a rank of a "seq" mesh (its
    pieces of every leaf).  Returns the loss, the wall, the peak, the
    ``ssd_chunk`` launches and the heads of each, the leaves' specs and
    every SSM-block (``/mixer/``) leaf's gradient (the rank's piece) on the
    host.  The gradients are what the step hands ``adamw.update``."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    from repro_torch.train import checkpoint
    from repro_torch.train import trainer

    cfg = mamba2_train_config(dtype)
    batch = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=MAMBA_TRAIN_BATCH)).device_batch(0)
    params = tfm.init_model(cfg, seed=0)
    specs = trainer.param_specs(cfg, mesh) if mesh is not None else None
    if mesh is not None:
        params = partition.local_tree(params, specs, mesh)
    step = trainer.make_train_step(
        cfg, TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         microbatch=microbatch),
        act_pspec=None if mesh is None else partition.act_pspec(mesh),
        mesh=mesh)
    seen, heads = {}, []
    update, forward = adamw.update, ssd._forward

    def keep_grads(params, grads, *a, **k):
        seen["grads"] = grads
        return update(params, grads, *a, **k)

    def count_heads(x, *a):
        heads.append(x.shape[3])
        return forward(x, *a)

    adamw.update, ssd._forward = keep_grads, count_heads
    torch.cuda.reset_peak_memory_stats()
    before = ssd.launches
    t0 = time.perf_counter()
    try:
        _, _, metrics = step(params, adamw.init(params), batch)
        loss = float(metrics["loss"])
    finally:
        adamw.update, ssd._forward = update, forward
    wall = time.perf_counter() - t0
    grads = {k: v for k, v in checkpoint._flatten(seen.pop("grads")).items()
             if "/mixer/" in k}
    flat_specs = ({k: list(v) for k, v in
                   _spec_paths(specs).items() if "/mixer/" in k}
                  if specs is not None else None)
    return {"loss": loss, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ssd_launches": ssd.launches - before, "ssd_heads": heads,
            "specs": flat_specs, "grads": grads}


def _spec_paths(specs, prefix=()) -> dict:
    """``{"a/b": spec}`` of a spec tree."""
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(_spec_paths(specs[k], prefix + (k,)))
        return out
    return {"/".join(prefix): specs}


def train_seq_rank(mesh):
    """One rank of ``train_mesh``'s "seq" run: ``launch.train.run(...,
    mesh=mesh)`` on granite-moe-1b-a400m R&B at full width, the train
    phase's setup, ``TRAIN_MESH_STEPS`` steps from seed 0 with no
    checkpoint (deterministic algorithms on).  The rank holds the
    reference's whole ``tree_pspecs`` piece of every parameter and Adam
    moment and trains with its dots tensor-parallel around a residual cut
    by positions ("seq", ``partition.act_pspec``), its own 16 of the 32
    experts (``partition.ExpertLayout``).  Returns its losses, grad norms,
    step walls, peak, the bytes of its params plus Adam state, the leaves
    it holds a "model" piece of, the all-gathers over "model" a step and
    any of them that gathered an expert bank; then the rank's
    ``mamba2_train_step``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as launch
    from repro_torch.sharding import partition
    from repro_torch.train import trainer

    cfg = get_arch(TRAIN_ARCH, reuse=True)
    tcfg = TrainConfig(lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1,
                       microbatch=2, checkpoint_every=0, checkpoint_dir="")
    record = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with deterministic(torch), model_gathers([]) as gathers:
        params, opt, losses = launch.run(
            cfg, tcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            steps=TRAIN_MESH_STEPS, mesh=mesh, log_every=1, record=record)
    torch.cuda.synchronize()
    held = tree_leaves({"p": params, "m": opt.m, "v": opt.v})
    specs = trainer.param_specs(cfg, mesh)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    held_bytes = sum(t.numel() * t.element_size() for t in held)
    banks = held_piece_shapes(cfg)
    del params, opt, held
    mamba = mamba2_train_step(mesh)
    return {"rank": mesh.rank, "coords": mesh.coords,
            "model_all_gathers_per_step": len(gathers) / TRAIN_MESH_STEPS,
            "model_all_gather_bytes_per_step": sum(
                n for _, n in gathers) / TRAIN_MESH_STEPS,
            "expert_bank_gathers": sorted({sh for sh, _ in gathers
                                           if sh in banks}),
            "mamba2": mamba,
            "act_pspec": [str(e) for e in partition.act_pspec(mesh)],
            "losses": losses,
            "grad_norms": [float(r["grad_norm"]) for r in record],
            "step_walls_s": [r["s"] for r in record], "run_s": run_s,
            "peak_mem_gb": peak, "params_adam_bytes": held_bytes,
            "leaves_model_cut": sum(
                1 for x in _spec_list(specs)
                if partition.model_dim(x) is not None)}


def _spec_list(specs) -> list:
    """The spec tuples of a spec tree (sorted keys)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_list(specs[k])]
    return [specs]


def train_mesh_phase(torch, gpu, train):
    """granite-moe-1b-a400m R&B at full published width on a 2x1 mesh of
    ranks sharing the card over gloo, the train phase's setup (bf16 over
    float32 masters, xla, the copy task, 8 x 1024 in 2 microbatches,
    remat), ``TRAIN_MESH_STEPS`` steps data-parallel and again with
    ``cfg.fsdp`` from the same seed (``train_mesh_rank``).  Gates: the FSDP
    run's losses, grad norms, final params and moments bit-equal to the DP
    run's; the DP step-0 loss within ``TRAIN_MESH_TOL`` of the train
    phase's unsharded step 0 (same weights and batch); the FSDP run's
    last checkpoint restored in this process on one device bit-equal to
    the ranks' gathered state (per-leaf sha256); the mesh's photonic
    held-out CE within ``TRAIN_MESH_TOL`` of the unsharded Program's with
    flash off (the einsum route a mesh runs; the flash route's gap
    printed), every fused launch of the pass held to its plain version
    and counted at ``TRAIN_FUSED_PER_PASS`` a rank.  Since slice
    22 FSDP gathers each block where it runs: the FSDP rank's peak below
    the DP rank's, its all-gathers and reduce-scatters a step
    ``fsdp.planned``'s times the microbatches (none under DP), one block's
    gathers alive at most and none after the run.  Since slice 20 a 1x2
    run in the reference's train layout (``train_seq_rank``: "model"
    pieces, the residual cut by positions), its step-0 loss within
    ``TRAIN_MESH_TOL`` of the unsharded step 0, its ranks' params + Adam
    bytes and peak printed beside the DP rank's; since slice 23 it runs
    its own experts (no all-gather over "model" of an expert bank), and
    the same ranks then take one step of mamba2-780m R&B at full width
    (``mamba2_train_step``; depth cut to ``MAMBA_TRAIN_RB``, float32) on
    their own SSM heads and conv channels, held to the same step unsharded
    in this process: the loss within ``TRAIN_MESH_TOL``, each SSM leaf's
    gradient piece (``conv_k``, ``A_log``, ``D``, ``dt_bias``) within
    ``SHARD_SPLIT_TOL`` rel-L2 of the unsharded gradient's block (every
    SSM-block leaf's printed), and the rank's ``ssd_chunk`` launches, each
    on 24 heads, equal to the dry-run's planned calls for that train cell.
    Beside the rank's gap it prints two readings of the unsharded step's
    own spread: the same float32 step in one microbatch (a summation order
    change alone, ``order_floor``) and in bf16, each leaf's distance from
    the gated float32 step.
    ``train``: the train phase's result (its losses)."""
    import tempfile
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH, reuse=True), fsdp=True)
    (ROOT / "build").mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="train_mesh_",
                                    dir=ROOT / "build"))
    try:
        return _train_mesh_runs(torch, gpu, train, cfg, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _train_mesh_runs(torch, gpu, train, cfg, scratch):
    """``train_mesh_phase``'s runs and gates, its FSDP checkpoint under
    ``scratch``."""
    from repro_torch import api
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import planned
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    from repro_torch.train import checkpoint

    job = {"dirs": {False: "", True: str(scratch / "fsdp")}}
    t0 = time.perf_counter()
    ranks = mesh_lib.init_ranks(train_mesh_rank, TRAIN_MESH, device="cuda",
                                args=(job,))
    ranks_s = time.perf_counter() - t0
    # the reference's launch.train layout on 1x2: "model" pieces of every
    # parameter and moment, the residual cut by positions, a rank's own
    # experts; then mamba2 on the rank's SSM heads
    t0 = time.perf_counter()
    seq_ranks = mesh_lib.init_ranks(train_seq_rank, TRAIN_SEQ_MESH,
                                    device="cuda")
    seq_s = time.perf_counter() - t0

    # the FSDP checkpoint on one device, in this process
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=7)
    (params, opt), extra = checkpoint.restore(
        str(scratch / "fsdp"), TRAIN_MESH_STEPS,
        (params, adamw.init(params)))
    restore_s = time.perf_counter() - t0
    digest = state_digest((params, {"m": opt.m, "v": opt.v,
                                    "step": np.int32(int(opt.step))}))
    del opt
    held = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=1)).device_batch(10_000)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    ces = {}
    for route in ("einsum", "flash"):
        prog.backend = dataclasses.replace(prog.backend,
                                           flash=route == "flash")
        ces[route] = float(prog.loss(held)[0])
    del prog, held
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mamba = mamba2_train_step()
    mamba_s = time.perf_counter() - t0
    # the unsharded step's own spread, each SSM leaf's distance from the
    # gated float32 step: a summation order change alone (the same step in
    # one microbatch), and bf16
    spread = {}
    for key, kw in (("order_floor", {"microbatch": 1}),
                    ("bf16", {"dtype": "bfloat16"})):
        other = mamba2_train_step(**kw)["grads"]
        spread[key] = {k: rel_l2(torch.as_tensor(other[k]),
                                 torch.as_tensor(g))
                       for k, g in mamba["grads"].items()
                       if k.rsplit("/", 1)[1] in SSM_PIECE_LEAVES}
        del other

    # the rank's SSM pieces against the unsharded gradient's blocks, and
    # its ssd_chunk launches against the dry-run's planned calls
    mcfg = mamba2_train_config()
    run, _ = dryrun.rank_step(
        mcfg, ShapeConfig("train", TRAIN_SEQ, MAMBA_TRAIN_BATCH, "train"),
        mesh_lib.census_mesh(TRAIN_SEQ_MESH), microbatch=2, act_mode="seq")
    before = planned.snapshot()["ssd_chunk"]
    run()
    ssd_planned = planned.snapshot()["ssd_chunk"] - before
    heads = ssm_dims(mcfg)[1] // 2
    pieces = []
    for r in seq_ranks:
        m = r["mamba2"]
        census = mesh_lib.census_mesh(TRAIN_SEQ_MESH, r["rank"])
        errs = {k: rel_l2(torch.as_tensor(g), torch.as_tensor(
            partition.local_slice(mamba["grads"][k], tuple(
                m["specs"][k]), census)))
            for k, g in m.pop("grads").items()}
        worst = max(errs, key=errs.get)
        ssm = {k: v for k, v in errs.items()
               if k.rsplit("/", 1)[1] in SSM_PIECE_LEAVES}
        pieces.append({"rank": r["rank"], "worst_leaf": worst,
                       "worst_rel_l2": errs[worst],
                       "worst_ssm_leaf": max(ssm, key=ssm.get),
                       "worst_ssm_rel_l2": max(ssm.values()),
                       "ssm_leaves": ssm,
                       "loss_rel": abs(m["loss"] - mamba["loss"])
                       / mamba["loss"],
                       "ssd_launches": m["ssd_launches"],
                       "ssd_heads": sorted(set(m.pop("ssd_heads"))),
                       "wall_s": m["wall_s"], "peak_mem_gb": m["peak_mem_gb"]})
    mamba.pop("grads")
    whole_heads = sorted(set(mamba.pop("ssd_heads")))

    r0 = ranks[0]
    step0 = train["losses"][0]
    ce_mesh = r0["eval"]["ce"]
    out = {"phase": "train_mesh", "gpu": gpu, "arch": cfg.name,
           "mesh": TRAIN_MESH, "transport": r0["transport"],
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatch": 2,
           "steps": TRAIN_MESH_STEPS, "deterministic": True,
           "ranks_s": ranks_s, "restore_s": restore_s,
           "restore_extra": extra, "unsharded_step0_loss": step0,
           "dp_step0_rel": abs(r0["dp"]["losses"][0] - step0) / step0,
           "unsharded_losses": train["losses"][:TRAIN_MESH_STEPS],
           "fsdp_bit_equal_to_dp": [r["fsdp_bit_equal_to_dp"]
                                    for r in ranks],
           "checkpoint_bit_equal": [r["digest"] == digest for r in ranks],
           "eval_ce_unsharded_einsum": ces["einsum"],
           "eval_ce_unsharded_flash": ces["flash"],
           "eval_ce_mesh_vs_einsum_rel": abs(ce_mesh - ces["einsum"])
           / ces["einsum"],
           "eval_ce_mesh_vs_flash_rel": abs(ce_mesh - ces["flash"])
           / ces["flash"],
           "eval_fused_per_pass": TRAIN_FUSED_PER_PASS,
           "peak_mem_gb": {m: [r[m]["peak_mem_gb"] for r in ranks]
                           for m in ("dp", "fsdp")},
           "fsdp_peak_below_dp": [r["fsdp"]["peak_mem_gb"]
                                  < r["dp"]["peak_mem_gb"] for r in ranks],
           "fsdp_collectives_per_step": [
               r["fsdp"]["fsdp_collectives_per_step"] for r in ranks],
           "fsdp_planned_per_step": r0["fsdp"]["fsdp_planned_per_step"],
           "gathered_max_bytes": [r["fsdp"]["gathered_max_bytes"]
                                  for r in ranks],
           "seq": {"mesh": TRAIN_SEQ_MESH, "ranks_s": seq_s,
                   "step0_rel": abs(seq_ranks[0]["losses"][0] - step0)
                   / step0,
                   "params_adam_bytes": [r["params_adam_bytes"]
                                         for r in seq_ranks],
                   "peak_mem_gb": [r["peak_mem_gb"] for r in seq_ranks],
                   "step_walls_s": [r["step_walls_s"] for r in seq_ranks],
                   "model_all_gathers_per_step": [
                       r["model_all_gathers_per_step"] for r in seq_ranks],
                   "model_all_gather_bytes_per_step": [
                       r["model_all_gather_bytes_per_step"]
                       for r in seq_ranks],
                   "expert_bank_gathers": [r["expert_bank_gathers"]
                                           for r in seq_ranks],
                   "pr30_peak_mem_gb": 6.94,
                   "pr30_step_walls_s": [9.54, 13.15],
                   "dp_params_adam_bytes": r0["dp"]["params_adam_bytes"],
                   "dp_peak_mem_gb": r0["dp"]["peak_mem_gb"]},
           "mamba2": {"mesh": TRAIN_SEQ_MESH, "R": MAMBA_TRAIN_RB[0],
                      "T": MAMBA_TRAIN_RB[1], "batch": MAMBA_TRAIN_BATCH,
                      "seq": TRAIN_SEQ, "microbatch": 2,
                      "dtype": MAMBA_TRAIN_DTYPE,
                      "unsharded": dict(mamba, ssd_heads=whole_heads),
                      "unsharded_s": mamba_s, "ranks": pieces,
                      "unsharded_order_floor_ssm_rel_l2":
                      spread["order_floor"],
                      "bf16_unsharded_vs_float32_ssm_rel_l2": spread["bf16"],
                      "ssd_planned_per_rank": ssd_planned,
                      "rank_heads": heads}}
    for r in ranks:
        r.pop("digest")
        emit({"phase": "train_mesh_rank", "gpu": gpu, **r})
    for r in seq_ranks:
        emit({"phase": "train_seq_rank", "gpu": gpu, **r})
    emit(out)
    bad = []
    if not all(out["fsdp_bit_equal_to_dp"]):
        bad.append("the FSDP run differs from the DP run")
    if not out["dp_step0_rel"] <= TRAIN_MESH_TOL:
        bad.append(f"DP step 0 {r0['dp']['losses'][0]} vs unsharded "
                   f"{step0}")
    if not out["seq"]["step0_rel"] <= TRAIN_MESH_TOL:
        bad.append(f"1x2 seq step 0 {seq_ranks[0]['losses'][0]} vs "
                   f"unsharded {step0}")
    if not all(r["losses"] == seq_ranks[0]["losses"]
               and r["leaves_model_cut"] > 0 and not r["expert_bank_gathers"]
               and r["model_all_gathers_per_step"] > 0
               and np.isfinite(r["losses"]).all() for r in seq_ranks):
        bad.append(f"1x2 seq ranks {seq_ranks}")
    if not all(out["checkpoint_bit_equal"]):
        bad.append("the restored checkpoint differs from the ranks'")
    for p in pieces:
        if not (p["loss_rel"] <= TRAIN_MESH_TOL
                and p["worst_ssm_rel_l2"] <= SHARD_SPLIT_TOL
                and p["ssd_launches"] == ssd_planned > 0
                and p["ssd_heads"] == [heads]):
            bad.append(f"mamba2 1x2 rank {p}")
    if not (whole_heads == [2 * heads] and mamba["ssd_launches"] > 0
            and np.isfinite(mamba["loss"])):
        bad.append(f"mamba2 unsharded step {mamba}")
    if not all(out["fsdp_peak_below_dp"]):
        bad.append(f"FSDP peak not below DP's: {out['peak_mem_gb']}")
    for r in ranks:
        dp, fs = r["dp"], r["fsdp"]
        if not (fs["fsdp_collectives_per_step"]
                == fs["fsdp_planned_per_step"]
                and fs["gathered_blocks_max"] == 1
                and fs["gathered_left_bytes"] == 0
                and dp["gathered_max_bytes"] == 0
                and not any(dp["fsdp_collectives_per_step"].values())):
            bad.append(f"rank {r['rank']} FSDP gathers: {fs}")
    if not out["eval_ce_mesh_vs_einsum_rel"] <= TRAIN_MESH_TOL:
        bad.append(f"mesh CE {ce_mesh} vs unsharded {ces['einsum']}")
    for r in ranks:
        ev = r["eval"]
        calls = ev["calls_vs_plain"].get("photonic_mvm_fused", {})
        if not (ev["fused_launches"] == TRAIN_FUSED_PER_PASS
                and calls.get("calls") == TRAIN_FUSED_PER_PASS
                and calls.get("max_rel_l2", 1.0) <= MVM_TOL
                and ev["flash_launches"] == 0):
            bad.append(f"rank {r['rank']} eval launches {ev}")
        if not all(np.isfinite(r["dp"]["losses"] + r["fsdp"]["losses"]
                               + [ev["ce"]])):
            bad.append(f"rank {r['rank']}: a loss is not finite")
    if bad:
        raise AssertionError(f"train_mesh: {bad}")
    return out


# -------------------------------------------------------------------------
# phase 3q: the dry-run held to this run's measurements (slice 17)
# -------------------------------------------------------------------------
DRYRUN_MEM_RATIO = (0.75, 1.33)   # dry-run per-device GB / the card's peak
H100_BF16_FLOPS = 989e12


def planned_calls(cfg, kind: str, rows: int, seq: int, mesh: str = "1x1",
                  with_ops: bool = False, act_mode: str = "replicated"):
    """The kernels' planned calls of one pass (``kind`` "prefill" of
    ``rows`` x ``seq`` tokens, or "decode" of ``rows`` tokens over ``seq``
    cached positions) of ``cfg``'s step on rank 0 of a ``mesh`` census
    mesh: the dry-run's step walked on meta tensors, without its census.
    ``with_ops``: also the planned operations per kernel; ``act_mode``: the
    residual's placement (``dryrun.rank_step``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import planned
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    run, _ = dryrun.rank_step(cfg, ShapeConfig(kind, seq, rows, kind),
                              mesh_lib.census_mesh(mesh), act_mode=act_mode)
    before, ops0 = planned.snapshot(), dict(planned.ops)
    run()
    calls = {k: v - before[k] for k, v in planned.snapshot().items()}
    if not with_ops:
        return calls
    return calls, {k: v - ops0[k] for k, v in planned.ops.items()}


def dryrun_phase(gpu, measured, train):
    """``repro_torch.launch.dryrun`` on the host, held to this run's
    measurements: the planned calls of one pass of the fused path's model
    (minitron-4b R&B, a 600-token prefill and a decode step, as ``serve``
    counted them outside its window), of the MoE path's (granite R&B with
    blended experts: resident calls a pass against ``serve_moe``'s
    launches over its passes) and of the SSM path's (mamba2 R&B:
    ``ssd_chunk`` calls a prefill pass and fused calls a prefill and a
    decode pass against ``serve_ssm``'s) and, since slice 20, of the
    "seq" prefill of ``sharded``'s 1x2 minitron rank (4 x 600, rank 0 of
    a 1x2 census mesh) against its counted launches, exactly; then
    ``train``'s cell
    (granite R&B, xla, 8 x 1024 in 2 microbatches, remat) walked with the
    census: its ``per_device_total_gb`` within ``DRYRUN_MEM_RATIO`` of the
    phase's ``max_memory_allocated``.  Reported: the train step's MFU
    (``model_flops`` / median step wall / the bf16 peak) and the analytic
    against the census FLOPs.  No kernel launches (the launch counters do
    not move)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import counts
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    launches = counts.snapshot()
    mini = dataclasses.replace(get_arch("minitron-4b", reuse=True),
                               execution="photonic")
    granite = get_arch("granite-moe-1b-a400m", reuse=True)
    granite = dataclasses.replace(granite, execution="photonic",
                                  moe=dataclasses.replace(
                                      granite.moe, num_basic_experts=8))
    mamba = dataclasses.replace(get_arch("mamba2-780m", reuse=True),
                                execution="photonic")
    mini_pre = planned_calls(mini, "prefill", 1, 600)
    mini_dec = planned_calls(mini, "decode", 1, 616)
    mini_seq = planned_calls(mini, "prefill", SHARD_ROWS, SHARD_PROMPT,
                             mesh="1x2", act_mode="seq")
    moe_dec = planned_calls(granite, "decode", 1, 616)
    ssm_pre = planned_calls(mamba, "prefill", 1, 600)
    ssm_dec = planned_calls(mamba, "decode", 1, 616)
    fused = measured["fused"]
    ssm = measured["ssm"]
    calls = {
        "minitron_fused_per_prefill": (mini_pre["photonic_mvm_fused"],
                                       fused["prefill"]["photonic_mvm_fused"]),
        "minitron_flash_per_prefill": (mini_pre["flash_attention"],
                                       fused["prefill"]["flash_attention"]),
        "minitron_fused_per_decode": (mini_dec["photonic_mvm_fused"],
                                      fused["decode"]["photonic_mvm_fused"]),
        "granite_resident_per_pass": (moe_dec["photonic_mvm_resident"],
                                      measured["resident_per_pass"]),
        "mamba2_ssd_per_prefill": (ssm_pre["ssd_chunk"],
                                   ssm["ssd_per_prefill"]),
        "mamba2_fused_per_prefill": (ssm_pre["photonic_mvm_fused"],
                                     ssm["fused_per_prefill"]),
        "mamba2_fused_per_decode": (ssm_dec["photonic_mvm_fused"],
                                    ssm["fused_per_decode"]),
        "minitron_decode_attention_per_decode": (
            mini_dec["decode_attention"], fused["decode"]["decode_attention"]),
        "minitron_1x2_seq_fused_per_prefill": (
            mini_seq["photonic_mvm_fused"], measured["seq_prefill_fused"]),
    }
    calls_s = time.perf_counter() - t0

    cfg = get_arch(TRAIN_ARCH, reuse=True)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t1 = time.perf_counter()
    cell = dryrun.walk(cfg, shape, "1x1", microbatch=2)
    walk_s = time.perf_counter() - t1
    gb = cell["memory"]["per_device_total_gb"]
    ratio = gb / train["peak_mem_gb"]
    wall = train["step_wall_median_after_first_s"]
    flops = dryrun.model_flops(cfg, shape)
    a = cell["analytic"]
    analytic = a["matmul_flops"] + a["context_flops"] + a["overhead_flops"]
    out = {"phase": "dryrun", "gpu": gpu,
           "calls_planned_vs_measured": calls,
           "train_cell": {"arch": cfg.name, "batch": TRAIN_BATCH,
                          "seq": TRAIN_SEQ, "microbatch": 2,
                          "memory": cell["memory"],
                          "card_peak_mem_gb": train["peak_mem_gb"],
                          "mem_ratio": ratio, "census_ops": cell["census_ops"],
                          "census_flops": cell["census_flops"],
                          "analytic_flops": analytic,
                          "analytic_over_census_flops":
                              analytic / cell["census_flops"],
                          "model_flops": flops,
                          "step_wall_median_s": wall,
                          "mfu": flops / wall / H100_BF16_FLOPS,
                          "roofline": cell["roofline"]},
           "calls_walk_s": calls_s, "train_walk_s": walk_s,
           "wall_s": time.perf_counter() - t0}
    emit(out)
    bad = [k for k, (p, m) in calls.items() if p != m]
    if bad:
        raise AssertionError(f"dry-run planned calls differ from the "
                             f"measured launches: {bad} {calls}")
    if not DRYRUN_MEM_RATIO[0] <= ratio <= DRYRUN_MEM_RATIO[1]:
        raise AssertionError(f"dry-run memory {gb} GB against the card's "
                             f"{train['peak_mem_gb']} GB: ratio {ratio}")
    if counts.snapshot() != launches:
        raise AssertionError("a kernel launched during the dry-run")
    return out


# -------------------------------------------------------------------------
# phase 3n: the paper's own models, PTQ and tables
# -------------------------------------------------------------------------
PAPER_TOL = 1e-4            # card vs CPU: forwards, params after 3 steps
PAPER_LOSS_TOL = 1e-5       # card vs CPU: each of the 3 losses, relative
TABLE3_DELAY_TOL, TABLE3_ENERGY_TOL = 1e-3, 5e-3   # tests/test_core.py's
TABLE3_LATENCY = (0.567, 0.01)                     # gates on Table 3


def conv_flops(pm, cfg) -> int:
    """Multiply-adds x 2 of one 32x32 image through VGG-13 or ResNet-18
    (convolutions at their SAME output sizes, and the head)."""
    flops, size, cin = 0, 32, 3
    if isinstance(cfg, pm.VGGConfig):
        for item in pm.VGG13_PLAN:
            if item == "M":
                size //= 2
                continue
            flops += 2 * size * size * 9 * cin * item
            cin = item
        return flops + 2 * 512 * cfg.classes
    flops += 2 * size * size * 9 * 3 * 64
    cin = 64
    for cout, blocks, stride in pm.RESNET18_STAGES:
        size = -(-size // stride)
        flops += 2 * size * size * 9 * (cin + cout) * cout     # block 0
        if stride != 1 or cin != cout:
            flops += 2 * size * size * cin * cout              # projection
        flops += (blocks - 1) * 2 * (2 * size * size * 9 * cout * cout)
        cin = cout
    return flops + 2 * 512 * cfg.classes


def paper_phase(torch, gpu):
    """The paper's own models (``repro_torch.models.paper_models``), W8A8
    PTQ and the runner of its tables (``repro_torch.paper_run``), on the
    card.  Tables 2, 3 and Fig. 1 from the port's cost model, Table 3 held
    to the paper at ``tests/test_core.py``'s gates; Tables 4 and 5 at the
    reference's full setting (120 steps of batch 64, 4 eval batches of 256:
    2 MLPs and 3 Mixers, then 5 Mixers, all trained on the card), every
    loss finite and the params and energy columns equal to the same
    functions on the CPU (accuracies reported, not gated: a synthetic task
    and random weights); three ``train_classifier`` steps of the MLP 1x6
    and the Mixer 2x4 on the card against the CPU; VGG-13 and ResNet-18,
    shared and not, forward at batch 8 against the CPU and timed at batch
    256; a Mixer 2x4 trained on the card (its step walls) and quantized
    W8A8, int8 leaves and scales bit for bit those of its CPU copy, as is
    the serving path's A8 scale of each leaf in float32 and bf16, with the
    dequantized model's accuracy beside the float one.  No port kernel
    runs here: the models multiply through ``obu.blend_dot`` (cuBLAS) and
    convolve through cuDNN, float32 with TF32 off (``main``)."""
    from repro_torch import paper_run, vision_task
    from repro_torch.core import photonic
    from repro_torch.core.sharing import tree_leaves, tree_map
    from repro_torch.models import paper_models as pm
    from repro_torch.quant import w8a8

    # ---- Tables 2, 3 and Fig. 1: the cost model ----
    t2, t3, f1 = (paper_run.bench_table2(), paper_run.bench_table3(),
                  paper_run.bench_fig1())
    bad = []
    for det in t3.details:
        d_no, e_no, d_re, e_re = det["paper"]
        for got, want, tol in ((det["delay_no_reuse_ns"], d_no,
                                TABLE3_DELAY_TOL),
                               (det["delay_reuse_ns"], d_re,
                                TABLE3_DELAY_TOL),
                               (det["energy_no_reuse_uJ"], e_no,
                                TABLE3_ENERGY_TOL),
                               (det["energy_reuse_uJ"], e_re,
                                TABLE3_ENERGY_TOL)):
            if abs(got - want) / want > tol:
                bad.append((det["tile"], got, want))
    latency = t3.details[-1]["latency_saving"]
    for b in (t2, t3, f1):
        emit({"paper": b.name, "row": b.row()})
    if bad or abs(latency - TABLE3_LATENCY[0]) > TABLE3_LATENCY[1]:
        raise AssertionError(f"Table 3 off the paper: {bad}, latency "
                             f"saving {latency}")

    # ---- Tables 4 and 5, trained on the card ----
    out = {"paper": "tables", "gpu": gpu}
    t = time.perf_counter()
    t4 = paper_run.bench_table4(device="cuda")
    torch.cuda.synchronize()
    out["table4_s"] = time.perf_counter() - t
    t = time.perf_counter()
    t5 = paper_run.bench_table5(device="cuda")
    torch.cuda.synchronize()
    out["table5_s"] = time.perf_counter() - t
    wrong = []
    for (model, arc, cfg), row in zip(paper_run.table4_variants(),
                                      t4.details):
        p, sh, _ = paper_run.build(cfg, device="cpu")
        if (row["params_M"], row["energy_uJ"]) != paper_run.cost_columns(
                cfg, p, sh) or row.get("losses_finite") is False:
            wrong.append(row)
        emit({"paper": "table4", **row})
    for (tag, rc), row in zip(paper_run.table5_variants(), t5.details):
        p, _, _ = paper_run.build(pm.MixerConfig(blocks=8, reuse=rc),
                                  device="cpu")
        if row["params"] != pm.param_count(p) or not row["losses_finite"]:
            wrong.append(row)
        emit({"paper": "table5", **row})
    trained = [r for r in t4.details if r["acc_proxy"] is not None]
    out.update({"table4_row": t4.row(), "table5_row": t5.row(),
                "trained": len(trained) + len(t5.details)})
    emit(out)
    if wrong or len(trained) != 5 or len(t5.details) != 5:
        raise AssertionError(f"Tables 4/5 on the card: {wrong}")

    # ---- three train steps, card against CPU ----
    variants = {f"{m} {a}": cfg for m, a, cfg in paper_run.table4_variants()}
    steps = {}
    for name in ("MLP layer-wise 1x6", "MLP-Mixer block-wise 2x4"):
        runs = {}
        for dev in ("cuda", "cpu"):
            p, _, fwd = paper_run.build(variants[name], device=dev)
            losses = []
            p3, _ = vision_task.train_classifier(
                fwd, p, steps=3, batch_size=64, eval_batches=1, device=dev,
                losses=losses)
            runs[dev] = (p3, losses)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][1],
                                                           runs["cpu"][1]))
        steps[name] = {"params_rel_l2": max(tree_leaves(tree_map(
            lambda a, b: rel_l2(a.cpu(), b), runs["cuda"][0],
            runs["cpu"][0]))),
                       "loss_rel": loss_rel, "losses": runs["cuda"][1]}
    emit({"paper": "train_steps_card_vs_cpu", "steps": 3, "batch": 64,
          **steps})
    if any(v["params_rel_l2"] > PAPER_TOL or v["loss_rel"] > PAPER_LOSS_TOL
           for v in steps.values()):
        raise AssertionError(f"3 train steps, card vs CPU: {steps}")

    # ---- VGG-13 and ResNet-18: card against CPU, images/s ----
    timer = Timer(torch)
    task = vision_task.make_task(device="cpu")
    x8 = task(20_000, 8)[0]
    x256 = task(20_001, 256)[0].cuda()
    convs = []
    for model, arc, cfg in paper_run.table4_variants():
        if model not in ("VGG-13", "ResNet-18"):
            continue
        fwd = pm.vgg13_forward if model == "VGG-13" else pm.resnet18_forward
        p, _, _ = paper_run.build(cfg, device="cpu")
        pc = pm.to_device(p, "cuda")
        with torch.no_grad():
            err = rel_l2(fwd(pc, cfg, x8.cuda()).cpu(), fwd(p, cfg, x8))
            ms = timer.ms(lambda: fwd(pc, cfg, x256), 10)
        flops = conv_flops(pm, cfg) * 256
        convs.append({"model": model, "arc": arc,
                      "params": pm.param_count(p),
            "card_vs_cpu_rel_l2": err, "batch": 256, "ms": ms,
            "images_per_s": 256 / ms * 1e3, "gflop": flops / 1e9,
            "fp32_bound_ms": flops / FP32_FLOPS * 1e3})
    del timer
    emit({"paper": "conv_forwards", "rows": convs})
    if any(c["card_vs_cpu_rel_l2"] > PAPER_TOL for c in convs):
        raise AssertionError(f"conv forwards, card vs CPU: {convs}")

    # ---- a Mixer 2x4 trained on the card, quantized W8A8 ----
    p, _, fwd = paper_run.build(variants["MLP-Mixer block-wise 2x4"],
                                device="cuda")
    walls, losses = [], []
    with timed_calls(vision_task, "train_step", walls):
        pt, acc = vision_task.train_classifier(fwd, p, steps=120,
                                               batch_size=64, device="cuda",
                                               losses=losses)
    q, s = w8a8.quantize_params(pt)
    ptc = pm.to_device(pt, "cpu")
    qc, sc = w8a8.quantize_params(ptc)
    bits = all(tree_leaves(tree_map(
        lambda a, b: a is b if a is None else (
            a.dtype == b.dtype and torch.equal(a.cpu(), b)), (q, s), (qc, sc))))
    # the serving path's A8 scale, per tensor, in float32 and bf16: the
    # card's must equal the CPU's bit for bit, as the W8 scales above do
    a8 = all(torch.equal(photonic.a8_scale(a.to(dt)).cpu(),
                         photonic.a8_scale(b.to(dt)))
             for a, b in zip(tree_leaves(pt), tree_leaves(ptc))
             for dt in (torch.float32, torch.bfloat16))
    acc_dq = vision_task.accuracy(fwd, w8a8.dequantize_params(q, s),
                                  vision_task.make_task(device="cuda"))
    ptq = {"paper": "w8a8_mixer_2x4", "gpu": gpu,
           "step_wall_ms_median": statistics.median(walls[1:]) * 1e3,
           "step_wall_ms_first": walls[0] * 1e3, "steps": len(walls),
           "loss_first": losses[0], "loss_last": losses[-1],
           "acc_float": acc, "acc_w8a8": acc_dq,
           "quantization_error": w8a8.quantization_error(pt),
           "model_bytes_w8a8": w8a8.model_bytes(q),
           "model_bytes_float": w8a8.model_bytes(pt),
           "int8_and_scales_bit_equal_to_cpu": bits,
           "a8_scales_bit_equal_to_cpu": a8}
    emit(ptq)
    if not (bits and a8 and all(map(np.isfinite, losses)) and len(walls) == 120):
        raise AssertionError(f"W8A8 on the card-trained Mixer: {ptq}")


# -------------------------------------------------------------------------
def summary(name, rows, launches, at, source, replaces):
    """One kernel's entry: errors are maxima over every case (``worst_at``
    names the case of the largest rel-L2); times are those of case ``at``
    (with its ``backward_ms`` where the kernel has a backward)."""
    rep = next(r for r in rows if r["case"] == at)
    worst = max(rows, key=lambda r: r["rel_l2"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_l2": worst["rel_l2"], "worst_at": worst["case"],
            "at": at, "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            **{k: rep[k] for k in ("backward_ms",) if k in rep}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import photonic
    from repro_torch.kernels import blend
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import photonic_mvm as pm
    from repro_torch.kernels import ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    per_kernel = ops.build_kernels()
    emit({"gpu": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "build_s_per_kernel":
          per_kernel})

    seconds = {}

    def timed(name, fn, *args):
        """Run one phase after freeing what the last one left; its wall
        time goes into the ``phase_seconds`` line."""
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timer = Timer(torch)
    mvm_rows = timed("check_mvm", check_mvm, torch, timer, pm, photonic)
    flash_rows = timed("check_flash", check_flash, torch, timer, fa)
    split_rows = timed("check_split", check_split, torch, timer, pm,
                       photonic, ops)
    blend_rows = timed("check_blend", check_blend, torch, timer, blend)
    resident_rows = timed("check_resident", check_resident, torch, timer, pm,
                          photonic)
    ssd_rows = timed("check_ssd", check_ssd, torch, timer, ssd)
    da_rows = timed("check_decode_attention", check_decode_attention, torch,
                    timer, da)
    del timer
    # each path's launches are counted in its own window
    fused_path, fused_measured = timed("serve", serve, torch, smi)
    timed("serve_launcher", serve_launcher, torch, smi)
    sharded = timed("sharded", sharded_phase, torch, smi)
    torch.cuda.reset_peak_memory_stats()
    fault_path = timed("serve_noisy", serve_noisy, torch, smi)
    timed("small_model_fault_checks", small_model_fault_checks, torch)
    moe_path, moe_passes = timed("serve_moe", serve_moe, torch, smi)
    timed("small_moe_check", small_moe_check, torch)
    ssm_path, ssm_measured = timed("serve_ssm", serve_ssm, torch, pm, smi)
    timed("small_ssm_checks", small_ssm_checks, torch)
    timed("serve_mla", serve_mla, torch, smi)
    timed("small_mla_check", small_mla_check, torch)
    timed("serve_vlm", serve_memory, torch, smi, "llama-3.2-vision-11b",
          VLM_FUSED_PER_PASS, 11)
    timed("serve_audio", serve_memory, torch, smi, "whisper-medium",
          AUDIO_FUSED_PER_PASS, 12)
    timed("small_memory_checks", small_memory_checks, torch)
    train = timed("train", train_phase, torch, smi)
    timed("train_mesh", train_mesh_phase, torch, smi, train)
    timed("dryrun", dryrun_phase, smi, {
        "fused": fused_measured,
        "resident_per_pass": moe_path["photonic_mvm_resident"] / moe_passes,
        "ssm": dict(ssm_measured, ssd_per_prefill=ssm_path["ssd_chunk"]
                    / ssm_measured["prefill_passes"]),
        "seq_prefill_fused": sharded["act_modes_1x2"][0]["seq"][
            "fused_launches"]}, train)
    timed("paper", paper_phase, torch, smi)
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t0})

    split = "src/repro_torch/csrc/photonic_mvm_split.cu"
    emit({"kernels": [
        summary("photonic_mvm_fused", mvm_rows,
                fused_path["photonic_mvm_fused"],
                "M=4 w_gate+silu 3072->9216",
                "src/repro_torch/csrc/photonic_mvm_fused.cu",
                "src/repro/kernels/photonic_mvm.py:432"),
        summary("flash_attention", flash_rows,
                fused_path["flash_attention"], "B=1 Sq=L=2048 causal",
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:114"),
        summary("photonic_mvm", [r for r in split_rows
                                 if r["kernel"] == "photonic_mvm"],
                fault_path["photonic_mvm"], "M=4 3072->9216", split,
                "src/repro/kernels/photonic_mvm.py:157"),
        summary("photonic_mvm_t", [r for r in split_rows
                                   if r["kernel"] == "photonic_mvm_t"],
                fault_path["photonic_mvm_t"], "M=4 3072->9216 ^T", split,
                "src/repro/kernels/photonic_mvm.py:191"),
        summary("blend_shuffle", blend_rows, fault_path["blend_shuffle"],
                "M=4 C=3072 block=128 none",
                "src/repro_torch/csrc/blend_shuffle.cu",
                "src/repro/kernels/blend.py:33"),
        summary("photonic_mvm_resident", resident_rows,
                moe_path["photonic_mvm_resident"], "T=4 M=8 1024->512",
                "src/repro_torch/csrc/photonic_mvm_resident.cu",
                "src/repro/kernels/photonic_mvm.py:231"),
        summary("ssd_chunk", ssd_rows, ssm_path["ssd_chunk"],
                "b=1 nc=8 L=256 H=48 P=64 N=128 stride-0 B/C",
                "src/repro_torch/csrc/ssd_chunk.cu",
                "src/repro/kernels/ssd.py:51"),
        summary("decode_attention", da_rows, fused_path["decode_attention"],
                decode_attention_cases()[0][0],
                "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/models/attention.py:202 (the einsum "
                "_attend_decode; no Pallas kernel)")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
