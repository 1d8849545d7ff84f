#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`crvqa_tpu_torch`) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py              # one CUDA card; exits non-zero on any failure
    python3 chip_smoke.py --json out.json  # ... and every number into out.json
    python3 chip_smoke.py --rehearse   # CPU, tiny widths, plain versions: a
                                       # dry run of the control flow, never a result

Phases (each one's seconds are logged):
  1. device   the card's name, count and power limit; TF32 off for matmuls
              and cuDNN (fp32 comparisons are full fp32).
  2. build    every CUDA source under crvqa_tpu_torch/csrc, the native
              feature store and WordPiece encoder, compiled from the
              checkout, all at once; each
              kernel instantiation's registers, shared memory and spills
              (`-Xptxas -v`), its tensor-core instructions (HMMA, and
              HGMMA for `wgmma`) and TMA loads (UTMALDG), from `cuobjdump
              -sass`; every `wgmma_gemm_kernel` and the
              `head_compact_kernel` have HGMMA and UTMALDG.
  3. kernel   the primal short attention kernel against its plain PyTorch
              version at the LXMERT serving shapes (batch 32 and 256; every
              (Sq, Sk) LXMERT gives it), at VisualBERT's single stream
              (50,50) (batch 32) and at mPLUG's (25,25) and (1,1)
              (batch 8), fp32 and bf16; bf16 also at (1,1) and (85,85)
              (batch 32) and at stage 3's 6 compacted heads (the LXMERT
              shapes, batch 64); then timed: the kernel, the plain
              version and one PyTorch library call computing the same
              function (a yardstick the port never calls).
  4. midseq-kernel  the mid-length attention kernel against its plain
              version at mPLUG's five shapes ((577,577) ViT, (25,577)
              fusion cross, (602,602) stride joint, (1,602) and (120,602)
              rank), batch 8 and 32, fp32 and bf16, dropout 0 and 0.1;
              timed at rate 0 beside the plain version and
              `scaled_dot_product_attention` with a float mask.
  5. train-kernels  the forward-for-grad and both backward kernels (stored,
              recompute) against their plain versions at batch 256, the four
              (Sq, Sk) and VisualBERT's (50,50), fp32 and bf16, dropout
              rates 0 and 0.1 (at (50,50) also the keep mask each kernel
              applies, read out through one-hot v and g, bit-exact, and the
              p the recompute backward rebuilds in 48-key chunks bit-equal
              to the forward's residual in bf16), and at batch
              64 (stages 1 and 3), bf16, rate 0.1, at the four (Sq, Sk),
              (1,1) and (85,85), and at 6 heads; bf16 stored and recompute
              gradients bit-identical; timed beside the plain versions and
              `scaled_dot_product_attention` forward and forward + backward
              under autograd.
 5a. offset-kernels  the training attention kernels with the runtime's
              keep-mask offsets (row0 = the first global row of data rank 1
              of 2, head0 = 6, the first head of tensor-parallel rank 1 of
              2, 6 heads a rank), batch 8, fp32 and bf16, rate 0.1: the
              short kernels at the four (Sq, Sk) and (50,50), the
              mid-length ones at mPLUG's training shapes; keep masks read
              out through one-hot v (the mid-length ones for the first 64
              keys) and held to the plain `keep_mask` of those global rows
              and heads bit for bit, outputs and gradients to the plain
              versions with the same offsets at phases 5 and 11's
              tolerances.
  6. serve    `crvqa_tpu_torch.cli.serve_vqa.main` at full LXMERT width
              (768 hidden, 12x64 heads, 9/5/5 layers, 2274 answers) on
              seeded weights and fabricated data: 512 requests at batch 32 in
              bf16 (the default) and fp32, through a stage-2 mask.pt and
              classifier4masker.bin. Counts every kernel launch of the
              served run, checks no response carries an error, and holds
              the fp32 answers and logits against the same model with the
              plain attention swapped in.
  7. profile  device time by kernel of one bf16 LXMERT forward at batch 32.
  8. mplug-serve  `crvqa_tpu_torch.cli.serve_mplug.build_server` and the
              serve loop at the full width of `MPlugConfig()` (ViT-B-16 at
              384 px, BERT 768 x 12 heads, 6 text / 6 fusion (stride 3) / 12
              decoder layers, vocab 30522) on seeded weights in `--mode
              mask` (zero rate 0.5, magnitude_soft): 128 requests over
              fabricated uint8 images and a 30522-line vocab, beam 5 at
              batch 8 and 32 in bf16, rank (k_test 10 over 3129 fabricated
              answers) at batch 8 in bf16, and beam at batch 8 in fp32 and
              bf16 with the plain attentions swapped in. Checks zero error
              responses, 18 mid-length and 11 short launches per encoded
              batch (42 and 23 when ranking), string answers, fp32 answers
              equal to the plain attentions' and the fp32 fused memory and
              first decode step's logits within tolerance of them; profiles
              one bf16 batch-8 beam request batch (device time by kernel,
              idle share).
  9. train    `crvqa_tpu_torch.cli.prune_debias_vqa.main` at full width,
              batch 256, bf16, the canonical configuration (compression
              0.3/0.3/0.3 at zero rate 0.7, magnitude init, LMH loss,
              MaskedLinear1) on fabricated VQA-CP train/test files: 24 steps
              with threshold resets, an eval, an export and a checkpoint.
              Checks finite losses, the launch counts per step and per eval
              batch, the zero rates, and serves the exported mask.pt and
              classifier4masker.bin with serve_vqa. Then 8 steps with the
              recompute backward (`BWD_IMPL = "recompute"`).
 10. step     examples per second over timed train steps (synchronised,
              after warm-up), device time by kernel of one step (profile),
              and one full-width fp32 step with dropout on through the
              kernels against the same step through the plain versions from
              the same generators.
 11. midseq-bwd-kernel  the mid-length recompute backward against its plain
              version at mPLUG's training shapes ((577,577) ViT, (25,577)
              fusion cross, (602,602) stride joint, (40,602) decoder cross
              of 5 answers x 8 tokens), batch 16, fp32 and bf16, dropout 0
              and 0.1; dq, dk, dv of two launches bit-identical; timed at
              rate 0.1 beside the plain version, `scaled_dot_product_
              attention` forward + backward, the forward kernel and
              `scaled_dot_product_attention` forward under autograd.
 12. mplug-train  `crvqa_tpu_torch.cli.vqa_mplug.main` at the full width of
              `MPlugConfig()`, bf16, `--mode mask` (zero rate 0.5 from
              `--init_sparsity` 0.3), `--synthetic 64 --synthetic_shapes
              25,8,5`, batch 16: 8 steps with four threshold resets, a
              checkpoint, beam evaluation of 4 batches and the exports; a
              resume from the checkpoint for 4 more steps;
              `serve_mplug --ckpt` on what it wrote (32 requests); 2 steps
              each of `--mode full` and `--distill true`. Checks finite
              losses, the launches per step (30 mid-length forward, 29
              backward, 11 short forward-for-grad, 11 short backward; full
              mode 30 backward; distill 30 + 11 more forward) and per eval
              batch (18 + 11), and the zero rate on target after each reset.
 13. mplug-step  3 warm-up and 10 timed mask-training steps on one batch
              kept on the card (examples per second), device time by kernel
              category and the idle share of two profiled steps, and one
              fp32 step at batch 8 with dropout on through the kernels
              against the same step through the plain attentions.
 14. masked-matmul-kernel  the three masked-matmul kernels (forward, dx,
              STE ds: the operand pass, then the TMA + wgmma product)
              through `masked_matmul` under autograd against their plain
              versions at (M, K, N) = (9216, 768, 768), (4096, 768, 3072)
              and (1000, 700, 300) and at three edge shapes around the
              tiles, x and w each bf16 or fp32, scores on and one step above
              the threshold; zero gradients for w and the threshold; ds
              bit-identical across two calls and with a bf16 or an fp32
              cotangent; the operand pass bit-equal to its plain version;
              the profiler's kernel names and counts of one autograd run;
              timed beside the plain versions and cuBLAS on x @ (w * (s >
              t)), alone and forward + backward, ds with an fp32 and a bf16
              cotangent.
 15. head-compact-kernel  the head-compact kernel (the TMA + wgmma
              product in head mode, its zero blocks, and for fp32 operands
              the operand pass) at x [9216, 768], 12 heads of 64 with 4
              kept, padded with sentinels, and all masked, bf16 and fp32,
              and with 1, 6 and 12 kept in bf16, against its plain
              version; masked columns exactly 0, the bits repeated by a
              second call; timed (bf16 at 1, 4, 6, 12 kept, fp32 at 4)
              beside the gather + cuBLAS + scatter op and cuBLAS on w *
              mask; the profiler's kernel names of one bf16 and one fp32
              call.
 16. stage1   `crvqa_tpu_torch.cli.run_vqa_stage1.main` at full LXMERT width,
              batch 64, bf16, LMH loss, 512 synthetic examples: 8 steps, a
              checkpoint, an eval and the .bin with its .msgpack twin (the
              JAX package's params file), the final eval; 34 forward-
              for-grad and 32 stored-backward launches per step, 34 per eval
              batch; the twin read by `load_params_any` bit-equal to the
              .bin over every parameter and written again to the same
              bytes (its size, read and write seconds); timed steps; one
              fp32 step through the kernels against the plain attentions.
 17. stage3   `crvqa_tpu_torch.cli.run_vqa_stage3.main` from that .bin,
              batch 64, bf16, 4 steps and an eval each: (a) FT_trainedMask
              with phase train's mask.pt and classifier4masker.bin (audited
              zero rate 0.7), (b) FT_randMask over the reference scope, (c)
              seeded head and FFN .npy masks at zero rate 0.5, compacting the
              language layers to 6 heads (the short kernel at H = 6) and FFN
              1536; masked weights exactly 0 after the steps; each run's
              .bin and .msgpack written; (a)'s
              `<label4save>_FT_trainedMask.bin.msgpack` served with
              `serve_vqa --ckpt` (128 requests at batch 32 over phase
              serve's files, bf16 and fp32, zero error responses, 34 primal
              launches a forward, fp32 answers identical to serving (a)'s
              .bin); timed steps of (a) and (c).
 18. visualbert-train  `crvqa_tpu_torch.cli.prune_debias_vqa_visualbert.main`
              at the full width of `VisualBertConfig()` (768 hidden, 12
              layers of 12x64 heads, FFN 3072, 2048-d visual features, 2274
              answers), batch 256, bf16, LMH loss, uniform zero rate 0.7,
              magnitude init, on phase serve's fabricated files: 8 steps
              with two threshold resets, a checkpoint, an eval and the
              export. Checks finite losses, 12 forward-for-grad and 12
              stored-backward launches per step and 12 primal per eval
              batch, the zero rate after the reset; then 3 warm-up and 10
              timed steps on one batch kept on the card (examples per
              second, device time of two profiled steps), and one fp32
              step with dropout on through the kernels against the plain
              versions (`_close_to`).
 19. visualbert-serve  `serve_vqa --model_type visualbert` at that width:
              512 requests at batch 32 over phase serve's store, through
              phase visualbert-train's mask.pt and classifier4masker.bin,
              bf16 and fp32; zero error responses, 12 primal launches per
              forward, fp32 answers identical to the plain attention's;
              device time by kernel of one bf16 forward at batch 32.
 20. vqavs    `crvqa_tpu_torch.cli.prune_debias_vqavs.main` at full LXMERT
              width, batch 256, bf16, phase train's canonical configuration,
              on fabricated VQA-VS files (the three question JSONs, targets,
              the train_val_test answer vocabulary, the
              VQAvs_test_annotations.json payload) over phase serve's
              feature store: 4 steps with one threshold reset, an eval
              before training and one at step 4, the export. Finite losses;
              34 forward-for-grad and 32 stored-backward launches per step,
              34 primal per eval batch; prefictions_VQAvs_test.json
              byte-equal to test.json; `compute_vqavs_scores` on it gives
              the IID score, the 9 OOD splits and Final_Score, each finite
              and within [0, 100], and on the most-voted answers the IID
              score the votes give.
 21. structured  `prune_debias_vqa --structured_masking heads` at full
              LXMERT width, batch 256, bf16, phase train's configuration
              over phase serve's files (the same `fabricate` from the same
              seed as phase train's): 8 steps with resets at 4 and 8, the
              export and an eval, a `--profile_dir` window (start 4, 2
              steps) and `--tensorboard_dir`. Finite losses; 34 + 32
              launches a step, 34 an eval batch; (12,) gates on exactly
              the specs matching "self"; after the reset each head spec
              has max(int(12 sp), 1) gates at or below its threshold;
              mask.pt's structured weights in constant 64-row blocks equal
              to the gates; head_mask.npy (9, 12) of 0/1; the trace holds
              2 x (34 + 32) attention kernels, and gives the step's device
              busy ms, wall ms and idle share; the event file's losses
              equal metrics.jsonl's (the port's reader). Then `layers` for
              2 steps (scalar gates, the same launches); the primal, the
              forward for grad and the stored backward at the trained
              mask's kept head count H' against their plain versions
              (LXMERT's (Sq, Sk), batch 64, bf16, rate 0.1, `_close_to`),
              timed; `run_vqa_stage3 --head_mask_npy` from phase stage1's
              .bin (batch 64, 4 steps, an eval; 34 + 32 launches a step at
              H'); one fp32 structured step at batch 8 with dropout on
              through the kernels against the plain versions
              (`_close_to`); timed bf16 structured steps at batch 256.
 22. mplug-files  the mPLUG trainer as users start it, at full width
              (`MPlugConfig()`, ViT-B-16 at 384 px, mask mode, bf16, batch
              16): a pretraining-format `.pth` written at 224 px (197
              positions) and read by `vqa_mplug.load_init_ckpt` (every
              weight equal to what was written, the positional embedding
              after its resize to 577; bytes and host seconds); then
              `vqa_mplug` on PNG files with `--augment true`, `--init_ckpt`
              that .pth, `--use_checkpoint true` and `--data_workers 4`
              (2 steps; the launches of checkpointed steps); `--opt
              adahessian` (2 steps, 0 attention launches), `--opt lamb`
              and `--opt adamp` (2 steps each) on synthetic batches; the
              host time of one augmented batch of 16; timed steps (ms,
              peak memory) of adamw with `--use_checkpoint` false and true
              (4 steps each, launches as predicted), lamb, adamp and
              adahessian; one fp32 step at batch 8 with dropout on,
              checkpointed and not, bit-equal.
 23. resume   the JAX package's training states on the card
              (`core/convert.py`, `cli/common.resume_any`): (a) stage 2
              at full LXMERT width, batch 256, compression 0.3/0.3/0.3 at
              zero rate 0.7, LMH, dropout 0, on two synthetic batches
              cycled: 2 fp32 steps of the CLI, its step-2 state written in
              the JAX package's layout (`save_jax_training_state`; bytes,
              host seconds), read back twice into fresh states (every
              leaf bit-equal to what was written, the two reads' leaves
              and generators bit-identical; read seconds), then
              `prune_debias_vqa --resume_from` that file for 2 fp32 steps
              against 2 from the port's own ckpt_2 (losses rtol 1e-4,
              trained leaves atol 2 * lr * steps; 34 + 32 attention
              launches a step); a bf16 state (dropout 0.1) resumed from
              it times 4 train steps on one batch kept on the card
              (finite losses); (b)
              a 2-step mask-mode mPLUG state at full width as a JAX
              `ckpt_final`, served by `serve_mplug --ckpt` (bf16 beam at
              batch 8, 16 requests) with the answers and launches of the
              port's own ckpt_final of the same state; (c) a stage-3
              (FT_randMask from phase stage1's .bin, batch 64) and a
              VisualBERT stage-2 (batch 256) state written in the JAX
              layout after 2 steps and resumed for 2 (launches, finite
              losses). Every file is deleted at the end of the phase.
 23a. parallel  the multi-device runtime (`crvqa_tpu_torch/parallel/`) on
              the one card: `prune_debias_vqa` at `LxmertConfig()`, batch
              256, 0.3/0.3/0.3 at zero rate 0.7, LMH, 8 steps (resets at 4
              and 8, ckpt_8), and `vqa_mplug --mode mask` at
              `MPlugConfig()`, batch 16, 4 steps (resets at 2 and 4,
              ckpt_final), each run twice in fresh processes side by side
              on the card: plain, and with `--multihost true
              --coordinator_address 127.0.0.1:<free port> --num_processes
              1 --process_id 0 --mesh_data 1` (and `--zero_opt true` for
              stage 2; mPLUG always shards), which brings NCCL up for real
              at world 1. The two runs' losses, launches and artifacts
              (mask.pt, classifier4masker.bin or mask_config.json, the
              checkpoint) bit-equal; both step times from the CLI's last
              `ex_s` (the pair sharing the card), the peak device memory,
              and the step's collectives timed alone on the run's
              trainable leaves (the gradient all-reduce, ZeRO's
              broadcast).
 24. summary  a {"kernels": [...]} line, the nvidia-smi line, and last the
              {"ok": true, "device": {...}} line.

The device-time profiles of the serving and training phases (phases 7,
8, 10, 13, 16-19, 21) profile their work twice under one profiler and
keep the second pass (`_warm_profile`): a session loses what launches
while CUPTI starts.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12,   # tensor cores
              "float32": 67e12}     # outside the tensor cores (no TF32)

SERVE_SHAPES = [(14, 14), (36, 36), (14, 36), (36, 14)]
# the bf16 short kernels' edge points beside the main path's: one query and
# one key, the longest rows at 12 heads (85 x 12 = 1020 <= 1024), and
# stage 3's head compaction to 6 heads at the LXMERT shapes, at its batch
SHORT_EDGE_SHAPES = [(1, 1), (85, 85)]
# VisualBERT's single stream: 14 text tokens and 36 boxes, 12 heads; rows
# over the 48 keys the bf16 backward takes in one chunk
VISUALBERT_SHAPE = (50, 50)
COMPACT_HEADS = 6
MPLUG_SHORT_SHAPES = [(25, 25), (1, 1)]  # text towers; the rank bos pass
MPLUG_SHORT_BATCH = 8
# mPLUG's mid-length attentions: the ViT (577,577), the fusion cross
# (25,577), the stride layer's joint (602,602), rank's bos-only pass (1,602)
# and its shortlist pass (k_test * max_answer_len = 120, 602)
MIDSEQ_SHAPES = [(577, 577), (25, 577), (602, 602), (1, 602), (120, 602)]
MIDSEQ_BATCHES = (8, 32)
MIDSEQ_PER_ENCODE = {(577, 577): 12, (25, 577): 5, (602, 602): 1}
MIDSEQ_TOL = {"float32": dict(atol=1e-5, rtol=0.0),
              # p rounds to bf16 before the context product, the output
              # to bf16; the sums run in another order. Outputs are about
              # 0.07 here, so this is tight enough to catch a missed
              # rounding point or a few mishandled padded keys
              "bfloat16": dict(atol=5e-3, rtol=1e-2)}
MPLUG_REQUESTS = 128  # per serve run; the smoke's time limit bounds it
MPLUG_BATCHES = (8, 32)
MPLUG_IMAGES = 32
MPLUG_ANSWERS = 3129  # the size of mPLUG's VQA answer list
MPLUG_K_TEST = 10
SERVE_REQUESTS = 512
SERVE_BATCH = 32
IMAGES = 64
BOXES = 36
TOL = {"float32": dict(atol=2e-5, rtol=0.0),
       # p and the outputs round to bf16; the sums run in another order
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# backward: dp = g v^T reaches tens in fp32, summed in another order than
# cuBLAS sums it; bf16 rounds ds and the outputs
TOL_BWD = {"float32": dict(atol=1e-4, rtol=0.0),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TOL_P = 1e-6  # the fp32 residual p

# mPLUG mask training at batch 16 with 5 answers of 8 tokens per question:
# mid-length launches per step by (Sq, Sk). The forward runs all 30; the
# backward skips the first ViT block's attention, which no trained leaf
# precedes (the ViT's masks are on its MLPs), unless every parameter trains.
MIDSEQ_TRAIN_SHAPES = [(577, 577), (25, 577), (602, 602), (40, 602)]
MIDSEQ_FWD_PER_STEP = {(577, 577): 12, (25, 577): 5, (602, 602): 1,
                       (40, 602): 12}
MIDSEQ_BWD_PER_STEP = {**MIDSEQ_FWD_PER_STEP, (577, 577): 11}
SHORT_PER_STEP = 11  # 6 text encoder + 5 fusion self at (25,25)
MIDSEQ_BWD_TOL = {"float32": dict(atol=2e-5, rtol=0.0),
                  # gradients are about 1; ds, p_t and each output round to
                  # bf16 once, the sums run in another order
                  "bfloat16": dict(atol=1e-2, rtol=2e-2)}
MPLUG_TRAIN_BATCH = 16
MPLUG_SYNTHETIC = 64           # 4 steps per epoch, 4 eval batches
MPLUG_TRAIN_SHAPES = "25,8,5"  # q_len, answer_len, answers per question
MPLUG_CHECK_BATCH = 8

TRAIN_BATCH = 256
TRAIN_RATES = (0.0, 0.1)
MAIN_RATE = 0.1  # LxmertConfig's attention dropout: the main path's rate
KERNEL_SEED = -123457  # an int32 dropout seed (negative: wraps to uint32)
N_TRAIN, N_TEST = 2048, 512
TRAIN_EPOCHS, LOGGING_STEPS, SAVE_STEPS = 3, 8, 16  # 24 steps
RECOMPUTE_EPOCHS = 1  # 8 steps
WARMUP_STEPS, TIMED_STEPS = 3, 10
CHECK_BATCH = 64


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------- phase 1

def phase_device(torch, rehearse: bool) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False (fp32 is full fp32)")
    if rehearse:
        return {"name": "cpu (rehearsal)", "count": 0, "smi": "n/a"}
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); nvidia-smi: {smi_line}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"name": name, "count": count, "smi": smi_line}


# ----------------------------------------------------------------- phase 2

def phase_build() -> dict:
    """Compile every CUDA source, the feature store and the WordPiece
    encoder from the checkout, one compiler process each, all started
    together."""
    from crvqa_tpu_torch.native import feature_store, wordpiece
    from crvqa_tpu_torch.ops import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as pool:
        jobs = {name: pool.submit(_build.load_cuda_library, name)
                for name in sources}
        jobs["feature_store"] = pool.submit(feature_store._load_lib)
        jobs["wordpiece"] = pool.submit(wordpiece.load)
        for name, job in jobs.items():
            job.result()
    seconds = time.monotonic() - t0
    log(f"build: {len(jobs)} libraries in {seconds:.1f} s "
        f"({', '.join(jobs)})")
    kernels = {}
    for name in sources:
        for kernel, info in _build_report(_build.BUILD_DIR, name).items():
            kernels[kernel] = info
            log(f"build: {name}: {kernel}: " + ", ".join(
                f"{v} {k}" for k, v in info.items()))
    product = {k: v for k, v in kernels.items()
               if "wgmma_gemm_kernel" in k}
    check(len(product) == 3, f"build: the three wgmma_gemm_kernel "
                             f"instantiations, found {list(product)}")
    check("head_compact_kernel" in kernels,
          f"build: no head_compact_kernel in {list(kernels)}")
    product["head_compact_kernel"] = kernels["head_compact_kernel"]
    for kernel, info in product.items():
        check(info.get("HGMMA", 1) > 0 and info.get("UTMALDG", 1) > 0,
              f"build: {kernel} has no wgmma (HGMMA) or TMA load (UTMALDG) "
              f"in its SASS: {info}")
    return {"seconds": seconds, "sources": sources, "kernels": kernels}


def _demangle(names: list[str]) -> dict:
    """Mangled kernel names -> `fused_attention_bwd_mma_kernel<true, 6>`
    (c++filt, where the toolchain has it; else left mangled)."""
    import re

    out = {n: n for n in names}
    if shutil.which("c++filt") and names:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        for n, d in zip(names, plain):
            m = re.search(r"(\w+(<[^()]*>)?)\(", d)
            out[n] = m.group(1) if m else d
    return out


def _build_report(build_dir: str, name: str) -> dict:
    """Per kernel of lib<name>.so: registers, shared memory and spills from
    the build's `-Xptxas -v` log, and in its SASS from `cuobjdump -sass`,
    where the toolkit has it, the tensor-core instructions (HMMA, and
    HGMMA for `wgmma`) and the TMA loads (UTMALDG)."""
    import re

    report, kernel = {}, None
    with open(os.path.join(build_dir, f"lib{name}.so.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
                report[kernel] = {}
            elif kernel is not None and "Used" in line:
                for key in ("registers", "bytes smem"):
                    n = re.search(r"(\d+) " + key, line)
                    if n:
                        report[kernel][key] = int(n.group(1))
            elif kernel is not None and "spill" in line:
                n = re.search(r"(\d+) bytes spill stores", line)
                report[kernel]["bytes spilled"] = int(n.group(1)) if n else 0
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", os.path.join(build_dir, f"lib{name}.so")],
            capture_output=True, text=True, timeout=120).stdout
        for chunk in sass.split("Function : ")[1:]:
            fn = chunk.split(None, 1)[0]
            if fn in report:
                for op in ("HMMA", "HGMMA", "UTMALDG"):
                    report[fn][op] = chunk.count(op)
    names = _demangle(list(report))
    return {names[k]: v for k, v in report.items()}


# ----------------------------------------------------------------- phase 3

def _attention_inputs(torch, b, sq, sk, dtype, device, seed, heads=12):
    g = torch.Generator().manual_seed(seed)
    d = heads * 64
    q = torch.randn(b, sq, d, generator=g)
    k = torch.randn(b, sk, d, generator=g)
    v = torch.randn(b, sk, d, generator=g)
    bias = torch.zeros(b, sk)
    if sk > 1:  # -10000 pads on a third of the rows
        for i in range(1, b, 3):
            bias[i, sk - 1 - (i % (sk // 2)):] = -10000.0
    dt = getattr(torch, dtype)
    return (q.to(device, dt), k.to(device, dt), v.to(device, dt),
            bias.to(device))


def _graph_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph and
    replayed, so host overhead does not enter the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
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
    return start.elapsed_time(end) / (reps * replays)


def _eager_ms(torch, fn, iters: int = 100) -> float:
    """Time per call as a caller sees it, host overhead included."""
    for _ in range(10):
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


def _bound_terms(b, sq, sk, dtype, heads=12):
    """(ms to move the bytes, ms to do the FLOPs) of one forward call of
    either attention kernel (the short primal and the mid-length forward
    read and write the same tensors) on an H100: q, k, v and the fp32 bias
    read once and the output written once, over HBM; the two products'
    FLOPs over the peak rate of the inputs' type."""
    item = 2 if dtype == "bfloat16" else 4
    d = heads * 64
    nbytes = item * b * d * (2 * sq + 2 * sk) + 4 * b * sk
    flops = 4 * b * heads * sq * sk * 64
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def _bound(t_bytes, t_ops):
    """The least time is the larger term; it names what bounds the work."""
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _kernel_point(torch, name, kernel, plain, b, sq, sk, dtype, device,
                  seed, tol, rehearse, rate=0.0, timed=True, heads=12
                  ) -> dict:
    """One (batch, Sq, Sk, dtype, rate) point of a forward attention
    kernel: its output against its plain version on the same inputs
    (`tol`), its bound, and (`timed`, on the card) its device time beside
    the plain version's and `scaled_dot_product_attention`'s with the bias
    as a float mask (a yardstick the port never calls)."""
    import torch.nn.functional as F

    q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype, device, seed,
                                      heads)
    args = (q, k, v, bias, heads, 64, rate, KERNEL_SEED)
    out = kernel(*args)
    ref = plain(*args)
    if not rehearse:
        torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(torch.allclose(out.float(), ref.float(), **tol))
    row = {"batch": b, "dtype": dtype, "rate": rate, "heads": heads,
           "sq": sq, "sk": sk, "max_abs_err": err, "ok": ok}
    row["bytes_ms"], row["ops_ms"] = _bound_terms(b, sq, sk, dtype, heads)
    row["bound_ms"], row["bound_by"] = _bound(row["bytes_ms"], row["ops_ms"])
    if timed and not rehearse:
        mask = bias.to(q.dtype)[:, None, None, :]
        split = lambda t: t.view(b, t.shape[1], heads, 64).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        row["ms"] = _graph_ms(torch, lambda: kernel(*args))
        row["plain_ms"] = _graph_ms(torch, lambda: plain(*args))
        row["library_ms"] = _graph_ms(torch, lambda: (
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)))
        row["call_ms"] = _eager_ms(torch, lambda: kernel(*args))
    log(f"{name}: " + json.dumps(row))
    check(ok, f"{name} disagrees with its plain version at B={b} {dtype} "
              f"rate {rate} H={heads} ({sq},{sk}): max abs err {err} "
              f"(tolerance {tol})")
    return row


def _fused_primal(q, k, v, bias, num_heads, head_size, rate, seed):
    from crvqa_tpu_torch.ops import fused_attention as fa

    return fa.fused_attention(q, k, v, bias, num_heads, head_size)


def _fused_primal_plain(q, k, v, bias, num_heads, head_size, rate, seed):
    from crvqa_tpu_torch.ops import fused_attention as fa

    return fa.fused_attention_reference(q, k, v, bias, num_heads, head_size)


def phase_kernel(torch, device, rehearse: bool, seed: int) -> list[dict]:
    """The primal short kernel at LXMERT's serving shapes (batch 32, 256),
    VisualBERT's (50,50) (batch 32) and mPLUG's text-tower and rank shapes
    (batch 8), fp32 and bf16; then bf16 at the edge shapes (1,1) and
    (85,85) (batch 32) and at stage 3's 6 compacted heads (the LXMERT
    shapes, batch 64)."""
    points = [(b, sq, sk) for b in ((2,) if rehearse else (SERVE_BATCH, 256))
              for sq, sk in SERVE_SHAPES]
    points.append((2 if rehearse else SERVE_BATCH,) + VISUALBERT_SHAPE)
    points += [(2 if rehearse else MPLUG_SHORT_BATCH, sq, sk)
               for sq, sk in MPLUG_SHORT_SHAPES]
    rows = [_kernel_point(torch, "fused_attention_fwd", _fused_primal,
                          _fused_primal_plain, b, sq, sk, dtype, device,
                          seed + sq + sk, TOL[dtype], rehearse)
            for b, sq, sk in points for dtype in ("float32", "bfloat16")]
    edge = [(2 if rehearse else SERVE_BATCH, 12, sq, sk)
            for sq, sk in SHORT_EDGE_SHAPES]
    edge += [(2 if rehearse else S1_BATCH, COMPACT_HEADS, sq, sk)
             for sq, sk in SERVE_SHAPES]
    return rows + [_kernel_point(torch, "fused_attention_fwd", _fused_primal,
                                 _fused_primal_plain, b, sq, sk, "bfloat16",
                                 device, seed + sq + sk + h, TOL["bfloat16"],
                                 rehearse, heads=h)
                   for b, h, sq, sk in edge]


def phase_midseq_kernel(torch, device, rehearse: bool, seed: int
                        ) -> list[dict]:
    """The mid-length kernel at mPLUG's five shapes, batch 8 (the serve
    default) and 32, fp32 and bf16, dropout rates 0 and 0.1 against its
    plain version; timed at rate 0 (serving's)."""
    from crvqa_tpu_torch.ops import midseq_attention as ma

    return [_kernel_point(torch, "midseq_attention_fwd",
                          ma.midseq_attention, ma.midseq_attention_reference,
                          b, sq, sk, dtype, device, seed + 3 * sq + sk,
                          MIDSEQ_TOL[dtype], rehearse, rate=rate,
                          timed=rate == 0.0)
            for b in ((2,) if rehearse else MIDSEQ_BATCHES)
            for dtype in ("float32", "bfloat16")
            for rate in TRAIN_RATES for sq, sk in MIDSEQ_SHAPES]


# ----------------------------------------------------------------- phase 4

def launch_mult(config) -> tuple[dict, dict]:
    """Attention launches per train step by (Sq, Sk): the forward runs all
    34 ((14,14) x l+x, (36,36) x r+x, (14,36) and (36,14) x x); autograd
    runs the backward of 32, because the last cross layer's visual branch
    (its (36,14) cross and (36,36) self attention) never reaches the
    logits."""
    c = config
    fwd = {(14, 14): c.l_layers + c.x_layers, (36, 36): c.r_layers + c.x_layers,
           (14, 36): c.x_layers, (36, 14): c.x_layers}
    bwd = dict(fwd)
    bwd[(36, 36)] -= 1
    bwd[(36, 14)] -= 1
    return fwd, bwd


def _train_bound_terms(b, sq, sk, dtype, kind, heads=12):
    """(bytes ms, FLOPs ms) of one training-kernel call, each input read
    once and each output written once: the forward for grad reads q, k, v
    and the bias and writes out and the fp32 residual; the stored backward
    reads q, g, k, v and the residual and writes dq, dk, dv; the recompute
    backward reads the bias instead of the residual."""
    item = 2 if dtype == "bfloat16" else 4
    d, h = heads * 64, heads
    resid = 4 * b * sq * h * sk
    if kind == "fwd":
        nbytes = item * b * d * (2 * sq + 2 * sk) + 4 * b * sk + resid
        flops = 4 * b * h * sq * sk * 64
    else:
        nbytes = item * b * d * (2 * sq + 2 * sk) + item * b * d * (sq + 2 * sk)
        nbytes += resid if kind == "stored" else 4 * b * sk
        flops = (8 if kind == "stored" else 10) * b * h * sq * sk * 64
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def _max_err(torch, got, want) -> float:
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def phase_train_kernels(torch, device, rehearse: bool, seed: int
                        ) -> list[dict]:
    import torch.nn.functional as F

    from crvqa_tpu_torch.ops import fused_attention as fa

    rows = []
    # stage 2's batch, both dtypes and rates, at LXMERT's and VisualBERT's
    # shapes; stages 1 and 3's, bf16 at the main path's rate, with the edge
    # shapes and stage 3's 6 heads
    points = [(2 if rehearse else TRAIN_BATCH, dtype, rate, 12, sq, sk)
              for dtype in ("float32", "bfloat16") for rate in TRAIN_RATES
              for sq, sk in SERVE_SHAPES + [VISUALBERT_SHAPE]]
    b64 = 2 if rehearse else S1_BATCH
    points += [(b64, "bfloat16", MAIN_RATE, 12, sq, sk)
               for sq, sk in SERVE_SHAPES + SHORT_EDGE_SHAPES]
    points += [(b64, "bfloat16", MAIN_RATE, COMPACT_HEADS, sq, sk)
               for sq, sk in SERVE_SHAPES]
    for b, dtype, rate, heads, sq, sk in points:
        q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                          device, seed + 7 * sq + sk,
                                          heads)
        gen = torch.Generator().manual_seed(seed + sq * sk)
        g = torch.randn(q.shape, generator=gen).to(device, q.dtype)
        args = (heads, 64, rate, KERNEL_SEED)
        out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
        ref_out, ref_p = fa.fused_attention_train_reference(
            q, k, v, bias, *args)
        stored = fa.fused_attention_bwd_stored(q, k, v, p, g, *args)
        recomp = fa.fused_attention_bwd_recompute(q, k, v, bias, g,
                                                  *args)
        ref_s = fa.fused_attention_bwd_reference(q, k, v, p, g, *args)
        ref_r = fa.fused_attention_bwd_reference(q, k, v, ref_p, g,
                                                 *args)
        if not rehearse:
            torch.cuda.synchronize()
        row = {"batch": b, "dtype": dtype, "rate": rate, "heads": heads,
               "sq": sq, "sk": sk,
               "fwd_err": _max_err(torch, [out], [ref_out]),
               "p_err": _max_err(torch, [p], [ref_p]),
               "bwd_stored_err": _max_err(torch, stored, ref_s),
               "bwd_recompute_err": _max_err(torch, recomp, ref_r),
               "stored_vs_recompute": _max_err(torch, stored, recomp)}
        ok = (torch.allclose(out.float(), ref_out.float(), **TOL[dtype])
              and torch.allclose(p, ref_p, atol=TOL_P, rtol=0)
              and all(torch.allclose(x.float(), y.float(),
                                     **TOL_BWD[dtype])
                      for x, y in zip(stored + recomp, ref_s + ref_r))
              # the bf16 backward rebuilds the forward's p bit for bit
              and (dtype != "bfloat16"
                   or row["stored_vs_recompute"] == 0.0))
        if (sq, sk) == VISUALBERT_SHAPE and rate == MAIN_RATE:
            probe = _keep_and_p_probe(torch, fa, b, sq, sk, dtype, device,
                                      seed + 11)
            row.update(probe)
            ok = ok and probe["keep_exact"] and (dtype != "bfloat16"
                                                  or probe["p_bit_equal"])
        for kind in ("fwd", "stored", "recompute"):
            t_bytes, t_ops = _train_bound_terms(b, sq, sk, dtype, kind,
                                                heads)
            row[f"{kind}_bytes_ms"], row[f"{kind}_ops_ms"] = (t_bytes,
                                                              t_ops)
        if not rehearse:
            split = lambda t: (t.view(b, t.shape[1], heads, 64)
                               .transpose(1, 2).detach()
                               .requires_grad_())
            qh, kh, vh = split(q), split(k), split(v)
            gh = g.view(b, sq, heads, 64).transpose(1, 2)
            mask = bias.to(q.dtype)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
            row["fwd_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_fwd_train(q, k, v, bias, *args)))
            row["fwd_plain_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_train_reference(q, k, v, bias,
                                                   *args)))
            row["stored_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_bwd_stored(q, k, v, p, g, *args)))
            row["stored_plain_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_bwd_reference(q, k, v, p, g,
                                                 *args)))
            row["recompute_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_bwd_recompute(q, k, v, bias, g,
                                                 *args)))
            row["recompute_plain_ms"] = _graph_ms(torch, lambda: (
                fa.fused_attention_bwd_reference(
                    q, k, v, fa.probs_residual(q, k, bias, heads, 64),
                    g, *args)))
            row["library_fwd_ms"] = _graph_ms(torch, sdpa)
            row["library_fwd_bwd_ms"] = _graph_ms(
                torch, lambda: torch.autograd.grad(
                    sdpa(), (qh, kh, vh), gh))
        rows.append(row)
        log("train-kernels: " + json.dumps(row))
        check(ok, f"training attention kernels disagree with their "
                  f"plain versions at B={b} {dtype} rate {rate} H="
                  f"{heads} ({sq},{sk}): {row} (tolerances "
                  f"{TOL[dtype]}, p {TOL_P}, backward {TOL_BWD[dtype]}; "
                  "bf16 stored and recompute bit-identical; at "
                  f"{VISUALBERT_SHAPE} the keep masks exact and bf16 p "
                  "bit-equal)")
    return rows


def _keep_and_p_probe(torch, fa, b, sq, sk, dtype, device, seed, heads=12
                      ) -> dict:
    """The keep mask each training kernel applies, and the p the recompute
    backward rebuilds, read out of the kernels themselves (Sq, Sk <= 64):

    - v one-hot (v[b, k, h*64 + j] = [j == k]) makes the forward's output
      column h*64 + k the dropped probability p_t[b, h, i, k], and g
      one-hot (g[b, i, h*64 + j] = [j == i]) makes dv's column h*64 + i
      p_t[b, h, i, k] in both backwards; with the bias 0 every p > 0, so
      each nonzero is a kept bit, held to `keep_mask` bit for bit;
    - at rate 0, the recompute backward's dv with that g is the p it
      rebuilt (exactly in fp32; rounded to bf16 once in bf16), held to the
      forward's fp32 residual bit for bit (bf16: to its bf16 rounding).
      The bf16 forward keeps a 50-key row in registers, the backward
      rebuilds it in chunks of 48 keys."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    d = heads * 64
    q = torch.randn(b, sq, d, generator=g).to(device, dt)
    k = torch.randn(b, sk, d, generator=g).to(device, dt)
    bias = torch.zeros(b, sk, device=device)
    one_hot = lambda n: (torch.eye(n, 64).repeat(1, heads).expand(b, n, d)
                         .contiguous().to(device, dt))
    v, go = one_hot(sk), one_hot(sq)
    # [b, sk, h, 64] -> [b, i, h, k]
    by_row = lambda dv: dv.view(b, sk, heads, 64)[..., :sq].permute(0, 3, 2, 1)
    want = fa.keep_mask(torch.arange(b, device=device), sq, heads * sk,
                        MAIN_RATE, KERNEL_SEED).view(b, sq, heads, sk)
    args = (heads, 64, MAIN_RATE, KERNEL_SEED)
    out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
    keep = {"fwd": out.view(b, sq, heads, 64)[..., :sk] != 0,
            "stored": by_row(fa.fused_attention_bwd_stored(
                q, k, v, p, go, *args)[2]) != 0,
            "recompute": by_row(fa.fused_attention_bwd_recompute(
                q, k, v, bias, go, *args)[2]) != 0}
    _, p0 = fa.fused_attention_fwd_train(q, k, v, bias, heads, 64, 0.0, 0)
    rebuilt = by_row(fa.fused_attention_bwd_recompute(
        q, k, v, bias, go, heads, 64, 0.0, 0)[2])
    stored_p = p0.view(b, sq, heads, sk).to(dt)
    out = {f"keep_{name}_mismatches": int((m != want).sum())
           for name, m in keep.items()}
    out["keep_exact"] = not any(out.values())
    out["p_bit_equal"] = bool(torch.equal(rebuilt, stored_p))
    out["p_rebuilt_max_abs_diff"] = (rebuilt.float()
                                     - stored_p.float()).abs().max().item()
    out["kept_share"] = want.float().mean().item()
    return out


# a rank's place in the runtime's layouts: data rank 1 of 2 (rows from
# b) and tensor-parallel rank 1 of 2 (heads from 6 of 12)
OFFSET_HEADS = 6


def _offset_keep_readout(torch, fn, q, k, bias, heads, sq, n_keys, rate,
                         seed, row0, head0):
    """The keep bits a kernel's forward applies to the first `n_keys` keys
    (<= 64), read out through one-hot v: output column h*64 + j is the
    dropped probability of key j, nonzero iff kept (bias 0: every p >
    0)."""
    b, sk, d = q.shape[0], k.shape[1], heads * 64
    v = (torch.eye(sk, 64)[None].repeat(1, 1, heads).expand(b, sk, d)
         .contiguous().to(q.device, q.dtype))
    out = fn(q, k, v, bias, heads, 64, rate, seed, row0=row0, head0=head0)
    if isinstance(out, tuple):
        out = out[0]
    return out.view(b, sq, heads, 64)[..., :n_keys] != 0


def phase_offset_kernels(torch, device, rehearse: bool, seed: int
                         ) -> list[dict]:
    """The attention kernels with the runtime's offsets (`row0` = b, the
    first global row of data rank 1 of 2; `head0` = 6, the first head of
    tensor-parallel rank 1 of 2, 6 heads a rank): the keep masks the short
    kernels' forward for grad and both backwards apply, and the mid-length
    forward's for the first 64 keys, read out and held to the plain
    `keep_mask` of those global rows and heads bit for bit; outputs and
    gradients against the plain versions with the same offsets, at the
    kernel phases' tolerances. Batch 8: the short kernels at LXMERT's four
    (Sq, Sk) and VisualBERT's (50,50), the mid-length ones at mPLUG's
    training shapes, fp32 and bf16, dropout 0.1."""
    from crvqa_tpu_torch.ops import fused_attention as fa
    from crvqa_tpu_torch.ops import midseq_attention as ma

    rows = []
    b = 2 if rehearse else 8
    heads, row0, head0 = OFFSET_HEADS, b, OFFSET_HEADS
    args = (heads, 64, MAIN_RATE, KERNEL_SEED)
    off = dict(row0=row0, head0=head0)
    for dtype in ("float32", "bfloat16"):
        for sq, sk in SERVE_SHAPES + [VISUALBERT_SHAPE]:
            q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                              device, seed + sq * sk, heads)
            g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
                seed + sq)).to(device, q.dtype)
            out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args,
                                                  **off)
            ref_out, ref_p = fa.fused_attention_train_reference(
                q, k, v, bias, *args, **off)
            stored = fa.fused_attention_bwd_stored(q, k, v, p, g, *args,
                                                   **off)
            recomp = fa.fused_attention_bwd_recompute(q, k, v, bias, g,
                                                      *args, **off)
            ref_b = fa.fused_attention_bwd_reference(q, k, v, p, g, *args,
                                                     **off)
            zeros = torch.zeros_like(bias)
            keep = _offset_keep_readout(
                torch, fa.fused_attention_fwd_train, q, k, zeros, heads, sq,
                sk, MAIN_RATE, KERNEL_SEED, row0, head0)
            want = fa.keep_mask(torch.arange(row0, row0 + b, device=device),
                                sq, heads * sk, MAIN_RATE, KERNEL_SEED,
                                col0=head0 * sk).view(b, sq, heads, sk)
            row = {"kernel": "short", "dtype": dtype, "sq": sq, "sk": sk,
                   "batch": b, "heads": heads, "row0": row0,
                   "head0": head0,
                   "keep_mismatches": int((keep != want).sum()),
                   "fwd_err": _max_err(torch, [out], [ref_out]),
                   "p_err": _max_err(torch, [p], [ref_p]),
                   "bwd_stored_err": _max_err(torch, stored, ref_b),
                   "bwd_recompute_err": _max_err(torch, recomp, ref_b)}
            ok = (row["keep_mismatches"] == 0
                  and torch.allclose(out.float(), ref_out.float(),
                                     **TOL[dtype])
                  and torch.allclose(p, ref_p, atol=TOL_P, rtol=0)
                  and all(torch.allclose(x.float(), y.float(),
                                         **TOL_BWD[dtype])
                          for x, y in zip(stored + recomp, ref_b + ref_b)))
            rows.append(row)
            log("offset-kernels: " + json.dumps(row))
            check(ok, f"offset-kernels: the short kernels with row0 {row0}, "
                      f"head0 {head0} disagree at {dtype} ({sq},{sk}): {row}")
        for sq, sk in MIDSEQ_TRAIN_SHAPES:
            q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                              device, seed + sq + sk, heads)
            g = torch.randn(q.shape, generator=torch.Generator().manual_seed(
                seed + sk)).to(device, q.dtype)
            out = ma.midseq_attention(q, k, v, bias, *args, **off)
            ref = ma.midseq_attention_reference(q, k, v, bias, *args, **off)
            grads = ma.midseq_attention_bwd(q, k, v, bias, g, *args, **off)
            ref_g = ma.midseq_attention_bwd_reference(q, k, v, bias, g,
                                                      *args, **off)
            n_keys = min(sk, 64)
            keep = _offset_keep_readout(
                torch, ma.midseq_attention, q, k, torch.zeros_like(bias),
                heads, sq, n_keys, MAIN_RATE, KERNEL_SEED, row0, head0)
            want = ma.drop_factor(b, heads, sq, sk, MAIN_RATE, KERNEL_SEED,
                                  device, row0, head0)[..., :n_keys] != 0
            want = want.permute(0, 2, 1, 3)  # [b, i, h, key]
            row = {"kernel": "midseq", "dtype": dtype, "sq": sq, "sk": sk,
                   "batch": b, "heads": heads, "row0": row0,
                   "head0": head0, "keys_read": n_keys,
                   "keep_mismatches": int((keep != want).sum()),
                   "fwd_err": _max_err(torch, [out], [ref]),
                   "bwd_err": _max_err(torch, grads, ref_g)}
            ok = (row["keep_mismatches"] == 0
                  and torch.allclose(out.float(), ref.float(),
                                     **MIDSEQ_TOL[dtype])
                  and all(torch.allclose(x.float(), y.float(),
                                         **MIDSEQ_BWD_TOL[dtype])
                          for x, y in zip(grads, ref_g)))
            rows.append(row)
            log("offset-kernels: " + json.dumps(row))
            check(ok, f"offset-kernels: the mid-length kernels with row0 "
                      f"{row0}, head0 {head0} disagree at {dtype} "
                      f"({sq},{sk}): {row}")
    return rows


WORDS = ("what color is the how many are there on a this man woman dog cat "
         "frisbee kitchen table red blue green yes no holding person in "
         "picture of wearing sitting standing room street car").split()
TEMPLATES = ["What color is the {}?", "How many {}s are there?",
             "Is this a {}?", "What is the {} holding?",
             "Is the {} sitting on the table?"]
SUBJECTS = ["man", "woman", "dog", "cat", "frisbee", "car", "person"]


def fabricate(root: str, config, rng, torch, seed: int) -> dict:
    """VQA-CP-shaped files of the real widths from `seed`: vocab, answer
    vocabulary, image features as a pickle and a .bin store, a stage-2
    mask.pt at zero-rate 0.7, a classifier4masker.bin, the requests, and
    the train and test question and target files."""
    import numpy as np

    from crvqa_tpu_torch.masking.prune import lxmert_specs_for
    from crvqa_tpu_torch.models import build_lxmert
    from crvqa_tpu_torch.native.feature_store import build_feature_store

    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(WORDS)
              + ["##s", "?", ",", "."])
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")
    os.makedirs(os.path.join(root, "cache"))
    label2ans = ["yes", "no"] + [f"answer_{i}"
                                 for i in range(2, config.ans_num)]
    for name, obj in (("train_test_label2ans.pkl", label2ans),
                      ("train_test_ans2label.pkl",
                       {a: i for i, a in enumerate(label2ans)})):
        with open(os.path.join(root, "cache", name), "wb") as f:
            pickle.dump(obj, f)

    ids = [str(100000 + i) for i in range(IMAGES)]
    feats = {i: {"feats": rng.standard_normal(
                     (BOXES, config.visual_feat_dim)).astype(np.float32),
                 "sp_feats": rng.random((BOXES, config.visual_pos_dim)
                                        ).astype(np.float32)}
             for i in ids}
    with open(os.path.join(root, "features.pickle"), "wb") as f:
        pickle.dump(feats, f)
    build_feature_store(os.path.join(root, "features.bin"), feats, ids)

    shapes = build_lxmert(config, "meta").state_dict()
    g = torch.Generator().manual_seed(seed)
    masks = {f"{s.torch_name}.weight":
             torch.rand(shapes[f"{s.torch_name}.weight"].shape, generator=g)
             > 0.7 for s in lxmert_specs_for(config)}
    torch.save(masks, os.path.join(root, "mask.pt"))
    head = build_lxmert(config, "cpu",
                        torch.Generator().manual_seed(seed + 1)).classifier
    torch.save(head.state_dict(),
               os.path.join(root, "classifier4masker.bin"))

    with open(os.path.join(root, "requests.jsonl"), "w") as f:
        for n in range(SERVE_REQUESTS):
            q = TEMPLATES[n % len(TEMPLATES)].format(
                SUBJECTS[int(rng.integers(len(SUBJECTS)))])
            f.write(json.dumps({"question_id": n, "question": q,
                                "image_id": ids[int(rng.integers(IMAGES))]})
                    + "\n")

    # VQA-CP train and test splits (dataset_LXM.py:118-179): questions,
    # and targets with a question type, answer labels and VQA soft scores;
    # the answers lean on the question type, so the bias priors carry signal
    for split, n, qid0 in (("train", N_TRAIN, 1000000),
                           ("test", N_TEST, 2000000)):
        questions, targets = [], []
        for i in range(n):
            t = int(rng.integers(len(TEMPLATES)))
            subject = SUBJECTS[int(rng.integers(len(SUBJECTS)))]
            image = ids[int(rng.integers(IMAGES))]
            labels = sorted({int(x) % config.ans_num for x in
                             rng.integers(40 * t, 40 * t + 60, size=2)})
            questions.append({"question_id": qid0 + i, "image_id": image,
                              "question": TEMPLATES[t].format(subject)})
            targets.append({"question_id": qid0 + i, "image_id": image,
                            "question_type": TEMPLATES[t].split(" {}")[0],
                            "labels": labels,
                            "scores": [float(min(1.0, rng.integers(1, 4) / 3))
                                       for _ in labels]})
        with open(os.path.join(root, f"vqacp_v2_{split}_questions.json"),
                  "w") as f:
            json.dump(questions, f)
        with open(os.path.join(root, "cache", f"{split}_target.pkl"),
                  "wb") as f:
            pickle.dump(targets, f)
    return {"label2ans": label2ans, "n_masks": len(masks)}


def _serve(root, dtype, store, device, tiny, seed, tag, artifacts=None,
           extra=(), ckpt=None, requests=SERVE_REQUESTS):
    """serve_vqa over the first `requests` requests; `artifacts` is the
    directory of the mask.pt and classifier4masker.bin to serve (default:
    `root`), or `ckpt` a params file to serve as it is (`--ckpt`, no
    stage-2 artifacts); `extra` more argv (`--model_type visualbert`)."""
    import numpy as np

    from crvqa_tpu_torch.cli import serve_vqa

    artifacts = artifacts or root
    out = os.path.join(root, f"responses_{tag}.jsonl")
    inp = os.path.join(root, "requests.jsonl")
    if requests != SERVE_REQUESTS:
        with open(inp) as f:
            head = f.readlines()[:requests]
        inp = os.path.join(root, f"requests_{requests}.jsonl")
        with open(inp, "w") as f:
            f.writelines(head)
    params = (["--ckpt", ckpt] if ckpt else
              ["--mask_pt", os.path.join(artifacts, "mask.pt"),
               "--classifier_bin", os.path.join(artifacts,
                                                "classifier4masker.bin")])
    argv = ["--dataroot", root, "--img_root", os.path.join(root, store),
            "--vocab_file", os.path.join(root, "vocab.txt"), *params,
            "--dtype", dtype, "--seed", str(seed),
            "--serve_batch_size", str(SERVE_BATCH), "--max_wait_ms", "5",
            "--input", inp, "--output", out, "--device", str(device),
            *extra]
    if tiny:
        argv.append("--tiny")
    t0 = time.monotonic()
    stats = serve_vqa.main(argv)
    total_s = time.monotonic() - t0
    with open(out) as f:
        responses = [json.loads(line) for line in f]
    errors = [r for r in responses if "error" in r]
    check(not errors, f"serve {tag}: {len(errors)} error responses, first: "
                      f"{errors[:1]}")
    check(len(responses) == requests
          and [r["question_id"] for r in responses] == list(
              range(requests)),
          f"serve {tag}: responses missing or out of order")
    lat = np.asarray(stats["batch_ms"])
    summary = {"tag": tag, "dtype": dtype, "store": store,
               "requests": stats["requests"], "batches": stats["batches"],
               "batch_ms_p50": float(np.percentile(lat, 50)),
               "batch_ms_p99": float(np.percentile(lat, 99)),
               "batch_ms_min": float(lat.min()),
               "batch_ms_max": float(lat.max()),
               "requests_per_s": stats["requests"] / stats["wall_s"],
               "main_s_incl_load": total_s}
    return responses, summary


def _direct_logits(root, device, tiny, seed, n, attention):
    """fp32 logits of the first `n` requests through the serving model,
    with `attention` as the model's attention function."""
    import numpy as np
    import torch

    from crvqa_tpu_torch.cli import serve_vqa
    from crvqa_tpu_torch.data import vqacp
    from crvqa_tpu_torch.models import layers

    argv = ["--dataroot", root, "--img_root",
            os.path.join(root, "features.pickle"),
            "--vocab_file", os.path.join(root, "vocab.txt"),
            "--mask_pt", os.path.join(root, "mask.pt"),
            "--classifier_bin", os.path.join(root, "classifier4masker.bin"),
            "--dtype", "float32", "--seed", str(seed),
            "--device", str(device)] + (["--tiny"] if tiny else [])
    args = serve_vqa.build_parser().parse_args(argv)
    model = serve_vqa.build_serving_model(args, device)
    with open(os.path.join(root, "requests.jsonl")) as f:
        reqs = [json.loads(line) for line in f][:n]
    ids, _ = vqacp.tokenize_questions([r["question"] for r in reqs],
                                      vqacp.make_tokenizer(args.vocab_file))
    feats, pos = vqacp.ImageFeatures(args.img_root).lookup(
        [r["image_id"] for r in reqs])
    saved = layers.fused_attention
    layers.fused_attention = attention
    try:
        with torch.inference_mode():
            logits, _ = model(
                input_ids=torch.from_numpy(ids).to(device, torch.long),
                visual_feats=torch.from_numpy(feats).to(device),
                visual_pos=torch.from_numpy(pos).to(device),
                attention_mask=torch.ones(ids.shape, device=device))
    finally:
        layers.fused_attention = saved
    return np.asarray(logits.cpu())


def _plain_attention(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
                     row0=0, head0=0):
    """The model's attention on the plain versions: the primal's at rate 0
    without autograd, else the forward for grad's with the same
    counter-hash dropout (at the same row and head offsets), differentiated
    by autograd."""
    import torch

    from crvqa_tpu_torch.ops import fused_attention as fa

    if rate == 0.0 and not (torch.is_grad_enabled() and q.requires_grad):
        return fa.fused_attention_reference(q, k, v, bias, num_heads,
                                            head_size)
    return fa.fused_attention_train_reference(q, k, v, bias, num_heads,
                                              head_size, rate, seed, row0,
                                              head0)[0]


def phase_serve(torch, device, rehearse: bool, seed: int, keep_dir: str
                ) -> dict:
    """Full-width LXMERT serving (module docstring, phase 6); the
    fabricated files stay in `keep_dir`/serve for the VisualBERT phases."""
    import numpy as np

    from crvqa_tpu_torch.models import LxmertConfig, layers
    from crvqa_tpu_torch.ops.fused_attention import fused_attention

    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    per_forward = config.l_layers + config.r_layers + 4 * config.x_layers
    forwards = 1 + SERVE_REQUESTS // SERVE_BATCH  # warm-up + full batches
    expected = 0 if rehearse else per_forward * forwards
    rng = np.random.default_rng(seed)
    root = os.path.join(keep_dir, "serve")
    os.makedirs(root)
    t0 = time.monotonic()
    fab = fabricate(root, config, rng, torch, seed)
    log(f"serve: fabricated {IMAGES} images x {BOXES} boxes x "
        f"{config.visual_feat_dim}-d features (pickle and .bin), "
        f"{len(fab['label2ans'])} answers, mask.pt over {fab['n_masks']}"
        f" weights at zero-rate 0.7, {SERVE_REQUESTS} requests in "
        f"{time.monotonic() - t0:.1f} s")

    # the main path: bf16 (the server's default), .bin store
    fused_attention.launches = 0
    bf16, s_bf16 = _serve(root, "bfloat16", "features.bin", device,
                          rehearse, seed, "bf16_kernel")
    launches = fused_attention.launches
    log("serve: " + json.dumps(s_bf16))
    check(launches == expected,
          f"serve bf16: fused_attention launches {launches} != "
          f"{per_forward} per forward x {forwards} forwards")
    log(f"serve: bf16 run launched the attention kernel {launches} "
        f"times = {per_forward} x {forwards} forwards (warm-up included)")

    fused_attention.launches = 0
    fp32, s_fp32 = _serve(root, "float32", "features.pickle", device,
                          rehearse, seed, "fp32_kernel")
    check(fused_attention.launches == expected,
          f"serve fp32: launches {fused_attention.launches} != "
          f"{expected}")
    log("serve: " + json.dumps(s_fp32))

    # the same fp32 model with the plain attention swapped in
    saved = layers.fused_attention
    layers.fused_attention = _plain_attention
    fused_attention.launches = 0
    try:
        plain, s_plain = _serve(root, "float32", "features.pickle",
                                device, rehearse, seed, "fp32_plain")
    finally:
        layers.fused_attention = saved
    check(fused_attention.launches == 0, "plain run launched the kernel")
    log("serve: " + json.dumps(s_plain))

    same = sum(a["answer"] == b["answer"] for a, b in zip(fp32, plain))
    dprob = max(abs(a["prob"] - b["prob"]) for a, b in zip(fp32, plain))
    log(f"serve: fp32 kernel vs fp32 plain: {same}/{len(fp32)} answers "
        f"identical, max |prob diff| {dprob}")
    check(same == len(fp32), "fp32 served answers differ between the "
                             "kernel and the plain attention")
    agree = sum(a["answer"] == b["answer"] for a, b in zip(bf16, plain))
    log(f"serve: bf16 kernel vs fp32 plain: {agree}/{len(bf16)} answers "
        f"agree")

    kern_logits = _direct_logits(root, device, rehearse, seed,
                                 SERVE_BATCH, fused_attention)
    plain_logits = _direct_logits(root, device, rehearse, seed,
                                  SERVE_BATCH, _plain_attention)
    check(kern_logits.shape == (SERVE_BATCH, config.ans_num)
          and np.all(np.isfinite(kern_logits)),
          f"logits: shape {kern_logits.shape} or non-finite values")
    dlogit = float(np.abs(kern_logits - plain_logits).max())
    log(f"serve: fp32 logits kernel vs plain on {SERVE_BATCH} requests: "
        f"max |diff| {dlogit}, argmax identical "
        f"{bool(np.all(kern_logits.argmax(1) == plain_logits.argmax(1)))}")
    check(dlogit <= 1e-3 and np.all(
        kern_logits.argmax(1) == plain_logits.argmax(1)),
        f"fp32 logits: kernel vs plain max |diff| {dlogit} > 1e-3 or "
        "argmax differs")
    return {"launches": launches, "per_forward": per_forward,
            "forwards": forwards, "runs": [s_bf16, s_fp32, s_plain],
            "bf16_agreement": agree / len(bf16), "fp32_logit_diff": dlogit,
            "root": root}


def phase_profile(torch, device, seed: int) -> dict:
    """Device time by kernel over one full-width bf16 LXMERT forward at
    batch 32."""
    from crvqa_tpu_torch.models import LxmertConfig, build_lxmert

    config = LxmertConfig(dtype=torch.bfloat16)
    model = build_lxmert(config, "cpu",
                         torch.Generator().manual_seed(seed)).to(device).eval()
    g = torch.Generator().manual_seed(seed)
    inputs = dict(
        input_ids=torch.randint(1, 1000, (SERVE_BATCH, 14), generator=g
                                ).to(device),
        visual_feats=torch.randn(SERVE_BATCH, BOXES, 2048, generator=g
                                 ).to(device),
        visual_pos=torch.rand(SERVE_BATCH, BOXES, 4, generator=g).to(device),
        attention_mask=torch.ones(SERVE_BATCH, 14, device=device))
    return _profile_forward(torch, model, inputs, "profile")


def _profile_forward(torch, model, inputs, tag: str, forwards: int = 5
                     ) -> dict:
    """Device time by kernel over `forwards` calls of model(**inputs) after
    3 warm-up calls, profiled after a discarded warm-up pass
    (`_warm_profile`; report only: a profiler that records no device time
    says so)."""
    def run():
        for _ in range(forwards):
            model(**inputs)
        torch.cuda.synchronize()

    with torch.inference_mode():
        for _ in range(3):
            model(**inputs)
        torch.cuda.synchronize()
        prof, wall_ms = _warm_profile(torch, run)
        wall_ms /= forwards
    dev_us = lambda e: (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and _device_kernel(torch, e)]
    if not events:
        log(f"{tag}: the profiler recorded no device time: not measured")
        return {"measured": False}
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / forwards
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"{tag}: bf16 forward, batch {SERVE_BATCH}: host wall "
        f"{wall_ms:.3f} ms/forward (profiler on), device busy "
        f"{busy_ms:.3f} ms/forward, idle share {idle:.3f}")
    top = [{"ms": dev_us(e) / 1e3 / forwards, "calls": e.count // forwards,
            "name": e.key[:100]}
           for e in sorted(events, key=lambda e: -dev_us(e))[:12]]
    for t in top:
        log(f"{tag}: {t['ms']:9.4f} ms/forward {t['calls']:5d} "
            f"calls/forward  {t['name'][:90]}")
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": idle, "top": top}


# ---------------------------------------------------------- phases 8-9

def fabricate_mplug(root: str, rehearse: bool, rng,
                    n_requests: int = 0) -> dict:
    """What the mPLUG server reads, made from `rng`: a BERT-shaped vocab
    file (30522 lines, [PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103, question and answer words, fillers elsewhere, so every id the
    beam can emit decodes; 128 lines for the tiny rehearsal), an answer
    list of 3129 answers, uint8 [res, res, 3] images kept in memory and
    keyed by name (no image file, so no PIL), and the requests."""
    import numpy as np

    vocab_size = 128 if rehearse else 30522
    n_words = 30 if rehearse else 400
    words = iter(sorted(set(WORDS)) + ["?"] + [f"a{i}" for i in
                                                range(n_words)])
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
               103: "[MASK]"}
    tokens = [special.get(i) or next(words, f"filler{i}")
              for i in range(vocab_size)]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")
    n_answers = 40 if rehearse else MPLUG_ANSWERS
    answers = [f"a{j}" if j < n_words else
               f"a{j % n_words} a{(j // n_words) % n_words}"
               for j in range(n_answers)]
    with open(os.path.join(root, "answer_list.json"), "w") as f:
        json.dump(answers, f)
    res = 32 if rehearse else 384
    pixels = rng.integers(0, 256, (MPLUG_IMAGES, res, res, 3), dtype=np.uint8)
    images = {f"img_{i:03d}.jpg": pixels[i] for i in range(MPLUG_IMAGES)}
    names = sorted(images)
    n_requests = n_requests or (32 if rehearse else MPLUG_REQUESTS)
    with open(os.path.join(root, "requests.jsonl"), "w") as f:
        for n in range(n_requests):
            q = TEMPLATES[n % len(TEMPLATES)].format(
                SUBJECTS[int(rng.integers(len(SUBJECTS)))])
            f.write(json.dumps({"question_id": n, "question": q,
                                "image": names[int(rng.integers(
                                    len(names)))]}) + "\n")
    return {"images": images, "answers": answers, "requests": n_requests}


def _plain_midseq(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0,
                  row0=0, head0=0):
    from crvqa_tpu_torch.ops import midseq_attention as ma

    return ma.midseq_attention_reference(q, k, v, bias, num_heads, head_size,
                                         rate, seed, row0, head0)


class _PlainAttention:
    """The model's two attention kernels swapped for their plain versions
    (`models.layers` looks both up at call time) inside the block."""

    def __enter__(self):
        from crvqa_tpu_torch.models import layers

        self.saved = (layers.midseq_attention, layers.fused_attention)
        layers.midseq_attention = _plain_midseq
        layers.fused_attention = _plain_attention
        return self

    def __exit__(self, *exc):
        from crvqa_tpu_torch.models import layers

        layers.midseq_attention, layers.fused_attention = self.saved
        return False


def _mplug_args(root, device, rehearse, seed, dtype, batch, tag, extra=()):
    from crvqa_tpu_torch.cli import serve_mplug

    return serve_mplug.build_parser().parse_args(
        ["--vocab_file", os.path.join(root, "vocab.txt"),
         "--output_dir", os.path.join(root, "out"), "--dtype", dtype,
         "--seed", str(seed), "--serve_batch_size", str(batch),
         "--max_wait_ms", "5",
         "--input", os.path.join(root, "requests.jsonl"),
         "--output", os.path.join(root, f"responses_{tag}.jsonl"),
         "--device", str(device), *extra] + (["--tiny"] if rehearse else []))


def _profile_categories(torch, prof, wall_ms: float, calls: int) -> dict:
    """Device time per call of the profiled work by kernel, summed into the
    port's kernels, the cuBLAS GEMMs and the rest (the decode loop's small
    kernels: elementwise, reductions, top-k, gathers, copies)."""
    dev_us = lambda e: (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and _device_kernel(torch, e)]
    if not events:
        log("profile: the profiler recorded no device time: not measured")
        return {"measured": False}

    def category(name: str) -> str:
        if "midseq_bwd" in name:
            return "midseq_attention_bwd"
        if "midseq_attention" in name or "midseq_fwd" in name:
            return "midseq_attention_fwd"
        if "fused_attention_bwd" in name:
            return "fused_attention_bwd"
        if "fused_attention" in name:
            return "fused_attention_fwd"
        low = name.lower()
        if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma",
                                  "gemv", "sm90_")):
            return "gemm"
        return "other"

    cats: dict = {}
    launches: dict = {}
    for e in events:
        c = category(e.key)
        cats[c] = cats.get(c, 0.0) + dev_us(e) / 1e3 / calls
        launches[c] = launches.get(c, 0) + e.count // calls
    busy_ms = sum(cats.values())
    top = [{"ms": dev_us(e) / 1e3 / calls, "calls": e.count // calls,
            "name": e.key[:100]}
           for e in sorted(events, key=lambda e: -dev_us(e))[:15]]
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "by_category_ms": cats, "kernels_by_category": launches,
            "top": top}


def _serve_mplug(torch, root, images, args, device, tag, expect,
                 plain=False, profile=False) -> tuple[list, dict]:
    """Build the server (`serve_mplug.build_server` on `images`), warm it
    up, then drive the serve loop over the requests with every launch
    counter set to 0 just before and read just after. `expect` maps a
    kernel to its launches per encoded batch. With `profile`, one more
    batch of the first requests runs under the profiler."""
    import numpy as np

    from crvqa_tpu_torch.cli import serve_mplug
    from crvqa_tpu_torch.cli.serve_vqa import serve_loop

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.monotonic()
    run_batch = serve_mplug.build_server(args, device, images=images)
    build_s = time.monotonic() - t0
    with (_PlainAttention() if plain else contextlib.nullcontext()):
        warm_s = serve_mplug.warm_up(args, run_batch)
        sync()
        stats, launches = _run_counted(lambda: serve_loop(
            args, run_batch, tag=f"serve_mplug {tag}"))
        sync()
    with open(args.output) as f:
        responses = [json.loads(line) for line in f]
    with open(args.input) as f:
        requests = [json.loads(line) for line in f]
    errors = [r for r in responses if "error" in r]
    check(not errors, f"mplug {tag}: {len(errors)} error responses, first: "
                      f"{errors[:1]}")
    check([r["question_id"] for r in responses]
          == [r["question_id"] for r in requests],
          f"mplug {tag}: responses missing or out of order")
    check(all(isinstance(r["answer"], str) for r in responses),
          f"mplug {tag}: an answer is not a string")
    batches = stats["batches"]
    want = {name: 0 for name in launches}
    if not plain:
        for name, per_batch in expect.items():
            want[name] = per_batch * batches * on_card
    check(launches == want,
          f"mplug {tag}: launches {launches} != {want} ({expect} per "
          f"encoded batch x {batches} batches)")
    lat = np.asarray(stats["batch_ms"])
    summary = {"tag": tag, "dtype": args.dtype,
               "batch": args.serve_batch_size, "method": args.eval_method,
               "plain_attention": plain, "requests": stats["requests"],
               "batches": batches, "occupancy": stats["occupancy"],
               "batch_ms_p50": float(np.percentile(lat, 50)),
               "batch_ms_p99": float(np.percentile(lat, 99)),
               "batch_ms_min": float(lat.min()),
               "batch_ms_max": float(lat.max()),
               "requests_per_s": stats["requests"] / stats["wall_s"],
               "build_s": build_s, "warm_up_s": warm_s,
               "launches": launches}
    if profile and on_card:
        first = requests[:args.serve_batch_size]
        run_batch(first)
        sync()
        prof, wall_ms = _warm_profile(torch, lambda: (run_batch(first),
                                                      sync()))
        summary["profile"] = prof_out = _profile_categories(
            torch, prof, wall_ms, 1)
        if prof_out["measured"]:
            log(f"mplug-profile: one {args.dtype} batch-"
                f"{args.serve_batch_size} beam request batch: host wall "
                f"{prof_out['wall_ms']:.3f} ms (profiler on), device busy "
                f"{prof_out['busy_ms']:.3f} ms, idle share "
                f"{prof_out['idle_share']:.3f}; by category (ms) "
                f"{json.dumps(prof_out['by_category_ms'])}, kernels "
                f"{json.dumps(prof_out['kernels_by_category'])}")
            for t in prof_out["top"]:
                log(f"mplug-profile: {t['ms']:9.4f} ms {t['calls']:5d} "
                    f"calls  {t['name'][:90]}")
    log(f"mplug-serve: " + json.dumps(
        {k: v for k, v in summary.items() if k != "profile"}))
    del run_batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return responses, summary


def _mplug_direct(torch, args, images, requests, device) -> dict:
    """The served model's fp32 fused memory and first decode step's logits
    for the first batch of requests, through the kernels and through the
    plain versions (`_PlainAttention`), on one state."""
    import numpy as np

    from crvqa_tpu_torch.cli import serve_mplug, vqa_mplug
    from crvqa_tpu_torch.data.mplug_data import (_tokenize_fixed,
                                                 question_token_len)
    from crvqa_tpu_torch.train import mplug_train

    config, tokenizer, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    state = serve_mplug.build_state(args, config, model, masker, device)
    reqs = requests[:args.serve_batch_size]
    ids, mask = _tokenize_fixed(tokenizer, [r["question"] for r in reqs],
                                question_token_len(args.add_ocr,
                                                   args.max_input_length))
    batch = (torch.from_numpy(np.stack([images[r["image"]] for r in reqs]))
             .to(device), torch.from_numpy(ids).to(device, torch.long),
             torch.from_numpy(mask).to(device))

    def first_step(m, images_, ids_, mask_):
        states, state_mask = m.encode(images_, ids_, mask_)
        bos = torch.full((states.shape[0], 1), config.bos_token_id,
                         dtype=torch.long, device=states.device)
        logits = m.decode_logits(bos, torch.ones(bos.shape, device=device),
                                 states, state_mask)
        return states, logits[:, 0]

    (states_k, logits_k), launches = _run_counted(
        lambda: mplug_train.run_masked(model, masker, state, first_step,
                                       *batch))
    with _PlainAttention():
        states_p, logits_p = mplug_train.run_masked(model, masker, state,
                                                    first_step, *batch)
    check(bool(torch.isfinite(logits_k).all()) and logits_k.shape
          == (len(reqs), config.bert.vocab_size),
          f"mplug direct: logits {tuple(logits_k.shape)} or non-finite")
    out = {"batch": len(reqs),
           "states_max_abs_diff": (states_k - states_p).abs().max().item(),
           "states_max_abs": states_p.abs().max().item(),
           "logits_max_abs_diff": (logits_k - logits_p).abs().max().item(),
           "logits_max_abs": logits_p.abs().max().item(),
           "argmax_equal": bool(torch.equal(logits_k.argmax(-1),
                                            logits_p.argmax(-1))),
           "launches": launches}
    del state, model
    gc.collect()
    return out


def phase_mplug_serve(torch, device, rehearse: bool, seed: int) -> dict:
    """mPLUG serving at full width: beam 5 at batch 8 (the main path) and
    32 in bf16, rank at batch 8 in bf16, beam at batch 8 in fp32 through
    the kernels and through the plain attentions, and bf16 beam at batch 8
    through the plain attentions; then the direct fp32 check."""
    import numpy as np

    rng = np.random.default_rng(seed)
    beam = {"midseq_attention_fwd": 18, "fused_attention_fwd": 11}
    # rank with 0 < k_test < answers: + the bos-only pass (12 at (1,602),
    # 12 short at (1,1)) and the shortlist pass (12 at (120,602))
    rank = {"midseq_attention_fwd": 42, "fused_attention_fwd": 23}
    if rehearse:  # tiny widths: every attention is short or eager
        beam = rank = {}
    out: dict = {"runs": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mplug_") as root:
        t0 = time.monotonic()
        fab = fabricate_mplug(root, rehearse, rng)
        images = fab["images"]
        log(f"mplug-serve: fabricated a {'128' if rehearse else '30522'}-"
            f"line vocab, {len(fab['answers'])} answers, {len(images)} "
            f"uint8 images, {fab['requests']} requests in "
            f"{time.monotonic() - t0:.1f} s")
        args = lambda *a, **kw: _mplug_args(root, device, rehearse, seed,
                                            *a, **kw)
        rank_flags = ("--eval_method", "rank", "--answer_list",
                      os.path.join(root, "answer_list.json"),
                      "--k_test", str(MPLUG_K_TEST))
        runs = {}
        # the main path: bf16 beam at batch 8, profiled after
        runs["bf16_b8"], main = _serve_mplug(
            torch, root, images, args("bfloat16", 8, "bf16_b8"), device,
            "bf16_b8", beam, profile=True)
        out["main_launches"] = main["launches"]
        out["runs"].append(main)
        for tag, dtype, batch, extra, expect, plain in (
                ("bf16_b32", "bfloat16", 32, (), beam, False),
                ("bf16_rank_b8", "bfloat16", 8, rank_flags, rank, False),
                ("fp32_b8", "float32", 8, (), beam, False),
                ("fp32_b8_plain", "float32", 8, (), beam, True),
                ("bf16_b8_plain", "bfloat16", 8, (), beam, True)):
            runs[tag], summary = _serve_mplug(
                torch, root, images, args(dtype, batch, tag, extra), device,
                tag, expect, plain=plain)
            out["runs"].append(summary)
        answers = lambda tag: [r["answer"] for r in runs[tag]]
        check(all(a in fab["answers"] for a in answers("bf16_rank_b8")),
              "mplug rank: an answer outside the answer list")
        same = lambda a, b: sum(x == y for x, y in zip(answers(a),
                                                       answers(b)))
        out["bf16_b8_vs_b32_same"] = same("bf16_b8", "bf16_b32")
        out["fp32_kernel_vs_plain_same"] = same("fp32_b8", "fp32_b8_plain")
        out["bf16_kernel_vs_plain_same"] = same("bf16_b8", "bf16_b8_plain")
        out["bf16_vs_fp32_same"] = same("bf16_b8", "fp32_b8")
        n = len(runs["fp32_b8"])
        log(f"mplug-serve: answers, kernels vs plain attentions: fp32 "
            f"{out['fp32_kernel_vs_plain_same']}/{n}, bf16 "
            f"{out['bf16_kernel_vs_plain_same']}/{n} identical; bf16 vs "
            f"fp32 (kernels) {out['bf16_vs_fp32_same']}/{n}; bf16 batch 8 "
            f"vs 32 {out['bf16_b8_vs_b32_same']}/{n}")
        check(out["fp32_kernel_vs_plain_same"] == n,
              "mplug fp32 answers differ between the kernels and the plain "
              "attentions")
        with open(os.path.join(root, "requests.jsonl")) as f:
            requests = [json.loads(line) for line in f]
        direct = _mplug_direct(torch, args("float32", 8, "direct"), images,
                               requests, device)
    log("mplug-serve: fp32 direct, kernels vs plain: " + json.dumps(direct))
    # fp32 through 24 encoder layers and the decoder; the kernels sum in
    # another order than the plain versions' cuBLAS products
    check(direct["states_max_abs_diff"] <= 1e-3
          and direct["logits_max_abs_diff"] <= 1e-3 and direct["argmax_equal"],
          f"mplug fp32 memory or first-step logits: kernels vs plain "
          f"differ: {direct} (tolerance 1e-3 absolute, argmax equal)")
    out["direct"] = direct
    return out


# ----------------------------------------------------------------- phase 7

def _counters() -> dict:
    """Each kernel's wrapper, by the name its launch counter reports."""
    from crvqa_tpu_torch.ops import fused_attention as fa
    from crvqa_tpu_torch.ops import masked_matmul as mm
    from crvqa_tpu_torch.ops import midseq_attention as ma
    from crvqa_tpu_torch.ops import structured_matmul as sm

    return {"midseq_attention_fwd": ma.midseq_attention,
            "midseq_attention_bwd": ma.midseq_attention_bwd,
            "fused_attention_fwd": fa.fused_attention,
            "fused_attention_fwd_train": fa.fused_attention_fwd_train,
            "fused_attention_bwd_stored": fa.fused_attention_bwd_stored,
            "fused_attention_bwd_recompute": fa.fused_attention_bwd_recompute,
            "masked_matmul_fwd": mm.masked_matmul_fwd,
            "masked_matmul_dx": mm.masked_matmul_dx,
            "masked_matmul_ds": mm.masked_matmul_ds,
            "masked_matmul_operand_pass": mm.operand_pass,
            "head_compact_matmul": sm.head_compact_matmul_pallas,
            "head_compact_operand_pass": sm.operand_pass}


def _launch_counts(on_card: bool = True, **counts) -> dict:
    """Every counter's expected launches: `counts` where given, else 0 (all
    0 off the card, where the plain versions run)."""
    return {name: counts.get(name, 0) * on_card for name in _counters()}


def _run_counted(fn):
    """fn() with every launch counter set to 0 just before it and read just
    after: (fn's result, {kernel: launches})."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    result = fn()
    return result, {name: c.launches for name, c in counters.items()}


def phase_train(torch, device, rehearse: bool, seed: int, keep_dir: str
                ) -> dict:
    """The stage-2 CLI at full width (module docstring, phase 9); the
    exported mask.pt and classifier4masker.bin are kept in
    `keep_dir`/stage2 for phase stage3."""
    import numpy as np

    from crvqa_tpu_torch.cli import prune_debias_vqa
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.ops import fused_attention as fa

    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    fwd_mult, bwd_mult = launch_mult(config)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    on_card = not rehearse
    steps = N_TRAIN // TRAIN_BATCH * TRAIN_EPOCHS
    evals = 1 + steps // SAVE_STEPS  # the pre-train eval + each save
    eval_batches = evals * -(-N_TEST // TRAIN_BATCH)
    targets = {"Lang": 0.7, "Vis": 0.7, "Fus": 0.7, "P": 0.7}
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        fabricate(root, config, rng, torch, seed)

        def argv(out, epochs, *extra):
            return ["--output_dir", out, "--dataroot", root,
                    "--img_root", os.path.join(root, "features.bin"),
                    "--vocab_file", os.path.join(root, "vocab.txt"),
                    "--device", str(device), "--dtype", "bfloat16",
                    "--train_batch_size", str(TRAIN_BATCH),
                    "--eval_batch_size", str(TRAIN_BATCH),
                    "--num_train_epochs", str(epochs),
                    "--logging_steps", str(LOGGING_STEPS),
                    "--save_steps", str(SAVE_STEPS),
                    "--Lang_comp", "0.3", "--Vis_comp", "0.3",
                    "--Fus_comp", "0.3", "--zero_rate", "0.7",
                    "--controlled_init", "magnitude", "--Masker_type", "lmh",
                    "--name_of_masker", "MaskedLinear1", "--do_train",
                    "--seed", str(seed), *extra] + (
                        ["--tiny"] if rehearse else [])

        # the main path: the stored backward (the default)
        out = os.path.join(root, "stage2")
        t0 = time.monotonic()
        summary, launches = _run_counted(lambda: prune_debias_vqa.main(
            argv(out, TRAIN_EPOCHS, "--evaluate_during_training")))
        wall_s = time.monotonic() - t0
        losses = summary["losses"]
        log(f"train: {len(losses)} steps at batch {TRAIN_BATCH} in "
            f"{wall_s:.1f} s (set-up, evals and checkpoint included); "
            f"losses {[round(x, 4) for x in losses]}; launches {launches}; "
            f"zero rates {summary['zero_rates']}; best eval acc "
            f"{summary['best_acc']}")
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"train: {len(losses)} losses (want {steps}), finite: "
              f"{bool(np.all(np.isfinite(losses)))}")
        want = _launch_counts(
            on_card, fused_attention_fwd_train=per_fwd * steps,
            fused_attention_bwd_stored=per_bwd * steps,
            fused_attention_fwd=per_fwd * eval_batches)
        check(launches == want,
              f"train: launches {launches} != {want} ({per_fwd} forward and "
              f"{per_bwd} backward per step x {steps} steps, {per_fwd} per "
              f"eval batch x {eval_batches})")
        rates = summary["zero_rates"]
        check(all(abs(rates[m] - t) <= 0.01 for m, t in targets.items()),
              f"train: zero rates after the reset {rates} miss {targets}")
        for name in ("mask.pt", "classifier4masker.bin", "test.json",
                     f"ckpt_{SAVE_STEPS}"):
            check(os.path.exists(os.path.join(out, name)),
                  f"train: {name} not written")
        with open(os.path.join(out, "test.json")) as f:
            check(len(json.load(f)) == N_TEST, "train: test.json incomplete")
        kept = os.path.join(keep_dir, "stage2")
        os.makedirs(kept)
        for name in ("mask.pt", "classifier4masker.bin"):
            shutil.copy(os.path.join(out, name), kept)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        ex_s = [x["ex_s"] for x in logged if "ex_s" in x]

        # the exported subnetwork, served on the card
        (_, served), serve_launches = _run_counted(lambda: _serve(
            root, "bfloat16", "features.bin", device, rehearse, seed,
            "stage2_export", artifacts=out))
        forwards = 1 + SERVE_REQUESTS // SERVE_BATCH
        check(serve_launches["fused_attention_fwd"]
              == per_fwd * forwards * on_card,
              f"serving the export: launches {serve_launches}")
        log("train: served the exported mask.pt and classifier4masker.bin: "
            + json.dumps(served))

        # the recompute backward (BWD_IMPL = "recompute"), its own path
        saved, fa.BWD_IMPL = fa.BWD_IMPL, "recompute"
        try:
            rsummary, rlaunches = _run_counted(lambda: prune_debias_vqa.main(
                argv(os.path.join(root, "stage2_recompute"),
                     RECOMPUTE_EPOCHS)))
        finally:
            fa.BWD_IMPL = saved
        rsteps = N_TRAIN // TRAIN_BATCH * RECOMPUTE_EPOCHS
        rwant = _launch_counts(
            on_card, fused_attention_fwd_train=per_fwd * rsteps,
            fused_attention_bwd_recompute=per_bwd * rsteps)
        rlosses = rsummary["losses"]
        log(f"train: recompute backward, {len(rlosses)} steps: losses "
            f"{[round(x, 4) for x in rlosses]}; launches {rlaunches}")
        check(len(rlosses) == rsteps and all(np.isfinite(rlosses)),
              "train (recompute): losses missing or not finite")
        check(rlaunches == rwant,
              f"train (recompute): launches {rlaunches} != {rwant}")
    return {"steps": steps, "losses": losses, "launches": launches,
            "per_forward": per_fwd, "per_backward": per_bwd,
            "eval_batches": eval_batches, "zero_rates": rates,
            "best_acc": summary["best_acc"], "logged_ex_s": ex_s,
            "wall_s": wall_s, "served": served, "artifacts": kept,
            "recompute": {"steps": rsteps, "losses": rlosses,
                          "launches": rlaunches}}


# ----------------------------------------------------------------- phase 8

def _stage2_setup(torch, config, device, seed, batch_size,
                  structured: str = "none"):
    """A stage-2 state at `config` in the canonical configuration (with
    `structured` "heads" or "layers": gates on the specs matching "self",
    the CLI's default) and one synthetic batch on the device."""
    import dataclasses

    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.masking.structured import StructuredMasker
    from crvqa_tpu_torch.models import build_lxmert
    from crvqa_tpu_torch.train import stage2

    specs = lxmert_mask_specs(config.l_layers, config.r_layers,
                              config.x_layers)
    sparsity = ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7)
    masker = (Masker.create(specs, sparsity, controlled_init="magnitude")
              if structured == "none" else StructuredMasker.create(
                  specs, sparsity, controlled_init="magnitude",
                  structured_masking=structured,
                  num_heads=config.num_attention_heads))
    params = build_lxmert(dataclasses.replace(config, dtype=torch.float32),
                          "cpu", torch.Generator().manual_seed(seed)
                          ).state_dict()
    cfg = stage2.Stage2Config(masker_type="lmh", total_steps=1000,
                              hidden_size=config.hidden_size)
    model = stage2.lxmert_meta_model(config)
    state, tx = stage2.init_state(model, masker, params, cfg, seed, device)
    batch = to_device(synthetic_batch(
        batch_size=batch_size, seed=seed, vocab_size=config.vocab_size,
        ans_num=config.ans_num, feat_dim=config.visual_feat_dim,
        pos_dim=config.visual_pos_dim), device,
        float_dtype=config.dtype if config.dtype == torch.bfloat16 else None)
    return model, masker, cfg, state, tx, batch


def phase_step(torch, device, rehearse: bool, seed: int) -> dict:
    """Timed steps and a profiled step at full width, batch 256, bf16; then
    one full-width fp32 step with dropout on through the kernels and through
    the plain versions from the same generators."""
    import numpy as np

    from crvqa_tpu_torch.models import LxmertConfig, layers
    from crvqa_tpu_torch.train import stage2

    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    config = (LxmertConfig.tiny(dtype=torch.bfloat16) if rehearse
              else LxmertConfig(dtype=torch.bfloat16))
    model, masker, cfg, state, tx, batch = _stage2_setup(
        torch, config, device, seed, TRAIN_BATCH)
    step = stage2.make_train_step(model, masker, tx, cfg)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    sync()
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = []
    for _ in range(TIMED_STEPS):
        state, m = step(state, batch)
        losses.append(m.loss)
    sync()
    dt = time.monotonic() - t0
    losses = [float(x) for x in losses]
    out = {"batch": TRAIN_BATCH, "timed_steps": TIMED_STEPS,
           "step_ms": 1e3 * dt / TIMED_STEPS,
           "examples_per_s": TIMED_STEPS * TRAIN_BATCH / dt,
           "losses": losses}
    check(all(np.isfinite(losses)), f"timed steps: losses {losses}")
    if not rehearse:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["profile"] = _profile_steps(torch, lambda: step(state, batch))
    log("step: " + json.dumps(out))
    del model, state, tx, batch, step
    if not rehearse:
        torch.cuda.empty_cache()

    # the whole-step check: kernels vs plain versions, fp32, dropout on
    config = (LxmertConfig.tiny() if rehearse else LxmertConfig())
    model, masker, cfg, state, tx, batch = _stage2_setup(
        torch, config, device, seed + 1, CHECK_BATCH)
    fn = stage2.make_loss_and_grads(model, masker, cfg)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    (loss_k, _, grads_k), launches = _run_counted(lambda: fn(state, batch))
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    saved, layers.fused_attention = layers.fused_attention, _plain_attention
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    sync()
    scores = [k for k in grads_k if k.startswith("scores/")]
    gmax = max(grads_p[k].abs().max().item() for k in scores)
    dmax = max((grads_k[k] - grads_p[k]).abs().max().item() for k in scores)
    dloss = abs(loss_k.item() - loss_p.item())
    check_out = {"batch": CHECK_BATCH, "loss_kernels": loss_k.item(),
                 "loss_plain": loss_p.item(), "loss_abs_diff": dloss,
                 "score_grad_max": gmax, "score_grad_max_abs_diff": dmax,
                 "launches": launches}
    log("step check: " + json.dumps(check_out))
    # fp32 throughout; the kernels sum in another order than the plain
    # versions' cuBLAS products, and the difference travels 19 layers
    check(dloss <= 1e-4 * abs(loss_p.item())
          and dmax <= 1e-3 * gmax,
          f"one fp32 step with dropout: kernels vs plain versions differ: "
          f"{check_out} (tolerances: loss 1e-4 relative, score gradients "
          f"1e-3 of their largest)")
    out["check"] = check_out
    return out


def _profile_steps(torch, fn, steps: int = 2) -> dict:
    """Device time by kernel over `steps` calls of fn, profiled after a
    discarded warm-up pass of `steps` more (`_warm_profile`; report only:
    a profiler that records no device time says so)."""
    def run():
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    prof, wall_ms = _warm_profile(torch, run)
    wall_ms /= steps
    dev_us = lambda e: (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and _device_kernel(torch, e)]
    if not events:
        log("profile: the profiler recorded no device time: not measured")
        return {"measured": False}
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = [{"ms": dev_us(e) / 1e3 / steps, "calls": e.count // steps,
            "name": e.key[:100]}
           for e in sorted(events, key=lambda e: -dev_us(e))[:15]]
    log(f"profile: train step: host wall {wall_ms:.3f} ms/step (profiler "
        f"on), device busy {busy_ms:.3f} ms/step, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for t in top:
        log(f"profile: {t['ms']:9.4f} ms/step {t['calls']:5d} calls/step  "
            f"{t['name'][:90]}")
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms), "top": top}



# ------------------------------------------------------- phases 11-13

def _midseq_bwd_bound_terms(b, sq, sk, dtype):
    """(bytes ms, FLOPs ms) of one mid-length backward call: q, g, k, v and
    the fp32 bias read once, dq, dk, dv written once; five products of
    2·B·H·Sq·Sk·D FLOPs (scores, dp, dv, dq, dk)."""
    item = 2 if dtype == "bfloat16" else 4
    d = 12 * 64
    nbytes = item * b * d * (3 * sq + 4 * sk) + 4 * b * sk
    flops = 10 * b * 12 * sq * sk * 64
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def phase_midseq_bwd_kernel(torch, device, rehearse: bool, seed: int
                            ) -> list[dict]:
    import torch.nn.functional as F

    from crvqa_tpu_torch.ops import midseq_attention as ma

    rows = []
    b = 2 if rehearse else MPLUG_TRAIN_BATCH
    for dtype in ("float32", "bfloat16"):
        for rate in TRAIN_RATES:
            for sq, sk in MIDSEQ_TRAIN_SHAPES:
                q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                                  device, seed + 5 * sq + sk)
                gen = torch.Generator().manual_seed(seed + sq + sk)
                g = torch.randn(q.shape, generator=gen).to(device, q.dtype)
                args = (12, 64, rate, KERNEL_SEED)
                got = ma.midseq_attention_bwd(q, k, v, bias, g, *args)
                again = ma.midseq_attention_bwd(q, k, v, bias, g, *args)
                ref = ma.midseq_attention_bwd_reference(q, k, v, bias, g,
                                                        *args)
                if not rehearse:
                    torch.cuda.synchronize()
                errs = [_max_err(torch, [a], [r]) for a, r in zip(got, ref)]
                same = all(torch.equal(a, c) for a, c in zip(got, again))
                ok = all(torch.allclose(a.float(), r.float(),
                                        **MIDSEQ_BWD_TOL[dtype])
                         for a, r in zip(got, ref))
                row = {"batch": b, "dtype": dtype, "rate": rate, "sq": sq,
                       "sk": sk, "dq_err": errs[0], "dk_err": errs[1],
                       "dv_err": errs[2], "max_abs_err": max(errs),
                       "grad_max_abs": max(r.float().abs().max().item()
                                           for r in ref),
                       "bit_identical": same, "ok": ok}
                row["bytes_ms"], row["ops_ms"] = _midseq_bwd_bound_terms(
                    b, sq, sk, dtype)
                row["bound_ms"], row["bound_by"] = _bound(row["bytes_ms"],
                                                          row["ops_ms"])
                if rate == MAIN_RATE and not rehearse:
                    split = lambda t: (t.view(b, t.shape[1], 12, 64)
                                       .transpose(1, 2).detach()
                                       .requires_grad_())
                    qh, kh, vh = split(q), split(k), split(v)
                    gh = g.view(b, sq, 12, 64).transpose(1, 2)
                    mask = bias.to(q.dtype)[:, None, None, :]
                    kw = dict(reps=4, replays=5)  # calls of milliseconds
                    row["ms"] = _graph_ms(torch, lambda: (
                        ma.midseq_attention_bwd(q, k, v, bias, g, *args)),
                        **kw)
                    row["plain_ms"] = _graph_ms(torch, lambda: (
                        ma.midseq_attention_bwd_reference(q, k, v, bias, g,
                                                          *args)), **kw)
                    row["library_ms"] = _graph_ms(
                        torch, lambda: torch.autograd.grad(
                            F.scaled_dot_product_attention(
                                qh, kh, vh, attn_mask=mask, dropout_p=rate),
                            (qh, kh, vh), gh), **kw)
                    row["fwd_ms"] = _graph_ms(torch, lambda: (
                        ma.midseq_attention(q, k, v, bias, *args)), **kw)
                    row["fwd_library_ms"] = _graph_ms(torch, lambda: (
                        F.scaled_dot_product_attention(
                            qh, kh, vh, attn_mask=mask, dropout_p=rate)),
                        **kw)
                    t_bytes, t_ops = _bound_terms(b, sq, sk, dtype)
                    row["fwd_bound_ms"] = max(t_bytes, t_ops)
                rows.append(row)
                log("midseq-bwd-kernel: " + json.dumps(row))
                check(ok, f"midseq_attention_bwd disagrees with its plain "
                          f"version at B={b} {dtype} rate {rate} ({sq},{sk}): "
                          f"{row} (tolerance {MIDSEQ_BWD_TOL[dtype]})")
                check(same, f"midseq_attention_bwd: two launches differ at "
                            f"B={b} {dtype} rate {rate} ({sq},{sk})")
    return rows


def _mplug_train_launches(steps, eval_batches=0, mode="mask", distill=False,
                          on_card=True, checkpoint=False) -> dict:
    """Launches of `steps` mPLUG train steps and `eval_batches` beam
    batches (`MIDSEQ_FWD_PER_STEP`, `MIDSEQ_BWD_PER_STEP`, `SHORT_PER_STEP`;
    18 mid-length and 11 short per encoded eval batch). `checkpoint`
    (`--use_checkpoint`): every attention of a training forward sits in a
    checkpointed layer, so its forward runs again in the backward."""
    fwd = sum(MIDSEQ_FWD_PER_STEP.values())
    bwd = fwd if mode == "full" else sum(MIDSEQ_BWD_PER_STEP.values())
    twin = steps if distill else 0  # the twins' forward, eval mode
    runs = 2 if checkpoint else 1
    return _launch_counts(
        on_card,
        midseq_attention_fwd=fwd * (runs * steps + twin) + 18 * eval_batches,
        midseq_attention_bwd=bwd * steps,
        fused_attention_fwd=SHORT_PER_STEP * (twin + eval_batches),
        fused_attention_fwd_train=SHORT_PER_STEP * runs * steps,
        fused_attention_bwd_stored=SHORT_PER_STEP * steps)


def phase_mplug_train(torch, device, rehearse: bool, seed: int) -> dict:
    import numpy as np

    from crvqa_tpu_torch.cli import vqa_mplug

    on_card = not rehearse
    bs = MPLUG_TRAIN_BATCH
    per_epoch = MPLUG_SYNTHETIC // bs
    out: dict = {}
    rng = np.random.default_rng(seed + 17)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mplug_train_") as root:
        fab = fabricate_mplug(root, rehearse, rng, n_requests=32)

        def argv(tag, epochs, *extra):
            return ["--output_dir", os.path.join(root, tag), "--device",
                    str(device), "--dtype", "bfloat16", "--seed", str(seed),
                    "--zero_rate", "0.5", "--init_sparsity", "0.3",
                    "--final_sparsity_epoch", "1", "--synthetic",
                    str(MPLUG_SYNTHETIC), "--synthetic_shapes",
                    MPLUG_TRAIN_SHAPES, "--train_batch_size", str(bs),
                    "--eval_batch_size", str(bs), "--num_train_epochs",
                    str(epochs), "--masker_update_step", "2",
                    "--logging_steps", "2", "--save_steps", "6",
                    *extra] + (["--tiny"] if rehearse else [])

        def run(tag, epochs, *extra, **expect):
            t0 = time.monotonic()
            summary, launches = _run_counted(lambda: vqa_mplug.main(
                argv(tag, epochs, *extra)))
            wall_s = time.monotonic() - t0
            losses = summary["losses"]
            log(f"mplug-train {tag}: {len(losses)} steps at batch {bs} in "
                f"{wall_s:.1f} s (set-up, resets, checkpoints and eval "
                f"included); losses {[round(x, 4) for x in losses]}; resets "
                f"{summary['resets']}; zero rates {summary['zero_rates']}; "
                f"launches {launches}")
            check(all(np.isfinite(losses)),
                  f"mplug-train {tag}: losses {losses}")
            want = _mplug_train_launches(on_card=on_card, **expect)
            if rehearse:  # tiny widths: every attention is short or eager
                want = {k: 0 for k in want}
            check(launches == want,
                  f"mplug-train {tag}: launches {launches} != {want}")
            for _, target, achieved in summary["resets"]:
                check(abs(target - achieved) <= (0.02 if rehearse else 2e-3),
                      f"mplug-train {tag}: zero rate {achieved} after a reset "
                      f"to {target}")
            del summary["state"]  # GBs on the card; the checks are done
            return dict(summary, wall_s=wall_s, launches=launches)

        # the main path: mask mode, 8 steps, resets at 2 4 6 8, ckpt_6,
        # beam evaluation of 4 batches, mask.pt, ckpt_final
        steps = 2 * per_epoch
        main = run("mask", 2, "--do_train", "--do_eval", steps=steps,
                   eval_batches=per_epoch)
        main_dir = os.path.join(root, "mask")
        check(len(main["losses"]) == steps and main["step"] == steps,
              f"mplug-train: {len(main['losses'])} steps, want {steps}")
        check(len(main["resets"]) == steps // 2
              and main["resets"][0][1] < main["resets"][-1][1] == 0.5,
              f"mplug-train: resets {main['resets']} (want {steps // 2} on a "
              "rising target ending at 0.5)")
        check(abs(main["zero_rates"]["all"] - 0.5) <= (
            0.02 if rehearse else 2e-3),
            f"mplug-train: final zero rates {main['zero_rates']}")
        for name in ("mask.pt", "mask_config.json", "ckpt_6", "ckpt_final",
                     "vqa_result.json", "metrics.jsonl"):
            check(os.path.exists(os.path.join(main_dir, name)),
                  f"mplug-train: {name} not written")
        check(main["num_predictions"] == MPLUG_SYNTHETIC,
              f"mplug-train: {main['num_predictions']} predictions")
        with open(os.path.join(main_dir, "metrics.jsonl")) as f:
            main["logged_ex_s"] = [x["ex_s"] for x in map(json.loads, f)
                                   if "ex_s" in x]
        out["main"] = main

        # resume from the checkpoint: 4 more steps from step 6
        resumed = run("resume", 1, "--do_train", "--resume_from",
                      os.path.join(main_dir, "ckpt_6"), steps=per_epoch)
        check(resumed["step"] == 6 + per_epoch,
              f"mplug-train resume: ended at step {resumed['step']}")
        out["resume"] = resumed

        # serve what the resumed run wrote
        args = _mplug_args(
            root, device, rehearse, seed, "bfloat16", 8, "ckpt",
            ("--ckpt", os.path.join(root, "resume", "ckpt_final"),
             "--zero_rate", "0.5"))
        beam = ({} if rehearse else
                {"midseq_attention_fwd": 18, "fused_attention_fwd": 11})
        _, served = _serve_mplug(torch, root, fab["images"], args, device,
                                 "ckpt", beam)
        out["served"] = served

        # the other training modes, fewer steps
        half = ("--synthetic", str(2 * bs), "--save_steps", "0")
        out["full"] = run("full", 1, "--do_train", "--mode", "full", *half,
                          steps=2, mode="full")
        out["distill"] = run("distill", 1, "--do_train", "--distill", "true",
                             *half, steps=2, distill=True)
    return out


def _mplug_train_setup(torch, device, rehearse, seed, dtype, batch_size,
                       extra=(), params=None):
    """An mPLUG mask-training state at full width (the CLI's own build
    functions and defaults, plus the flags `extra`) and one synthetic batch
    on the device. `params`: the fp32 initial weights on the CPU, when the
    caller holds them already (`init_state` does not change them)."""
    from crvqa_tpu_torch.cli import vqa_mplug
    from crvqa_tpu_torch.data.mplug_data import synthetic_mplug_batch
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.train import mplug_train

    args = vqa_mplug.build_parser().parse_args(
        ["--output_dir", "unused", "--dtype", dtype, "--seed", str(seed),
         *extra] + (["--tiny"] if rehearse else []))
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 100)
    state = mplug_train.init_state(
        model, params if params is not None
        else vqa_mplug.initial_params(args, config), cfg, device,
        masker=masker, seed=seed, train=True)
    ql, al, apq = (int(x) for x in MPLUG_TRAIN_SHAPES.split(","))
    batch = to_device(synthetic_mplug_batch(
        batch_size=batch_size, image_res=config.vit.image_res, q_len=ql,
        a_len=al, answers_per_question=apq, uint8_images=True,
        vocab_size=config.bert.vocab_size, seed=seed), device)
    return model, masker, cfg, state, batch


def phase_mplug_step(torch, device, rehearse: bool, seed: int) -> dict:
    """Timed steps and two profiled steps at full width, batch 16, bf16,
    mask mode; then one fp32 step at batch 8 with dropout on through the
    kernels and through the plain attentions from the same generators."""
    import numpy as np

    from crvqa_tpu_torch.train import mplug_train

    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    bs = MPLUG_TRAIN_BATCH
    model, masker, cfg, state, batch = _mplug_train_setup(
        torch, device, rehearse, seed, "bfloat16", bs)
    step = mplug_train.make_train_step(model, cfg, masker)
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    sync()
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = []
    (_, launches) = _run_counted(lambda: [
        losses.append(step(state, batch)[1]) for _ in range(TIMED_STEPS)])
    sync()
    dt = time.monotonic() - t0
    losses = [float(x) for x in losses]
    out = {"batch": bs, "timed_steps": TIMED_STEPS,
           "step_ms": 1e3 * dt / TIMED_STEPS,
           "examples_per_s": TIMED_STEPS * bs / dt, "losses": losses,
           "launches": launches}
    check(all(np.isfinite(losses)), f"mplug-step: losses {losses}")
    check(rehearse or launches == _mplug_train_launches(TIMED_STEPS),
          f"mplug-step: launches {launches} != "
          f"{_mplug_train_launches(TIMED_STEPS)}")
    if not rehearse:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        sync()

        def two_steps():
            for _ in range(2):
                step(state, batch)
            sync()

        prof, wall_ms = _warm_profile(torch, two_steps)
        out["profile"] = prof_out = _profile_categories(
            torch, prof, wall_ms / 2, 2)
        if prof_out["measured"]:
            log(f"mplug-step profile: one bf16 batch-{bs} mask-training "
                f"step: host wall {prof_out['wall_ms']:.3f} ms (profiler "
                f"on), device busy {prof_out['busy_ms']:.3f} ms, idle share "
                f"{prof_out['idle_share']:.3f}; by category (ms) "
                f"{json.dumps(prof_out['by_category_ms'])}, kernels "
                f"{json.dumps(prof_out['kernels_by_category'])}")
            for t in prof_out["top"]:
                log(f"mplug-step profile: {t['ms']:9.4f} ms {t['calls']:5d} "
                    f"calls  {t['name'][:90]}")
    log("mplug-step: " + json.dumps(
        {k: v for k, v in out.items() if k != "profile"}))
    del model, state, batch, step
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()

    # the whole-step check: kernels vs plain attentions, fp32, dropout on
    model, masker, cfg, state, batch = _mplug_train_setup(
        torch, device, rehearse, seed + 1, "float32", MPLUG_CHECK_BATCH)
    fn = mplug_train.make_loss_and_grads(model, cfg, masker)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    (loss_k, grads_k), launches = _run_counted(lambda: fn(state, batch))
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    with _PlainAttention():
        loss_p, grads_p = fn(state, batch)
    sync()
    scores = [k for k in grads_k if k.startswith("scores/")]
    gmax = max(grads_p[k].abs().max().item() for k in scores)
    dmax = max((grads_k[k] - grads_p[k]).abs().max().item() for k in scores)
    dloss = abs(loss_k.item() - loss_p.item())
    check_out = {"batch": MPLUG_CHECK_BATCH, "loss_kernels": loss_k.item(),
                 "loss_plain": loss_p.item(), "loss_abs_diff": dloss,
                 "score_grad_max": gmax, "score_grad_max_abs_diff": dmax,
                 "launches": launches}
    log("mplug-step check: " + json.dumps(check_out))
    # fp32 throughout; the kernels sum in another order than the plain
    # versions' cuBLAS products, and the difference travels 36 layers
    check(dloss <= 1e-4 * abs(loss_p.item()) and dmax <= 1e-3 * gmax,
          f"one fp32 mPLUG step with dropout: kernels vs plain attentions "
          f"differ: {check_out} (tolerances: loss 1e-4 relative, score "
          f"gradients 1e-3 of their largest)")
    check(rehearse or launches == _mplug_train_launches(1),
          f"mplug-step check: launches {launches}")
    out["check"] = check_out
    del model, state, batch, fn, grads_k, grads_p
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- phase 22

MPLUG_FILES_TRAIN = 32       # records: 2 steps at batch 16
MPLUG_FILES_IMAGES = 16      # PNG files, 480 x 400, uint8 RGB
MPLUG_PRETRAIN_RES = 224     # the .pth's resolution: 197 positions
MPLUG_OPT_STEPS = 2
MPLUG_TIMED = dict(warmup=1, steps=4)
ADAHESSIAN_BATCH = 16


def fabricate_mplug_files(root: str, rehearse: bool, rng) -> dict:
    """mPLUG's training files, made from `rng`: `fabricate_mplug`'s vocab,
    PNG images (480 x 400: RandomResizedCrop has room to move), and
    train / test annotation JSONs of the reference's records (question,
    image, answers with their bias)."""
    import numpy as np
    from PIL import Image

    fab = fabricate_mplug(root, rehearse, rng, n_requests=8)
    os.makedirs(os.path.join(root, "imgs"))
    names = []
    for i in range(MPLUG_FILES_IMAGES):
        name = f"imgs/img_{i:03d}.png"
        Image.fromarray(rng.integers(0, 256, (400, 480, 3), dtype=np.uint8)
                        ).save(os.path.join(root, name))
        names.append(name)
    answers = fab["answers"][:40]

    def records(n, qid0):
        out = []
        for i in range(n):
            ans = [answers[int(rng.integers(len(answers)))]
                   for _ in range(5)]
            out.append({"image": names[i % len(names)],
                        "question": TEMPLATES[i % len(TEMPLATES)].format(
                            SUBJECTS[i % len(SUBJECTS)]),
                        "question_id": qid0 + i, "answer": ans,
                        "bias": [float(rng.random() * 0.5) for _ in ans]})
        return out

    for split, n, qid0 in (("train", MPLUG_FILES_TRAIN, 0),
                           ("test", 8, 10000)):
        with open(os.path.join(root, f"vqa_{split}.json"), "w") as f:
            json.dump(records(n, qid0), f)
    return {"names": names}


def _pretrain_checkpoint(torch, args, config, path, rng) -> dict:
    """The port's seeded fp32 weights written as the reference's
    pretraining checkpoint: `{"model": ...}`, the text and fusion towers
    under `bert.` / `fusion.`, the positional embedding at
    `MPLUG_PRETRAIN_RES`, plus what the model has no parameter for (the
    tied decoder, `visual.proj`, a text-tower key). Returns what it
    wrote, in the port's names."""
    import numpy as np

    from crvqa_tpu_torch.cli import vqa_mplug

    params = vqa_mplug.initial_params(args, config)
    patches = (MPLUG_PRETRAIN_RES // config.vit.patch_size) ** 2
    pos = "visual_encoder.visual.positional_embedding"
    params[pos] = torch.from_numpy(rng.normal(
        0.0, 0.036, (patches + 1, config.vit.width)).astype(np.float32))
    sd = {}
    for k, v in params.items():
        for tower, inner in (("text_encoder.", "bert."),
                             ("fusion_encoder.", "fusion.")):
            if k.startswith(tower):
                k = tower + inner + k[len(tower):]
        sd[k] = v
    sd["text_decoder.cls.predictions.decoder.weight"] = params[
        "text_decoder.bert.embeddings.word_embeddings.weight"]
    sd["visual_encoder.visual.proj"] = torch.zeros(config.vit.width, 512)
    sd["visual_encoder.token_embedding.weight"] = torch.zeros(8, 512)
    torch.save({"model": sd}, path)
    return params


def phase_mplug_files(torch, device, rehearse: bool, seed: int) -> dict:
    """Module docstring, phase 22."""
    import numpy as np

    from crvqa_tpu_torch.cli import vqa_mplug
    from crvqa_tpu_torch.core import torch_compat
    from crvqa_tpu_torch.data import mplug_data
    from crvqa_tpu_torch.train import mplug_train

    on_card = not rehearse
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bs = MPLUG_TRAIN_BATCH
    out: dict = {"batch": bs}
    rng = np.random.default_rng(seed + 23)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mplug_files_") as root:
        fabricate_mplug_files(root, rehearse, rng)
        res = 32 if rehearse else 384

        def cli(tag, *extra, files=False):
            data = (["--vocab_file", os.path.join(root, "vocab.txt"),
                     "--train_files", os.path.join(root, "vqa_train.json"),
                     "--test_files", os.path.join(root, "vqa_test.json"),
                     "--vqa_root", root, "--data_workers", "4"] if files
                    else ["--synthetic", str(MPLUG_OPT_STEPS * bs),
                          "--synthetic_shapes", MPLUG_TRAIN_SHAPES])
            return (["--output_dir", os.path.join(root, tag), "--device",
                     str(device), "--dtype", "bfloat16", "--seed",
                     str(seed), "--train_batch_size", str(bs),
                     "--num_train_epochs", "1", "--masker_update_step",
                     "100", "--logging_steps", "1", "--save_steps", "0",
                     "--image_res", str(res), "--do_train", *data, *extra]
                    + (["--tiny"] if rehearse else []))

        def run(tag, argv, **expect):
            t0 = time.monotonic()
            summary, launches = _run_counted(lambda: vqa_mplug.main(argv))
            wall_s = time.monotonic() - t0
            losses = summary["losses"]
            log(f"mplug-files {tag}: {len(losses)} steps at batch {bs} in "
                f"{wall_s:.1f} s (set-up included); losses "
                f"{[round(x, 4) for x in losses]}; launches {launches}")
            check(len(losses) == MPLUG_OPT_STEPS and all(np.isfinite(losses)),
                  f"mplug-files {tag}: losses {losses}")
            want = _mplug_train_launches(on_card=on_card, **expect)
            if rehearse:
                want = {k: 0 for k in want}
            check(launches == want,
                  f"mplug-files {tag}: launches {launches} != {want}")
            with open(os.path.join(root, tag, "metrics.jsonl")) as f:
                ex_s = [x["ex_s"] for x in map(json.loads, f) if "ex_s" in x]
            return {"losses": losses, "launches": launches, "wall_s": wall_s,
                    "logged_ex_s": ex_s}

        # the pretraining-format checkpoint, read back at full width
        args = vqa_mplug.build_parser().parse_args(cli(
            "load", "--init_ckpt", "unused.pth", "--init_ckpt_format",
            "pretrain"))
        config, _, _ = vqa_mplug.build_model(args)
        pth = os.path.join(root, "mplug_pretrain.pth")
        written = _pretrain_checkpoint(torch, args, config, pth, rng)
        args.init_ckpt = pth
        base = vqa_mplug.initial_params(args, config)
        t0 = time.monotonic()
        loaded, _ = vqa_mplug.load_init_ckpt(args, base)
        load_s = time.monotonic() - t0
        pos = "visual_encoder.visual.positional_embedding"
        resized = torch_compat.resize_pos_embed_np(
            written[pos], config.vit.num_patches + 1)
        check(loaded[pos].shape == base[pos].shape
              and torch.equal(loaded[pos], resized),
              f"mplug-files: the positional embedding "
              f"{tuple(written[pos].shape)} was not resized to "
              f"{tuple(base[pos].shape)}")
        bad = [k for k in written if k != pos
               and not torch.equal(loaded[k], written[k])]
        check(not bad and set(loaded) == set(base),
              f"mplug-files: loaded weights differ from the written: "
              f"{bad[:5]}")
        out["init_ckpt"] = {"bytes": os.path.getsize(pth), "load_s": load_s,
                            "from_res": MPLUG_PRETRAIN_RES, "to_res": res}
        log(f"mplug-files init_ckpt: {out['init_ckpt']}")
        del written, base, loaded
        gc.collect()

        # the augment alone: one batch of 16 images from their PNGs
        paths = [os.path.join(root, "imgs", n) for n in sorted(
            os.listdir(os.path.join(root, "imgs")))][:bs]
        times = []
        for i in range(4):
            t0 = time.monotonic()
            px = mplug_data.load_images(paths, res,
                                        rng=np.random.default_rng(i),
                                        workers=4, raw=True)
            times.append(time.monotonic() - t0)
        check(px.dtype == np.uint8 and px.shape == (bs, res, res, 3),
              f"mplug-files: augmented batch {px.dtype} {px.shape}")
        out["augment_batch_ms"] = [1e3 * t for t in times]
        log(f"mplug-files augment: host ms per batch of {bs} at {res} px, "
            f"4 workers: {[round(x, 1) for x in out['augment_batch_ms']]} "
            "(the first builds the native ops)")

        # the trainer on files: --augment true, the .pth, checkpointing
        out["files"] = run("files", cli(
            "files", "--init_ckpt", pth, "--init_ckpt_format", "pretrain",
            "--use_checkpoint", "true", files=True),
            steps=MPLUG_OPT_STEPS, checkpoint=True)
        for opt in ("lamb", "adamp"):
            out[opt] = run(opt, cli(opt, "--opt", opt),
                           steps=MPLUG_OPT_STEPS)
        _mplug_timed_steps(torch, device, rehearse, seed, out)
        _mplug_checkpoint_bit_equal(torch, device, rehearse, seed, out)
        # last: the plain attention's double backward holds the most
        out["adahessian"] = run("adahessian", cli(
            "adahessian", "--opt", "adahessian"), steps=0)
        _mplug_timed_steps(torch, device, rehearse, seed, out,
                           adahessian=True)
    return out


def _mplug_timed_steps(torch, device, rehearse, seed, out,
                       adahessian=False) -> None:
    """Timed steps of phase 22: ms and peak memory per setting, launches
    as predicted (adahessian alone, or the other four)."""
    import numpy as np

    from crvqa_tpu_torch.cli import vqa_mplug as vm
    from crvqa_tpu_torch.train import mplug_train

    on_card = not rehearse
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bs = MPLUG_TRAIN_BATCH
    args0 = vm.build_parser().parse_args(
        ["--output_dir", "unused", "--seed", str(seed)]
        + (["--tiny"] if rehearse else []))
    params = vm.initial_params(args0, vm.build_model(args0)[0])
    settings = ((("adahessian", ("--opt", "adahessian"), ADAHESSIAN_BATCH,
                  dict(steps=0)),) if adahessian else (
        ("adamw", (), bs, dict(steps=1)),
        ("adamw_checkpoint", ("--use_checkpoint", "true"), bs,
         dict(steps=1, checkpoint=True)),
        ("lamb", ("--opt", "lamb"), bs, dict(steps=1)),
        ("adamp", ("--opt", "adamp"), bs, dict(steps=1))))
    timed = out.setdefault("timed", {})
    for tag, extra, batch, expect in settings:
        model, masker, cfg, state, batch_t = _mplug_train_setup(
            torch, device, rehearse, seed, "bfloat16", batch, extra, params)
        step = mplug_train.make_train_step(model, cfg, masker)
        for _ in range(MPLUG_TIMED["warmup"]):
            state, _ = step(state, batch_t)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses = []
        t0 = time.monotonic()
        _, launches = _run_counted(lambda: [
            losses.append(step(state, batch_t)[1])
            for _ in range(MPLUG_TIMED["steps"])])
        sync()
        dt = time.monotonic() - t0
        losses = [float(x) for x in losses]
        row = {"batch": batch, "step_ms": 1e3 * dt / MPLUG_TIMED["steps"],
               "losses": losses, "launches": launches,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if on_card else None)}
        timed[tag] = row
        log(f"mplug-files timed {tag}: " + json.dumps(row))
        check(all(np.isfinite(losses)), f"mplug-files {tag}: {losses}")
        n = MPLUG_TIMED["steps"]
        want = _mplug_train_launches(
            on_card=on_card, **{**expect, "steps": expect["steps"] * n})
        check(rehearse or launches == want,
              f"mplug-files timed {tag}: launches {launches} != {want}")
        del model, state, batch_t, step
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()



def _mplug_checkpoint_bit_equal(torch, device, rehearse, seed, out) -> None:
    """Phase 22's fp32 step at batch 8 with dropout on, checkpointed and
    not: the loss and every gradient bit-equal."""
    from crvqa_tpu_torch.train import mplug_train

    on_card = not rehearse
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    grads = {}
    for flag in ("false", "true"):
        model, masker, cfg, state, batch_t = _mplug_train_setup(
            torch, device, rehearse, seed + 1, "float32", MPLUG_CHECK_BATCH,
            ("--use_checkpoint", flag))
        fn = mplug_train.make_loss_and_grads(model, cfg, masker)
        loss, g = fn(state, batch_t)
        sync()
        grads[flag] = (loss.cpu(), {k: v.cpu() for k, v in g.items()})
        del model, state, batch_t, fn, g
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    (la, ga), (lb, gb) = grads["false"], grads["true"]
    differ = [k for k in ga if not torch.equal(ga[k], gb[k])]
    out["checkpoint_bit_equal"] = {"loss": float(la),
                                   "loss_equal": bool(torch.equal(la, lb)),
                                   "grads_differ": differ[:5]}
    log("mplug-files fp32 checkpointed vs plain step: "
        + json.dumps(out["checkpoint_bit_equal"]))
    check(torch.equal(la, lb) and not differ,
          f"mplug-files: a checkpointed fp32 step is not bit-equal to the "
          f"plain one: {out['checkpoint_bit_equal']}")


# ------------------------------------------------------- phases 14-17

# masked matmul points: an LXMERT projection over the visual stream at
# batch 256 (x [256 * 36, 768], w [768, 768]), the shape the JAX module
# measures (crvqa_tpu/ops/masked_matmul.py:19), and a ragged one
MM_SHAPES = [(TRAIN_BATCH * BOXES, 768, 768), (4096, 768, 3072),
             (1000, 700, 300)]
# around the product kernel's 128 x 128 x 64 tiles: a single element,
# ragged rows, columns and reduction, a one-column output
MM_EDGE_SHAPES = [(1, 1, 1), (65, 127, 129), (129, 200, 1)]
MM_DTYPES = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
             ("float32", "float32"), ("float32", "bfloat16")]
MM_THRESHOLD = 0.7
HC_HEADS, HC_KEPT = 12, 4  # 4 of 12 heads kept: zero rate 0.67
HC_TIMED_KEPT = (1, 4, 6, 12)  # the bf16 rows timed


def _close_to(torch, got, want, bf16: bool, terms: int
              ) -> tuple[bool, float]:
    """(ok, max abs err) of a product whose sums run over `terms` exact
    bf16 products in fp32: the tensor cores add 32-term steps in sequence,
    cuBLAS in another order, so the rounding difference grows with the
    square root of the length: 1e-5 of the largest |want| up to 768 terms,
    sqrt(terms / 768) times that beyond; plus one bf16 step (2^-7 of
    |want|) where the result is rounded to bf16."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = (1e-5 * max(1.0, terms / 768) ** 0.5 * want.abs().max()
           + (2.0 ** -7 if bf16 else 0.0) * want.abs())
    return bool((err <= tol).all()), err.max().item()


def _mm_bound_terms(m, k, n, x_item, w_item, g_item=4) -> dict:
    """kind -> (bytes ms, FLOPs ms) of one masked-matmul kernel call: each
    input read once and each output written once over HBM (scores fp32; ds
    reads g in `g_item` bytes, fp32 as the VJP cast it before, and writes
    fp32; "ds_bf16g" with a bf16 g); 2·M·K·N FLOPs at the bf16
    tensor-core peak, since every product is of bf16 operands. "pass": the
    operand pass's mask mode, w and the scores read, bf16(w ⊙ m) written."""
    f32 = 4
    nbytes = {"fwd": x_item * (m * k + m * n) + w_item * k * n + f32 * k * n,
              "dx": x_item * (m * n + m * k) + w_item * k * n + f32 * k * n,
              "ds": x_item * m * k + g_item * m * n + w_item * k * n
              + f32 * k * n,
              "ds_bf16g": x_item * m * k + 2 * m * n + w_item * k * n
              + f32 * k * n}
    ops_ms = 1e3 * 2 * m * k * n / PEAK_FLOPS["bfloat16"]
    out = {kind: (1e3 * b / HBM_BYTES_PER_S, ops_ms)
           for kind, b in nbytes.items()}
    out["pass"] = (1e3 * (w_item + f32 + 2) * k * n / HBM_BYTES_PER_S, 0.0)
    return out


def _mm_inputs(torch, m, k, n, x_dtype, w_dtype, device, seed):
    """x, w, scores, threshold, g: scores uniform in [0, 1) with every 7th
    exactly on the threshold (masked: the compare is strict) and every 11th
    one fp32 step above it (kept)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g) * 0.05
    s = torch.rand(k, n, generator=g)
    t = torch.tensor(MM_THRESHOLD)
    s.view(-1)[::7] = t
    s.view(-1)[3::11] = torch.nextafter(t, torch.tensor(2.0))
    gy = torch.randn(m, n, generator=g)
    xd, wd = getattr(torch, x_dtype), getattr(torch, w_dtype)
    return (x.to(device, xd), w.to(device, wd), s.to(device), t.to(device),
            gy.to(device, xd))


def _mm_pass_launches(torch, mm, x, gy) -> int:
    """Operand passes of one autograd run: bf16(w ⊙ m) for the forward and
    for dx, and a copy of each of x (forward, ds) and g (dx, ds) that TMA
    cannot read in place (the VJP hands ds a bf16 g as it is, else g in
    fp32)."""
    g_ds = gy if gy.dtype == torch.bfloat16 else gy.float()
    return 2 + sum(not mm._tma_ready(t) for t in (x, gy, x, g_ds))


def phase_masked_matmul_kernel(torch, device, rehearse: bool, seed: int
                               ) -> dict:
    """The three masked-matmul kernels through `masked_matmul` under
    autograd (forward, dx, STE ds; zero gradients for w and the threshold)
    against their plain versions at three shapes, three edge shapes and
    four (x, w) dtype pairs; ds bit-identical across two calls and between
    a bf16 and an fp32 cotangent; the operand pass bit-equal to its plain
    version; timed (CUDA-graph replay) at the three shapes where x and w
    share a dtype, beside the plain versions and cuBLAS on x @ (w * (s >
    t)). No entry point reaches these kernels; `launches` counts this
    phase's autograd runs."""
    from crvqa_tpu_torch.ops import masked_matmul as mm

    shapes = ([(96, 80, 72), (33, 20, 17)] if rehearse
              else MM_SHAPES + MM_EDGE_SHAPES)
    rows = []
    launches = _launch_counts()
    n_pass = 0
    if not rehearse:
        occupancy = mm.blocks_per_sm()
        check(set(occupancy.values()) == {mm.BLOCKS_PER_SM},
              f"masked-matmul-kernel: the product kernels hold "
              f"{occupancy} blocks an SM; ds_plan assumes "
              f"{mm.BLOCKS_PER_SM}")
    for (m, k, n) in shapes:
        for x_dtype, w_dtype in MM_DTYPES:
            x, w, s, t, gy = _mm_inputs(torch, m, k, n, x_dtype, w_dtype,
                                        device, seed + m + n)
            leaves = [v.clone().requires_grad_(True) for v in (x, w, s, t)]

            def autograd_run():
                y = mm.masked_matmul(*leaves)
                return (y,) + torch.autograd.grad(y, leaves, gy)

            (y, dx, dw, ds, dt), counts = _run_counted(autograd_run)
            launches = {n_: launches[n_] + c for n_, c in counts.items()}
            n_pass += _mm_pass_launches(torch, mm, x, gy)
            ref_y = mm.masked_matmul_fwd_reference(x, w, s, t)
            ref_dx = mm.masked_matmul_dx_reference(gy, w, s, t, x.dtype)
            ref_ds = mm.masked_matmul_ds_reference(x, gy.float(), w)
            ok_y, err_y = _close_to(torch, y, ref_y, x_dtype == "bfloat16",
                                     k)
            ok_dx, err_dx = _close_to(torch, dx, ref_dx,
                                      x_dtype == "bfloat16", n)
            ok_ds, err_ds = _close_to(torch, ds, ref_ds,
                                      w_dtype == "bfloat16", m)
            zero = (dw.abs().max().item() == 0.0 and dt.item() == 0.0)
            # determinism: the same bits again, and from an fp32 cotangent
            ds_again = mm.masked_matmul_ds(x, gy, w)
            same = (torch.equal(ds, ds_again) and torch.equal(
                ds, mm.masked_matmul_ds(x, gy.float(), w)))
            packed = mm.operand_pass(w, s, t)
            packed_ref = mm.operand_pass_reference(w, s, t)
            pass_exact = torch.equal(packed.view(torch.int16),
                                     packed_ref.view(torch.int16))
            row = {"m": m, "k": k, "n": n, "x_dtype": x_dtype,
                   "w_dtype": w_dtype, "y_err": err_y, "dx_err": err_dx,
                   "ds_err": err_ds, "ds_bit_identical": same,
                   "pass_bit_equal": pass_exact,
                   "pass_err": (packed.float() - packed_ref.float()).abs()
                   .max().item(),
                   "ds_plan": str(mm.ds_plan(m, k, n, _sm_count(torch,
                                                                device))),
                   "on_threshold": int((s == t).sum()),
                   "kept_share": float((s > t).float().mean()),
                   "dtypes_ok": (y.dtype == x.dtype and dx.dtype == x.dtype
                                 and ds.dtype == torch.float32)}
            terms = _mm_bound_terms(m, k, n, x.element_size(),
                                    w.element_size())
            for kind, (t_bytes, t_ops) in terms.items():
                row[f"{kind}_bytes_ms"], row[f"{kind}_ops_ms"] = (t_bytes,
                                                                  t_ops)
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = _bound(
                    t_bytes, t_ops)
            if not rehearse and x_dtype == w_dtype and (m, k, n) in MM_SHAPES:
                row.update(_mm_times(torch, mm, x, w, s, t, gy))
            rows.append(row)
            log("masked-matmul-kernel: " + json.dumps(row))
            check(ok_y and ok_dx and ok_ds and zero and row["dtypes_ok"],
                  f"masked matmul kernels disagree with their plain versions "
                  f"at {row} (tolerance: 1e-5 of the largest output, times "
                  f"sqrt(terms / 768) past 768 terms, plus one bf16 step "
                  f"where the output rounds to bf16; dw and dthreshold "
                  f"exactly 0)")
            check(same and pass_exact,
                  f"masked-matmul-kernel: ds not bit-identical across calls "
                  f"or cotangent dtypes, or the operand pass not bit-equal "
                  f"to its plain version, at {row}")
    want = _launch_counts(not rehearse, masked_matmul_fwd=len(rows),
                          masked_matmul_dx=len(rows),
                          masked_matmul_ds=len(rows),
                          masked_matmul_operand_pass=n_pass)
    check(launches == want, f"masked-matmul-kernel: launches {launches} != "
                            f"{want}")
    out = {"rows": rows, "launches": launches}
    if not rehearse:
        out["profile"] = _mm_profile(torch, mm, device, seed)
    return out


def _sm_count(torch, device) -> int:
    return (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else 132)


def _mm_profile(torch, mm, device, seed) -> dict:
    """Kernel names and counts of one bf16 autograd run at MM_SHAPES[0]:
    the operand pass twice, the wgmma product three times, ds's split
    reduction once (where its plan splits), and no `tile_gemm_kernel`.
    Profiled in a fresh process: a profiler session this late in a long
    process on the card came back without the kernels' events."""
    got = _fresh_process("mm_profile_counts", seed, "masked-matmul-kernel")
    log(f"masked-matmul-kernel: profile of one bf16 autograd run: {got}")
    m, k, n = MM_SHAPES[0]
    splits = mm.ds_plan(m, k, n, _sm_count(torch, device)).splits
    check(got == {"masked_operand_pass_kernel": 2, "wgmma_gemm_kernel": 3,
                  "ds_split_reduce_kernel": int(splits > 1),
                  "tile_gemm_kernel": 0},
          f"masked-matmul-kernel: the profiler saw {got}")
    return got


def _fresh_process(fn: str, seed: int, tag: str, *args: str):
    """chip_smoke.<fn>(seed, *args) in a fresh Python process on the card;
    its JSON result."""
    code = ("import json, sys, chip_smoke as s; print('RESULT', json.dumps("
            f"s.{fn}(int(sys.argv[1]), *sys.argv[2:])))")
    proc = subprocess.run([sys.executable, "-c", code, str(seed), *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"{tag}: the profiling process failed (exit {proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return json.loads(lines[0].split(" ", 1)[1])


def _device_calls(torch, prof, names) -> dict:
    """Launches by kernel name (substring) among a profile's CUDA events."""
    calls = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return {name: sum(c for key, c in calls.items() if name in key)
            for name in names}


def _device_kernel(torch, e) -> bool:
    """A profile event that is work on the card: the schedule's
    `ProfilerStep#` annotation spans the whole pass on the device's
    timeline too, and is not."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep"))


def _warm_profile(torch, fn):
    """(profile, wall ms of the profiled pass) of `fn()` (which ends in a
    synchronise) run twice under one profiler, the first pass its warm-up,
    traced and discarded: a session on the H100 can lose the kernels
    CUPTI misses while it starts (the first launches, or all of them)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        prof.step()
        t0 = time.monotonic()
        fn()
        wall_ms = 1e3 * (time.monotonic() - t0)
        prof.step()
    return prof, wall_ms



def mm_profile_counts(seed: int) -> dict:
    """Launches by kernel name (the masked-matmul kernels and
    `tile_gemm_kernel`) in a profile of one bf16 autograd run of
    `masked_matmul` at MM_SHAPES[0] on the card, after one run unprofiled
    (`_warm_profile`: one more, profiled and discarded)."""
    import torch
    from crvqa_tpu_torch.ops import masked_matmul as mm

    device = torch.device("cuda")
    m, k, n = MM_SHAPES[0]
    x, w, s, t, gy = _mm_inputs(torch, m, k, n, "bfloat16", "bfloat16",
                                device, seed)
    leaves = [v.clone().requires_grad_(True) for v in (x, w, s, t)]

    def run():
        torch.autograd.grad(mm.masked_matmul(*leaves), leaves, gy)
        torch.cuda.synchronize()

    run()
    prof, _ = _warm_profile(torch, run)
    return _device_calls(torch, prof, (
        "masked_operand_pass_kernel", "wgmma_gemm_kernel",
        "ds_split_reduce_kernel", "tile_gemm_kernel"))


def _mm_times(torch, mm, x, w, s, t, gy) -> dict:
    """Device ms per call of each kernel, its plain version and cuBLAS on
    the materialised masked weight; and of forward + backward under
    autograd (the library's STE: s + ((s > t) - s).detach()). ds is timed
    with g cast to fp32 inside the call (`ds_ms`, the call timed before
    the VJP handed ds a bf16 g) and with g in x's dtype (`ds_bf16g_ms`
    where that is bf16; `ds_library_ms` is (xᵀ g) * w with that g)."""
    xr, sr = x.detach().requires_grad_(True), s.detach().requires_grad_(True)
    wm = lambda: w * (s > t).to(w.dtype)
    ste = lambda: sr + ((sr > t).float() - sr).detach()
    out = {
        "fwd_ms": _graph_ms(torch, lambda: mm.masked_matmul_fwd(x, w, s, t)),
        "dx_ms": _graph_ms(torch, lambda: mm.masked_matmul_dx(
            gy, w, s, t, x.dtype)),
        "ds_ms": _graph_ms(torch, lambda: mm.masked_matmul_ds(
            x, gy.float(), w)),
        "pass_ms": _graph_ms(torch, lambda: mm.operand_pass(w, s, t)),
        "fwd_bwd_ms": _graph_ms(torch, lambda: torch.autograd.grad(
            mm.masked_matmul(xr, w, sr, t), (xr, sr), gy)),
        "fwd_plain_ms": _graph_ms(torch, lambda: (
            mm.masked_matmul_fwd_reference(x, w, s, t))),
        "dx_plain_ms": _graph_ms(torch, lambda: (
            mm.masked_matmul_dx_reference(gy, w, s, t, x.dtype))),
        "ds_plain_ms": _graph_ms(torch, lambda: (
            mm.masked_matmul_ds_reference(x, gy.float(), w))),
        "pass_plain_ms": _graph_ms(torch, lambda: (
            mm.operand_pass_reference(w, s, t))),
        "fwd_library_ms": _graph_ms(torch, lambda: x @ wm()),
        "dx_library_ms": _graph_ms(torch, lambda: gy @ wm().T),
        "ds_library_ms": _graph_ms(torch, lambda: (x.T @ gy) * w),
        "fwd_bwd_library_ms": _graph_ms(torch, lambda: torch.autograd.grad(
            xr @ (w * ste()).to(x.dtype), (xr, sr), gy)),
    }
    if gy.dtype == torch.bfloat16:
        out["ds_bf16g_ms"] = _graph_ms(torch, lambda: mm.masked_matmul_ds(
            x, gy, w))
        out["ds_bf16g_plain_ms"] = _graph_ms(torch, lambda: (
            mm.masked_matmul_ds_reference(x, gy, w)))
    out["fwd_bwd_plain_ms"] = (out["fwd_plain_ms"] + out["dx_plain_ms"]
                               + out["ds_plain_ms"])
    return out


def _hc_inputs(torch, m, k, seed):
    """x [m, k], wt [HC_HEADS * 64, k] (fp32, on the CPU) and the head
    order that kept-head masks take their heads from."""
    g = torch.Generator().manual_seed(seed + 5)
    order = torch.randperm(HC_HEADS, generator=g)
    x = torch.randn(m, k, generator=g)
    wt = torch.randn(HC_HEADS * 64, k, generator=g) * 0.05
    return x, wt, order


def _hc_mask(torch, order, kept: int):
    hm = torch.zeros(HC_HEADS, dtype=torch.bool)
    hm[order[:kept]] = True
    return hm


def phase_head_compact_kernel(torch, device, rehearse: bool, seed: int
                              ) -> dict:
    """The head-compact kernel at x [256 * 36, 768], 12 heads of 64, in
    bf16 and fp32, against its plain version: 4 kept, the same padded by 2
    sentinels, and every head masked (2 sentinel slots); in bf16 also 1, 6
    and 12 kept. Masked columns exactly zero, a second call bit-identical.
    Timed (bf16 at HC_TIMED_KEPT, fp32 at 4 kept) beside the port's
    `head_compact_matmul` (gather + cuBLAS + scatter) and
    `dense_masked_matmul` (cuBLAS on w * mask); the operand pass timed on
    fp32 x; then one bf16 and one fp32 call, each profiled in a fresh
    process. No entry point reaches the kernel; `launches` counts this
    phase's checking run."""
    from crvqa_tpu_torch.ops import structured_matmul as sm

    m, k, bm, bk = (256, 128, 128, 128) if rehearse else (
        TRAIN_BATCH * BOXES, 768, 512, 256)
    heads, hs = HC_HEADS, 64
    x32, wt32, order = _hc_inputs(torch, m, k, seed)
    cases = [("kept4", HC_KEPT, HC_KEPT), ("kept4_pad2", HC_KEPT, HC_KEPT + 2),
             ("none_kept", 0, 2)]
    # bf16 only: the other timed counts, and each of 4 kept heads paired
    # with a pad (one head a product block: the cost of that tiling)
    more = [(f"kept{n}", n, n) for n in HC_TIMED_KEPT if n != HC_KEPT] + [
        ("kept4_split_pairs", HC_KEPT, 2 * HC_KEPT)]
    rows = []
    launches = _launch_counts()
    n_pass = 0
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x, wt = x32.to(device, dt), wt32.to(device, dt)
        timed = ({f"kept{n}" for n in HC_TIMED_KEPT} | {
            "kept4_split_pairs", "none_kept"} if dtype == "bfloat16"
                 else {f"kept{HC_KEPT}"})
        for tag, kept, n_keep in cases + (more if dtype == "bfloat16"
                                          else []):
            hm = _hc_mask(torch, order, kept)
            if tag.endswith("split_pairs"):  # kept, pad, kept, pad, ...
                keep = sm.expand_keep_idx(hm, kept)
                keep = torch.stack([keep, torch.full_like(keep, heads)], 1)
            else:
                keep = sm.expand_keep_idx(hm, n_keep)
            keep = keep.reshape(-1).to(device, torch.int32)
            call = lambda: sm.head_compact_matmul_pallas(x, wt, keep, heads,
                                                         hs, bm=bm, bk=bk)
            y, counts = _run_counted(call)
            launches = {n_: launches[n_] + c for n_, c in counts.items()}
            n_pass += sum(sm.rounded_operands(x, wt))
            ref = sm.head_compact_matmul_pallas_reference(x, wt, keep, heads,
                                                          hs)
            ok, err = _close_to(torch, y, ref, dtype == "bfloat16", k)
            cols = hm.to(device).repeat_interleave(hs)
            zero = not bool(y[:, ~cols].any())
            same = torch.equal(y, call())
            item = x.element_size()
            t_bytes = 1e3 * (item * (m * k + kept * hs * k + m * heads * hs)
                             + 4 * n_keep) / HBM_BYTES_PER_S
            t_ops = 1e3 * 2 * m * k * kept * hs / PEAK_FLOPS["bfloat16"]
            row = {"case": tag, "dtype": dtype, "m": m, "k": k,
                   "heads": heads, "kept": kept, "n_keep": n_keep,
                   "max_abs_err": err, "masked_columns_zero": zero,
                   "bit_identical": same, "bytes_ms": t_bytes,
                   "ops_ms": t_ops}
            row["bound_ms"], row["bound_by"] = _bound(t_bytes, t_ops)
            if not rehearse and tag in timed:
                row.update(_hc_times(torch, sm, x, wt, keep, hm, bm, bk))
            rows.append(row)
            log("head-compact-kernel: " + json.dumps(row))
            check(ok and zero and same and y.dtype == x.dtype,
                  f"head-compact kernel disagrees with its plain version at "
                  f"{row} (tolerance: 1e-5 of the largest output, plus one "
                  f"bf16 step in bf16; masked columns exactly 0; a second "
                  f"call bit-identical)")
    want = _launch_counts(not rehearse, head_compact_matmul=len(rows),
                          head_compact_operand_pass=n_pass)
    check(launches == want, f"head-compact-kernel: launches {launches} != "
                            f"{want}")
    x = x32.to(device)
    packed = sm.operand_pass(x)
    plain = sm.operand_pass_reference(x)
    out = {"rows": rows, "launches": launches,
           "pass": {"m": m, "k": k, "bit_equal": torch.equal(
               packed.view(torch.int16), plain.view(torch.int16)),
               "max_abs_err": (packed.float() - plain.float()).abs().max()
               .item(),
               "bytes_ms": 1e3 * 6 * m * k / HBM_BYTES_PER_S}}
    check(out["pass"]["bit_equal"], "head-compact-kernel: the operand pass "
                                    "is not bit-equal to its plain version")
    if not rehearse:
        out["pass"]["ms"] = _graph_ms(torch, lambda: sm.operand_pass(x))
        # the plain version is itself the one PyTorch call for the function
        out["pass"]["plain_ms"] = _graph_ms(torch, lambda: (
            sm.operand_pass_reference(x)))
        # one process a dtype: a second session in one process can come
        # back without any kernel event
        out["profile"] = {dtype: _fresh_process(
            "hc_profile_counts", seed, "head-compact-kernel", dtype)
            for dtype in HC_PROFILE_WANT}
        log(f"head-compact-kernel: profiles of one call: {out['profile']}")
        check(out["profile"] == HC_PROFILE_WANT,
              f"head-compact-kernel: the profiler saw {out['profile']}, "
              f"not {HC_PROFILE_WANT}")
    log("head-compact-kernel: operand pass " + json.dumps(out["pass"]))
    return out


# kernels by name in a profile of one call at x [9216, 768], by dtype: the
# head-compact kernel once, the operand pass for each fp32 operand
HC_PROFILE_WANT = {
    "bfloat16": {"head_compact_kernel": 1,
                 "head_compact_operand_pass_kernel": 0,
                 "tile_gemm_kernel": 0},
    "float32": {"head_compact_kernel": 1,
                "head_compact_operand_pass_kernel": 2,
                "tile_gemm_kernel": 0}}


def hc_profile_counts(seed: int, dtype: str) -> dict:
    """Launches by kernel name in a profile of one head-compact call at x
    [256 * 36, 768], 4 of 12 heads kept, in `dtype` on the card, after
    one call unprofiled (`_warm_profile`: one more, profiled and
    discarded)."""
    import torch
    from crvqa_tpu_torch.ops import structured_matmul as sm

    device = torch.device("cuda")
    x32, wt32, order = _hc_inputs(torch, TRAIN_BATCH * BOXES, 768, seed)
    keep = sm.expand_keep_idx(_hc_mask(torch, order, HC_KEPT), HC_KEPT).to(
        device, torch.int32)
    x, wt = (t.to(device, getattr(torch, dtype)) for t in (x32, wt32))

    def run():
        sm.head_compact_matmul_pallas(x, wt, keep, HC_HEADS, 64)
        torch.cuda.synchronize()

    run()
    return _device_calls(torch, _warm_profile(torch, run)[0],
                         HC_PROFILE_WANT[dtype])


def _hc_times(torch, sm, x, wt, keep, hm, bm, bk) -> dict:
    """Device ms per call of the kernel (its operand passes included), its
    plain version, the port's gather + cuBLAS + scatter op and cuBLAS on w
    * mask; and the eager ms per kernel call."""
    heads, hs = HC_HEADS, 64
    w = wt.T.contiguous()
    hmd = hm.to(x.device)
    call = lambda: sm.head_compact_matmul_pallas(x, wt, keep, heads, hs,
                                                 bm=bm, bk=bk)
    return {
        "ms": _graph_ms(torch, call),
        "plain_ms": _graph_ms(torch, lambda: (
            sm.head_compact_matmul_pallas_reference(x, wt, keep, heads, hs))),
        "compact_torch_ms": _graph_ms(torch, lambda: (
            sm.head_compact_matmul(x, w, keep, heads, hs))),
        "library_ms": _graph_ms(torch, lambda: (
            sm.dense_masked_matmul(x, w, hmd, hs))),
        "call_ms": _eager_ms(torch, call),
    }


S1_BATCH = 64            # the reference recipe (bash_files/Stage1)
S1_SYNTHETIC = 512       # 8 steps at batch 64, 8 eval batches
S3_SYNTHETIC = 256       # 4 steps, 4 eval batches
S3_ZERO_RATE = 0.5       # the structured run's head and FFN masks


def _timed_steps(torch, step, state, batch, rehearse, tag) -> dict:
    """WARMUP_STEPS, then TIMED_STEPS timed (host clock to a synchronise)
    and two profiled steps of fn(state, batch) on one batch kept on the
    card."""
    import numpy as np

    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    sync()
    if not rehearse:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = [step(state, batch)[1].loss for _ in range(TIMED_STEPS)]
    sync()
    dt = time.monotonic() - t0
    bs = int(batch["labels"].shape[0])
    out = {"batch": bs, "timed_steps": TIMED_STEPS,
           "step_ms": 1e3 * dt / TIMED_STEPS,
           "examples_per_s": TIMED_STEPS * bs / dt,
           "losses": [float(x) for x in losses]}
    check(all(np.isfinite(out["losses"])), f"{tag}: losses {out['losses']}")
    if not rehearse:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["profile"] = _profile_steps(torch, lambda: step(state, batch))
    log(f"{tag}: " + json.dumps({k: v for k, v in out.items()
                                 if k != "profile"}))
    return out


def _stage1_setup(torch, config, device, seed, batch_size, params=None,
                  masks=None):
    """(model, cfg, state, tx, batch): a stage-1/3 state at `config` (LMH
    loss; `params` or a seeded init) and one synthetic batch on the
    device."""
    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.train import stage1
    from crvqa_tpu_torch.train.stage2 import lxmert_meta_model

    if params is None:
        params = cli_common.lxmert_initial_params(config, seed, None)
    cfg = stage1.Stage1Config(ft_type="lmh", warmup_steps=100,
                              total_steps=1000,
                              hidden_size=config.hidden_size)
    state, tx = stage1.init_state(params, cfg, seed, device, masks=masks)
    batch = to_device(synthetic_batch(
        batch_size=batch_size, seed=seed, vocab_size=config.vocab_size,
        ans_num=config.ans_num, feat_dim=config.visual_feat_dim,
        pos_dim=config.visual_pos_dim), device,
        float_dtype=config.dtype if config.dtype == torch.bfloat16 else None)
    return lxmert_meta_model(config), cfg, state, tx, batch


def _free(torch, rehearse) -> None:
    gc.collect()
    if not rehearse:
        torch.cuda.empty_cache()


def phase_stage1(torch, device, rehearse: bool, seed: int, keep_dir: str
                 ) -> dict:
    """`run_vqa_stage1.main` at full width, batch 64, bf16, LMH loss, on
    512 synthetic examples: 8 steps, a checkpoint, an eval and the .bin at
    step 8, the final eval. Launches per step and per eval batch; timed
    steps; one fp32 step with dropout on through the kernels against the
    same step through the plain attentions."""
    import numpy as np

    from crvqa_tpu_torch.cli import run_vqa_stage1
    from crvqa_tpu_torch.models import LxmertConfig, layers
    from crvqa_tpu_torch.train import stage1

    on_card = not rehearse
    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    fwd_mult, bwd_mult = launch_mult(config)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    steps = S1_SYNTHETIC // S1_BATCH
    eval_batches = 2 * steps  # the eval at the save step, the final one
    out_dir = os.path.join(keep_dir, "stage1")
    argv = ["--output_dir", out_dir, "--device", str(device), "--dtype",
            "bfloat16", "--FT_type", "lmh", "--synthetic", str(S1_SYNTHETIC),
            "--train_batch_size", str(S1_BATCH), "--eval_batch_size",
            str(S1_BATCH), "--num_train_epochs", "1", "--logging_steps", "4",
            "--save_steps", str(steps), "--seed", str(seed), "--do_train",
            "--do_eval", "--evaluate_during_training"] + (
                ["--tiny"] if rehearse else [])
    t0 = time.monotonic()
    summary, launches = _run_counted(lambda: run_vqa_stage1.main(argv))
    wall_s = time.monotonic() - t0
    losses = summary.pop("losses")
    del summary["state"]
    log(f"stage1: {len(losses)} steps at batch {S1_BATCH} in {wall_s:.1f} s "
        f"(set-up, a checkpoint, two evals and the .bin included); losses "
        f"{[round(x, 4) for x in losses]}; eval acc {summary['eval_acc']}; "
        f"launches {launches}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"stage1: losses {losses}")
    want = _launch_counts(on_card, fused_attention_fwd_train=per_fwd * steps,
                          fused_attention_bwd_stored=per_bwd * steps,
                          fused_attention_fwd=per_fwd * eval_batches)
    check(launches == want,
          f"stage1: launches {launches} != {want} ({per_fwd} forward and "
          f"{per_bwd} backward per step x {steps}, {per_fwd} per eval batch "
          f"x {eval_batches})")
    for name in ("run_FTlmh_only.bin", "run_FTlmh_only.bin.msgpack",
                 "test.json", "eval_results_vqa.txt",
                 "best_eval_results_vqa_noMASK.txt", f"ckpt_{steps}"):
        check(os.path.exists(os.path.join(out_dir, name)),
              f"stage1: {name} not written")
    os.remove(os.path.join(out_dir, f"ckpt_{steps}"))  # 2.5 GB, not needed
    twin = _check_twin(torch, config, os.path.join(out_dir,
                                                   "run_FTlmh_only.bin"))
    _free(torch, rehearse)

    bf16 = LxmertConfig.tiny(dtype=torch.bfloat16) if rehearse else (
        LxmertConfig(dtype=torch.bfloat16))
    model, cfg, state, tx, batch = _stage1_setup(torch, bf16, device, seed,
                                                 S1_BATCH)
    step = stage1.make_train_step(model, cfg, tx)
    timed = _timed_steps(torch, step, state, batch, rehearse, "stage1-step")
    del model, state, tx, batch, step
    _free(torch, rehearse)

    # the whole-step check: kernels vs plain versions, fp32, dropout on
    model, cfg, state, tx, batch = _stage1_setup(torch, config, device,
                                                 seed + 1, CHECK_BATCH)
    fn = stage1.make_loss_and_grads(model, cfg)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    (loss_k, _, grads_k), check_launches = _run_counted(
        lambda: fn(state, batch))
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    saved, layers.fused_attention = layers.fused_attention, _plain_attention
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    gmax = max(g.abs().max().item() for g in grads_p.values())
    dmax = max((grads_k[k] - grads_p[k]).abs().max().item() for k in grads_p)
    dloss = abs(loss_k.item() - loss_p.item())
    check_out = {"batch": CHECK_BATCH, "loss_kernels": loss_k.item(),
                 "loss_plain": loss_p.item(), "loss_abs_diff": dloss,
                 "grad_max": gmax, "grad_max_abs_diff": dmax,
                 "launches": check_launches}
    log("stage1 check: " + json.dumps(check_out))
    # fp32 throughout; the kernels sum in another order than the plain
    # versions' cuBLAS products, and the difference travels 19 layers
    check(dloss <= 1e-4 * abs(loss_p.item()) and dmax <= 1e-3 * gmax,
          f"one fp32 stage-1 step with dropout: kernels vs plain versions "
          f"differ: {check_out} (tolerances: loss 1e-4 relative, gradients "
          f"1e-3 of their largest)")
    check(check_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd,
        fused_attention_bwd_stored=per_bwd),
        f"stage1 check: launches {check_launches}")
    del model, state, tx, batch, fn, grads_k, grads_p
    _free(torch, rehearse)
    return {"steps": steps, "losses": losses, "launches": launches,
            "per_forward": per_fwd, "per_backward": per_bwd,
            "eval_batches": eval_batches, "wall_s": wall_s,
            "summary": summary, "timed": timed, "check": check_out,
            "twin": twin, "bin": os.path.join(out_dir, "run_FTlmh_only.bin")}


def _check_twin(torch, config, bin_path: str) -> dict:
    """The `.msgpack` twin the stage-1 CLI wrote beside `bin_path` (the
    JAX package's params file): read by `load_params_any`, every
    parameter bit-equal to the `.bin`'s; written again from the `.bin`'s
    parameters, the same bytes. Its size and its read and write seconds
    (host clock, the CPU tensors of a whole LXMERT)."""
    import dataclasses

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.models import build_lxmert

    twin = bin_path + ".msgpack"
    model = build_lxmert(dataclasses.replace(config, dtype=torch.float32),
                         "meta")
    template = model.state_dict()
    t0 = time.monotonic()
    from_twin = cli_common.load_params_any(twin, template)
    read_s = time.monotonic() - t0
    from_bin = cli_common.load_params_any(bin_path, template)
    differ = [k for k in template if from_twin[k].dtype != from_bin[k].dtype
              or not torch.equal(from_twin[k], from_bin[k])]
    n = sum(t.numel() for t in from_bin.values())
    check(not differ, f"stage1: the .msgpack twin differs from the .bin at "
                      f"{differ[:5]} ({len(differ)} tensors)")
    again = twin + ".again"
    t0 = time.monotonic()
    cli_common.save_params_msgpack(again, from_bin, model)
    write_s = time.monotonic() - t0
    with open(twin, "rb") as a, open(again, "rb") as b:
        same = a.read() == b.read()
    os.remove(again)
    check(same, "stage1: the twin written again from the .bin's parameters "
                "has other bytes")
    out = {"bytes": os.path.getsize(twin), "params": n,
           "tensors": len(template), "read_s": read_s, "write_s": write_s}
    log("stage1: .msgpack twin bit-equal to the .bin over "
        f"{n} parameters; " + json.dumps(out))
    return out


class _HeadsSeen:
    """Records the head counts the forward-for-grad kernel is launched
    with inside the block (observation only: the launch runs as it
    would)."""

    def __enter__(self):
        from crvqa_tpu_torch.ops import fused_attention as fa

        self.heads: set = set()
        self.saved = fa._launch_fwd_train

        def launch(q, k, v, bias, num_heads, *rest):
            self.heads.add(num_heads)
            return self.saved(q, k, v, bias, num_heads, *rest)

        fa._launch_fwd_train = launch
        return self

    def __exit__(self, *exc):
        from crvqa_tpu_torch.ops import fused_attention as fa

        fa._launch_fwd_train = self.saved
        return False


def phase_stage3(torch, device, rehearse: bool, seed: int, stage1_bin: str,
                 stage2_dir: str, keep_dir: str, serve_root: str) -> dict:
    """`run_vqa_stage3.main` at full width, batch 64, bf16, LMH loss, from
    phase stage1's .bin, three ways: (a) FT_trainedMask with phase train's
    mask.pt and classifier4masker.bin; (b) FT_randMask --rand_scope
    reference; (c) seeded head and FFN .npy masks at zero rate 0.5, which
    compact the 9 language layers to 6 heads and FFN 1536. 4 steps and an
    eval of 4 batches each. Checks launches, the masked weights exactly 0
    after the steps, the audited zero rate, the heads the kernel ran at,
    each run's .bin and .msgpack; serves (a)'s .msgpack (the JAX package's
    params file) with `serve_vqa --ckpt` over phase serve's files, bf16 and
    fp32, fp32 answers identical to serving (a)'s .bin; then timed steps of
    (a) and (c)."""
    import numpy as np

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.cli import run_vqa_stage3
    from crvqa_tpu_torch.core import torch_compat
    from crvqa_tpu_torch.masking import compaction
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.train import stage1

    on_card = not rehearse
    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    fwd_mult, bwd_mult = launch_mult(config)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    steps = S3_SYNTHETIC // S1_BATCH
    rng = np.random.default_rng(seed + 31)
    keep = lambda n, rows: np.stack([rng.permutation(
        np.arange(n) < int(n * (1 - S3_ZERO_RATE)))
        for _ in range(rows)]).astype(np.float32)
    head_npy = os.path.join(keep_dir, "head_mask.npy")
    ffn_npy = os.path.join(keep_dir, "ffn_mask.npy")
    np.save(head_npy, keep(config.num_attention_heads, config.l_layers))
    np.save(ffn_npy, keep(config.intermediate_size, config.l_layers))
    runs = {
        "trained": ["--mask_pt", os.path.join(stage2_dir, "mask.pt"),
                    "--classifier_bin",
                    os.path.join(stage2_dir, "classifier4masker.bin")],
        "rand": ["--training_type", "FT_randMask", "--rand_scope",
                 "reference"],
        "structured": ["--head_mask_npy", head_npy, "--ffn_mask_npy",
                       ffn_npy],
    }
    out: dict = {}
    for tag, extra in runs.items():
        argv = ["--output_dir", os.path.join(keep_dir, f"stage3_{tag}"),
                "--device", str(device), "--dtype", "bfloat16", "--FT_type",
                "lmh", "--stage1_ckpt", stage1_bin, "--synthetic",
                str(S3_SYNTHETIC), "--train_batch_size", str(S1_BATCH),
                "--eval_batch_size", str(S1_BATCH), "--num_train_epochs", "1",
                "--logging_steps", "2", "--save_steps", "1000", "--seed",
                str(seed), "--do_train", "--do_eval", *extra] + (
                    ["--tiny"] if rehearse else [])
        t0 = time.monotonic()
        with _HeadsSeen() as seen:
            summary, launches = _run_counted(lambda: run_vqa_stage3.main(argv))
        wall_s = time.monotonic() - t0
        state = summary.pop("state")
        losses = summary.pop("losses")
        nonzero = 0
        if state.masks is not None:
            nonzero = sum(int(state.params[n][m == 0].count_nonzero())
                          for n, m in state.masks.items())
        res = {"steps": len(losses), "losses": losses, "wall_s": wall_s,
               "launches": launches, "zero_rate": summary["zero_rate"],
               "lang_num_heads": summary["lang_num_heads"],
               "lang_intermediate_size": summary["lang_intermediate_size"],
               "eval_acc": summary["eval_acc"],
               "masked_nonzero_after_steps": nonzero,
               "kernel_heads": sorted(seen.heads)}
        log(f"stage3 {tag}: " + json.dumps(res))
        del state, summary
        _free(torch, rehearse)
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"stage3 {tag}: losses {losses}")
        check(launches == _launch_counts(
            on_card, fused_attention_fwd_train=per_fwd * steps,
            fused_attention_bwd_stored=per_bwd * steps,
            fused_attention_fwd=per_fwd * steps),
            f"stage3 {tag}: launches {launches}")
        check(nonzero == 0, f"stage3 {tag}: {nonzero} masked weights moved "
                            "off zero")
        saved_bin = os.path.join(keep_dir, f"stage3_{tag}", "run" + (
            "FT_randMask.bin" if tag == "rand" else "_FT_trainedMask.bin"))
        for path in (saved_bin, saved_bin + ".msgpack"):
            check(os.path.exists(path), f"stage3 {tag}: {path} not written")
        out[tag] = res
    check(abs(out["trained"]["zero_rate"] - 0.7) <= 0.01,
          f"stage3 trained: audited zero rate {out['trained']['zero_rate']}")
    check(0.0 < out["rand"]["zero_rate"] < 0.7,
          f"stage3 rand: audited zero rate {out['rand']['zero_rate']}")
    heads = config.num_attention_heads // 2
    inter = config.intermediate_size  # half kept, padded to 128, capped
    check(out["structured"]["lang_num_heads"] == heads
          and out["structured"]["lang_intermediate_size"]
          == min(-(-(inter // 2) // 128) * 128, inter),
          f"stage3 structured: {out['structured']}")
    check(not on_card or out["structured"]["kernel_heads"] == sorted(
        {heads, config.num_attention_heads}),
        f"stage3 structured: the kernel ran at heads "
        f"{out['structured']['kernel_heads']}")
    out["trained"]["msgpack_serve"] = _serve_stage3_msgpack(
        torch, device, rehearse, seed, serve_root, config,
        os.path.join(keep_dir, "stage3_trained", "run_FT_trainedMask.bin"))

    # timed steps: (a) the trained mask, (c) the compacted model
    bf16 = LxmertConfig.tiny(dtype=torch.bfloat16) if rehearse else (
        LxmertConfig(dtype=torch.bfloat16))
    params = cli_common.lxmert_initial_params(bf16, seed, stage1_bin)
    masker = cli_common.lxmert_uniform_masker(bf16, 0.7)
    masks = torch_compat.import_mask_pt(os.path.join(stage2_dir, "mask.pt"),
                                        masker.specs)
    model, cfg, state, tx, batch = _stage1_setup(
        torch, bf16, device, seed, S1_BATCH,
        params=masker.prune_params(params, masks), masks=masks)
    out["trained"]["timed"] = _timed_steps(
        torch, stage1.make_train_step(model, cfg, tx), state, batch,
        rehearse, "stage3-step trained")
    del model, state, tx, batch, masks
    _free(torch, rehearse)
    params, nh = compaction.compact_lang_heads(params, np.load(head_npy),
                                               bf16.head_size)
    params, ni = compaction.compact_lang_ffns(params, np.load(ffn_npy))
    small = dataclasses.replace(bf16, lang_num_heads=nh,
                                lang_intermediate_size=ni)
    model, cfg, state, tx, batch = _stage1_setup(torch, small, device, seed,
                                                 S1_BATCH, params=params)
    out["structured"]["timed"] = _timed_steps(
        torch, stage1.make_train_step(model, cfg, tx), state, batch,
        rehearse, "stage3-step structured")
    del model, state, tx, batch, params
    _free(torch, rehearse)
    return out


MSGPACK_REQUESTS = 128


def _serve_stage3_msgpack(torch, device, rehearse, seed, root, config,
                          bin_path) -> dict:
    """`serve_vqa --ckpt <stage 3's .msgpack>` at full width, batch 32, the
    first MSGPACK_REQUESTS requests: bf16 and fp32, zero error responses,
    34 primal launches a forward; fp32 answers identical to serving the
    .bin of the same run."""
    per_forward = config.l_layers + config.r_layers + 4 * config.x_layers
    forwards = 1 + -(-MSGPACK_REQUESTS // SERVE_BATCH)  # warm-up included
    runs, answers, launches = {}, {}, {}
    for tag, dtype, ckpt in (
            ("bf16", "bfloat16", bin_path + ".msgpack"),
            ("fp32", "float32", bin_path + ".msgpack"),
            ("fp32_bin", "float32", bin_path)):
        (responses, runs[tag]), counts = _run_counted(lambda: _serve(
            root, dtype, "features.bin", device, rehearse, seed,
            f"stage3_{tag}", ckpt=ckpt, requests=MSGPACK_REQUESTS))
        launches[tag] = counts["fused_attention_fwd"]
        answers[tag] = [r["answer"] for r in responses]
        check(counts == _launch_counts(
            not rehearse, fused_attention_fwd=per_forward * forwards),
            f"stage3 serving {ckpt} ({dtype}): launches {counts}, want "
            f"{per_forward} x {forwards} forwards")
    same = sum(a == b for a, b in zip(answers["fp32"], answers["fp32_bin"]))
    check(same == MSGPACK_REQUESTS,
          f"stage3: fp32 answers from the .msgpack and the .bin differ "
          f"({same}/{MSGPACK_REQUESTS} identical)")
    out = {"requests": MSGPACK_REQUESTS, "per_forward": per_forward,
           "forwards": forwards, "launches": launches, "runs": runs,
           "fp32_identical_to_bin": same}
    log("stage3: served the .msgpack: " + json.dumps(out))
    return out


# ------------------------------------------------------ phases 18-19

VB_EPOCHS, VB_LOGGING_STEPS, VB_SAVE_STEPS = 1, 4, 8  # 8 steps


def _visualbert_setup(torch, config, device, seed, batch_size):
    """A VisualBERT stage-2 state at `config` (uniform zero rate 0.7,
    magnitude init, LMH loss, the head under `cls`) and one synthetic
    batch of 14 tokens and 36 boxes on the device."""
    import dataclasses

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.train import stage2

    masker = cli_common.visualbert_uniform_masker(
        config, 0.7, controlled_init="magnitude")
    params = cli_common.visualbert_initial_params(
        dataclasses.replace(config, dtype=torch.float32), seed, None)
    cfg = stage2.Stage2Config(masker_type="lmh", total_steps=1000,
                              hidden_size=config.hidden_size,
                              classifier_key="cls")
    model = stage2.visualbert_meta_model(config)
    state, tx = stage2.init_state(model, masker, params, cfg, seed, device)
    batch = to_device(synthetic_batch(
        batch_size=batch_size, seed=seed, vocab_size=config.vocab_size,
        ans_num=config.ans_num, feat_dim=config.visual_embedding_dim,
        style="visualbert"), device,
        float_dtype=config.dtype if config.dtype == torch.bfloat16 else None)
    return model, masker, cfg, state, tx, batch


def phase_visualbert_train(torch, device, rehearse: bool, seed: int,
                           data_root: str, keep_dir: str) -> dict:
    """`prune_debias_vqa_visualbert.main` at the full width of
    `VisualBertConfig()`, batch 256, bf16, LMH loss, zero rate 0.7,
    magnitude init, on phase serve's fabricated VQA-CP files: 8 steps with
    two threshold resets, a checkpoint, an eval and the export (kept in
    `keep_dir`/visualbert for phase visualbert-serve). Then timed steps on
    one batch kept on the card, the launches of one step, and one fp32
    step through the kernels against the plain versions."""
    import numpy as np

    from crvqa_tpu_torch.cli import prune_debias_vqa_visualbert as cli
    from crvqa_tpu_torch.models import VisualBertConfig, layers
    from crvqa_tpu_torch.train import stage2

    config = VisualBertConfig.tiny() if rehearse else VisualBertConfig()
    per_step = config.num_hidden_layers
    on_card = not rehearse
    steps = N_TRAIN // TRAIN_BATCH * VB_EPOCHS
    eval_batches = steps // VB_SAVE_STEPS * -(-N_TEST // TRAIN_BATCH)
    out = os.path.join(keep_dir, "visualbert_run")
    argv = ["--output_dir", out, "--dataroot", data_root,
            "--img_root", os.path.join(data_root, "features.bin"),
            "--vocab_file", os.path.join(data_root, "vocab.txt"),
            "--device", str(device), "--dtype", "bfloat16",
            "--train_batch_size", str(TRAIN_BATCH),
            "--eval_batch_size", str(TRAIN_BATCH),
            "--num_train_epochs", str(VB_EPOCHS),
            "--logging_steps", str(VB_LOGGING_STEPS),
            "--save_steps", str(VB_SAVE_STEPS), "--zero_rate", "0.7",
            "--controlled_init", "magnitude", "--Masker_type", "lmh",
            "--name_of_masker", "MaskedLinear1", "--do_train",
            "--evaluate_during_training", "--seed", str(seed)] + (
                ["--tiny"] if rehearse else [])
    t0 = time.monotonic()
    summary, launches = _run_counted(lambda: cli.main(argv))
    wall_s = time.monotonic() - t0
    losses = summary["losses"]
    log(f"visualbert-train: {len(losses)} steps at batch {TRAIN_BATCH} in "
        f"{wall_s:.1f} s (set-up, eval and checkpoint included); losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}; zero rates "
        f"{summary['zero_rates']}; best eval acc {summary['best_acc']}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"visualbert-train: {len(losses)} losses (want {steps}), finite: "
          f"{bool(np.all(np.isfinite(losses)))}")
    want = _launch_counts(on_card,
                          fused_attention_fwd_train=per_step * steps,
                          fused_attention_bwd_stored=per_step * steps,
                          fused_attention_fwd=per_step * eval_batches)
    check(launches == want,
          f"visualbert-train: launches {launches} != {want} ({per_step} "
          f"forward and backward per step x {steps} steps, {per_step} per "
          f"eval batch x {eval_batches})")
    rates = summary["zero_rates"]
    check(abs(rates["Uni"] - 0.7) <= 0.01,
          f"visualbert-train: zero rate after the reset {rates} misses 0.7")
    for name in ("mask.pt", "classifier4masker.bin", "test.json",
                 f"ckpt_{VB_SAVE_STEPS}"):
        check(os.path.exists(os.path.join(out, name)),
              f"visualbert-train: {name} not written")
    with open(os.path.join(out, "test.json")) as f:
        check(len(json.load(f)) == N_TEST,
              "visualbert-train: test.json incomplete")
    kept = os.path.join(keep_dir, "visualbert")
    os.makedirs(kept)
    for name in ("mask.pt", "classifier4masker.bin"):
        shutil.copy(os.path.join(out, name), kept)
    shutil.rmtree(out)
    result = {"steps": steps, "losses": losses, "launches": launches,
              "per_step": per_step, "eval_batches": eval_batches,
              "zero_rates": rates, "best_acc": summary["best_acc"],
              "wall_s": wall_s, "artifacts": kept}

    # timed steps, bf16, on one batch kept on the card
    bf16 = dataclasses.replace(config, dtype=torch.bfloat16)
    model, masker, cfg, state, tx, batch = _visualbert_setup(
        torch, bf16, device, seed, TRAIN_BATCH)
    step = stage2.make_train_step(model, masker, tx, cfg)
    _, step_launches = _run_counted(lambda: step(state, batch))
    check(step_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_step,
        fused_attention_bwd_stored=per_step),
        f"visualbert-step: one step's launches {step_launches}")
    result["step_launches"] = step_launches
    result["timed"] = _timed_steps(torch, step, state, batch, rehearse,
                                   "visualbert-step")
    del model, state, tx, batch, step
    _free(torch, rehearse)

    # one fp32 step with dropout on: kernels vs plain versions
    model, masker, cfg, state, tx, batch = _visualbert_setup(
        torch, config, device, seed + 1, CHECK_BATCH)
    fn = stage2.make_loss_and_grads(model, masker, cfg)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    (loss_k, _, grads_k), check_launches = _run_counted(
        lambda: fn(state, batch))
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    saved, layers.fused_attention = layers.fused_attention, _plain_attention
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    scores = sorted(k for k in grads_k if k.startswith("scores/"))
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in scores])
    # the longest sum of a weight gradient: over every row of the batch
    terms = CHECK_BATCH * VISUALBERT_SHAPE[0]
    grads_ok, grads_err = _close_to(torch, flat(grads_k), flat(grads_p),
                                    False, terms)
    loss_ok, loss_err = _close_to(torch, loss_k.reshape(1),
                                  loss_p.reshape(1), False, terms)
    check_out = {"batch": CHECK_BATCH, "loss_kernels": loss_k.item(),
                 "loss_plain": loss_p.item(), "loss_abs_diff": loss_err,
                 "score_grad_max": flat(grads_p).abs().max().item(),
                 "score_grad_max_abs_diff": grads_err, "terms": terms,
                 "launches": check_launches}
    log("visualbert-step check: " + json.dumps(check_out))
    check(check_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_step,
        fused_attention_bwd_stored=per_step),
        f"visualbert-step check: launches {check_launches}")
    check(loss_ok and grads_ok,
          f"one fp32 VisualBERT step with dropout: kernels vs plain "
          f"versions differ: {check_out} (tolerance: _close_to over "
          f"{terms} terms)")
    result["check"] = check_out
    del model, state, tx, batch
    _free(torch, rehearse)
    return result


def phase_visualbert_serve(torch, device, rehearse: bool, seed: int,
                           data_root: str, artifacts: str) -> dict:
    """`serve_vqa --model_type visualbert` at the full width of
    `VisualBertConfig()` over phase serve's fabricated store and requests,
    through phase visualbert-train's mask.pt and classifier4masker.bin:
    bf16 (.bin store) and fp32 (pickle) with the kernel, fp32 with the
    plain attention. Zero error responses, 12 primal launches per forward,
    fp32 answers identical to the plain attention's; then device time by
    kernel of one bf16 forward at batch 32 (profile)."""
    from crvqa_tpu_torch.models import (VisualBertConfig, build_visualbert,
                                        layers)

    config = VisualBertConfig.tiny() if rehearse else VisualBertConfig()
    per_forward = config.num_hidden_layers
    forwards = 1 + SERVE_REQUESTS // SERVE_BATCH  # warm-up + full batches
    on_card = not rehearse
    extra = ("--model_type", "visualbert")

    def serve(dtype, store, tag):
        return _run_counted(lambda: _serve(
            data_root, dtype, store, device, rehearse, seed, tag,
            artifacts=artifacts, extra=extra))

    want = _launch_counts(on_card, fused_attention_fwd=per_forward * forwards)
    (bf16, s_bf16), launches = serve("bfloat16", "features.bin",
                                     "visualbert_bf16_kernel")
    log("visualbert-serve: " + json.dumps(s_bf16))
    check(launches == want,
          f"visualbert-serve bf16: launches {launches} != {want} "
          f"({per_forward} per forward x {forwards} forwards)")
    (fp32, s_fp32), fp32_launches = serve("float32", "features.pickle",
                                          "visualbert_fp32_kernel")
    log("visualbert-serve: " + json.dumps(s_fp32))
    check(fp32_launches == want,
          f"visualbert-serve fp32: launches {fp32_launches} != {want}")
    saved, layers.fused_attention = layers.fused_attention, _plain_attention
    try:
        (plain, s_plain), plain_launches = serve(
            "float32", "features.pickle", "visualbert_fp32_plain")
    finally:
        layers.fused_attention = saved
    log("visualbert-serve: " + json.dumps(s_plain))
    check(plain_launches == _launch_counts(False),
          "visualbert-serve: the plain run launched a kernel")
    same = sum(a["answer"] == b["answer"] for a, b in zip(fp32, plain))
    dprob = max(abs(a["prob"] - b["prob"]) for a, b in zip(fp32, plain))
    agree = sum(a["answer"] == b["answer"] for a, b in zip(bf16, plain))
    log(f"visualbert-serve: fp32 kernel vs fp32 plain: {same}/{len(fp32)} "
        f"answers identical, max |prob diff| {dprob}; bf16 kernel vs fp32 "
        f"plain: {agree}/{len(bf16)} answers agree")
    check(same == len(fp32), "visualbert-serve: fp32 answers differ between "
                             "the kernel and the plain attention")
    out = {"launches": launches["fused_attention_fwd"],
           "per_forward": per_forward, "forwards": forwards,
           "runs": [s_bf16, s_fp32, s_plain], "fp32_prob_diff": dprob,
           "bf16_agreement": agree / len(bf16)}
    if not rehearse:
        # device time by kernel of the served model's forward alone
        model = build_visualbert(
            dataclasses.replace(config, dtype=torch.bfloat16), "cpu",
            torch.Generator().manual_seed(seed)).to(device).eval()
        g = torch.Generator().manual_seed(seed)
        inputs = dict(
            input_ids=torch.randint(1, 1000, (SERVE_BATCH, 14), generator=g
                                    ).to(device),
            visual_embeds=torch.randn(SERVE_BATCH, BOXES, 2048, generator=g
                                      ).to(device),
            attention_mask=torch.ones(SERVE_BATCH, 14, device=device))
        out["profile"] = _profile_forward(torch, model, inputs,
                                          "visualbert-serve profile")
        del model, inputs
        _free(torch, rehearse)
    return out


# ----------------------------------------------------------------- summary

# ----------------------------------------------------------------- phase 20

VQAVS_TRAIN, VQAVS_TEST = 1024, 512  # 4 steps at batch 256, 2 eval batches


def fabricate_vqavs(root: str, serve_root: str, rng, ans_num: int,
                    splits) -> dict:
    """The VQA-VS file contract (`dataset_LXM_VQAvs.py:118-289`) over phase
    serve's feature store and vocab: the three question JSONs, the train
    and test targets, the train_val_test answer vocabulary, and the
    `VQAvs_test_annotations.json` payload (`annotations` plus the nine
    `<split>_qid` lists, `comput_vqavs_score.py:121-135`). Returns the
    payload."""
    os.makedirs(os.path.join(root, "cache"))
    label2ans = ["yes", "no"] + [f"answer_{i}" for i in range(2, ans_num)]
    for name, obj in (("train_val_test_label2ans.pkl", label2ans),
                      ("train_val_test_ans2label.pkl",
                       {a: i for i, a in enumerate(label2ans)})):
        with open(os.path.join(root, "cache", name), "wb") as f:
            pickle.dump(obj, f)
    with open(os.path.join(serve_root, "features.pickle"), "rb") as f:
        images = sorted(pickle.load(f))
    annotations = []
    for split, fname, n, qid0 in (
            ("train", "Training-Ques.json", VQAVS_TRAIN, 3000000),
            ("val", "Val-Ques.json", 0, 4000000),
            ("test", "IID-Test-Ques.json", VQAVS_TEST, 5000000)):
        questions, targets = [], []
        for i in range(n):
            t = int(rng.integers(len(TEMPLATES)))
            subject = SUBJECTS[int(rng.integers(len(SUBJECTS)))]
            image = images[int(rng.integers(len(images)))]
            labels = sorted({int(x) % ans_num for x in
                             rng.integers(40 * t, 40 * t + 60, size=2)})
            counts = [int(rng.integers(1, 4)) for _ in labels]
            questions.append({"question_id": qid0 + i, "image_id": image,
                              "question": TEMPLATES[t].format(subject)})
            targets.append({"question_id": qid0 + i, "image_id": image,
                            "question_type": TEMPLATES[t].split(" {}")[0],
                            "labels": labels,
                            "scores": [min(1.0, c / 3) for c in counts]})
            if split == "test":
                words = [label2ans[x] for x in labels]
                annotations.append({
                    "question_id": qid0 + i, "answers_word": words,
                    "answer_count": dict(zip(words, counts)),
                    "answer_type": "yes/no" if t in (2, 4) else "other"})
        with open(os.path.join(root, fname), "w") as f:
            json.dump({"questions": questions}, f)
        if n:
            with open(os.path.join(root, "cache", f"{split}_target.pkl"),
                      "wb") as f:
                pickle.dump(targets, f)
    qids = [a["question_id"] for a in annotations]
    payload = {"annotations": annotations}
    for split in splits:
        payload[f"{split}_qid"] = [int(q) for q in rng.choice(
            qids, size=len(qids) // 3, replace=False)]
    with open(os.path.join(root, "VQAvs_test_annotations.json"), "w") as f:
        json.dump(payload, f)
    return payload


def phase_vqavs(torch, device, rehearse: bool, seed: int, serve_root: str,
                keep_dir: str) -> dict:
    """`crvqa_tpu_torch.cli.prune_debias_vqavs.main` at full width, batch
    256, bf16, phase train's canonical configuration, on fabricated VQA-VS
    files over phase serve's feature store: 4 steps with one threshold
    reset, an eval before training and one at step 4, the export. Checks
    finite losses, the launches per step and per eval batch,
    `prefictions_VQAvs_test.json` byte-equal to `test.json`, and the
    port's `compute_vqavs_scores` on it: the IID score, the 9 OOD splits
    and Final_Score, each finite and within [0, 100]; on the most-voted
    answers, the IID score their votes give."""
    import numpy as np

    from crvqa_tpu_torch.cli import prune_debias_vqavs
    from crvqa_tpu_torch.evals import VQAVS_SPLITS, compute_vqavs_scores
    from crvqa_tpu_torch.models import LxmertConfig

    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    fwd_mult, bwd_mult = launch_mult(config)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    steps = VQAVS_TRAIN // TRAIN_BATCH
    eval_batches = 2 * -(-VQAVS_TEST // TRAIN_BATCH)  # pre-train + step 4
    root = os.path.join(keep_dir, "vqavs")
    t0 = time.monotonic()
    payload = fabricate_vqavs(root, serve_root, np.random.default_rng(seed),
                              config.ans_num, VQAVS_SPLITS)
    fabricate_s = time.monotonic() - t0
    out = os.path.join(root, "out")
    argv = ["--output_dir", out, "--dataroot", root,
            "--img_root", os.path.join(serve_root, "features.bin"),
            "--vocab_file", os.path.join(serve_root, "vocab.txt"),
            "--device", str(device), "--dtype", "bfloat16",
            "--train_batch_size", str(TRAIN_BATCH),
            "--eval_batch_size", str(TRAIN_BATCH), "--num_train_epochs", "1",
            "--logging_steps", str(steps), "--save_steps", str(steps),
            "--Lang_comp", "0.3", "--Vis_comp", "0.3", "--Fus_comp", "0.3",
            "--zero_rate", "0.7", "--controlled_init", "magnitude",
            "--Masker_type", "lmh", "--name_of_masker", "MaskedLinear1",
            "--do_train", "--evaluate_during_training",
            "--seed", str(seed)] + (["--tiny"] if rehearse else [])
    t0 = time.monotonic()
    summary, launches = _run_counted(lambda: prune_debias_vqavs.main(argv))
    cli_s = time.monotonic() - t0
    losses = summary["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"vqavs: losses {losses} (want {steps} finite)")
    want = _launch_counts(
        not rehearse, fused_attention_fwd_train=per_fwd * steps,
        fused_attention_bwd_stored=per_bwd * steps,
        fused_attention_fwd=per_fwd * eval_batches)
    check(launches == want,
          f"vqavs: launches {launches} != {want} ({per_fwd} forward and "
          f"{per_bwd} backward per step x {steps}, {per_fwd} per eval batch "
          f"x {eval_batches})")
    with open(os.path.join(out, "test.json"), "rb") as f:
        test_json = f.read()
    with open(os.path.join(out, "prefictions_VQAvs_test.json"), "rb") as f:
        check(f.read() == test_json,
              "vqavs: prefictions_VQAvs_test.json is not test.json")
    preds = json.loads(test_json)
    check(len(preds) == VQAVS_TEST, f"vqavs: {len(preds)} predictions")
    scores = compute_vqavs_scores(preds, payload)
    check(set(scores) == {"iid", "Final_Score", *VQAVS_SPLITS}
          and all(np.isfinite(v) and 0.0 <= v <= 100.0
                  for v in scores.values()),
          f"vqavs: scores {scores}")
    # random weights score about 0 here; the scorer itself is held to the
    # most-voted answers, whose IID score is the mean of min(1, votes / 3)
    annos = payload["annotations"]
    best = [max(a["answer_count"].values()) for a in annos]
    oracle = compute_vqavs_scores(
        [{"question_id": a["question_id"], "answer": max(
            a["answer_count"], key=a["answer_count"].get)} for a in annos],
        payload)
    want_iid = round(100.0 * sum(min(1.0, c / 3) for c in best)
                     / len(best), 2)
    check(oracle["iid"] == want_iid and 0.0 < oracle["Final_Score"] <= 100.0,
          f"vqavs: the most-voted answers score {oracle}, IID not {want_iid}")
    shutil.rmtree(root)
    result = {"steps": steps, "losses": losses, "launches": launches,
              "per_forward": per_fwd, "per_backward": per_bwd,
              "eval_batches": eval_batches, "zero_rates": summary["zero_rates"],
              "scores": scores, "oracle_scores": oracle,
              "fabricate_s": fabricate_s, "cli_s": cli_s}
    log("vqavs: " + json.dumps(result))
    return result


# ------------------------------------------------------------ phase 21

STRUCT_LOGGING = 4               # a threshold reset every 4 steps
# --profile_start_step, --profile_steps: the window opens at tick 4, so
# step 4's threshold reset falls in the discarded warm-up and steps 6-7
# are plain train steps
STRUCT_PROFILE = (5, 2)
STRUCT_LAYERS_RATIO = 0.25       # 512 of the 2048 questions: 2 steps
STRUCT_CHECK_BATCH = 8


def _trace_split(path: str, steps: int) -> dict:
    """A ProfileWindow's Chrome trace over `steps` active steps: the short
    attention kernels it holds (forward, backward), the device's busy time
    per step (its kernels', copies' and sets' durations, by category), the
    wall time per step (first to last event of the window) and the idle
    share."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e and "ts" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def category(e) -> str:
        name = e.get("name", "")
        if "fused_attention" in name:
            return ("fused_attention_bwd" if "bwd" in name
                    else "fused_attention_fwd")
        if e.get("cat") != "kernel":
            return "copy"
        low = name.lower()
        if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma",
                                  "gemv", "sm90_")):
            return "gemm"
        return "other"

    by_cat: dict = {}
    calls: dict = {}
    by_name: dict = {}
    for e in device:
        c = category(e)
        by_cat[c] = by_cat.get(c, 0.0) + e["dur"] / 1e3 / steps
        calls[c] = calls.get(c, 0) + 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = [{"ms": us / 1e3 / steps, "name": name[:100]} for name, us in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]
    wall_ms = ((max(e["ts"] + e["dur"] for e in events)
                - min(e["ts"] for e in events)) / 1e3 / steps
               if events else 0.0)
    busy_ms = sum(by_cat.values())
    return {"attention_fwd": calls.get("fused_attention_fwd", 0),
            "attention_bwd": calls.get("fused_attention_bwd", 0),
            "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": (max(0.0, 1 - busy_ms / wall_ms) if wall_ms
                           else None),
            "by_category_ms": by_cat, "launches_by_category": calls,
            "top": top, "bytes": os.path.getsize(path)}


def _f32(v: float) -> float:
    import struct

    return struct.unpack("<f", struct.pack("<f", v))[0]


def _trained_heads_rows(torch, device, rehearse, seed, heads) -> list:
    """The primal (rate 0, as an eval runs it), the forward for grad and
    the stored backward (rate 0.1) at `heads` (stage 3's uniform kept
    count), LXMERT's four (Sq, Sk), batch 64, bf16, against their plain
    versions with the tolerances the kernel phases hold them to at 12 and
    6 heads (`_close_to` does not fit these bf16 outputs: on the card
    they differ by 2^-8, one bf16 step between 0.5 and 1, where |want|
    is below 0.5 and its 2^-7 |want| allows less); timed on the card
    beside the plain versions and `scaled_dot_product_attention`."""
    import torch.nn.functional as F

    from crvqa_tpu_torch.ops import fused_attention as fa

    b = 2 if rehearse else S1_BATCH
    rows = []
    for sq, sk in SERVE_SHAPES:
        q, k, v, bias = _attention_inputs(torch, b, sq, sk, "bfloat16",
                                          device, seed + 7 * sq + sk, heads)
        gen = torch.Generator().manual_seed(seed + sq * sk)
        g = torch.randn(q.shape, generator=gen).to(device, q.dtype)
        args = (heads, 64, MAIN_RATE, KERNEL_SEED)
        primal = fa.fused_attention(q, k, v, bias, heads, 64)
        primal_ref = fa.fused_attention_reference(q, k, v, bias, heads, 64)
        out, p = fa.fused_attention_fwd_train(q, k, v, bias, *args)
        ref_out, ref_p = fa.fused_attention_train_reference(q, k, v, bias,
                                                            *args)
        stored = fa.fused_attention_bwd_stored(q, k, v, p, g, *args)
        ref_s = fa.fused_attention_bwd_reference(q, k, v, p, g, *args)
        pairs = {"primal": (primal, primal_ref, TOL["bfloat16"]),
                 "fwd": (out, ref_out, TOL["bfloat16"]),
                 "p": (p, ref_p, dict(atol=TOL_P, rtol=0.0))}
        for name, x, y in zip(("dq", "dk", "dv"), stored, ref_s):
            pairs[name] = (x, y, TOL_BWD["bfloat16"])
        checks = {n: (bool(torch.allclose(x.float(), y.float(), **tol)),
                      _max_err(torch, [x], [y]))
                  for n, (x, y, tol) in pairs.items()}
        row = {"batch": b, "dtype": "bfloat16", "rate": MAIN_RATE,
               "heads": heads, "sq": sq, "sk": sk,
               **{f"{n}_err": err for n, (_, err) in checks.items()}}
        row["primal_bytes_ms"], row["primal_ops_ms"] = _bound_terms(
            b, sq, sk, "bfloat16", heads)
        for kind in ("fwd", "stored"):
            row[f"{kind}_bytes_ms"], row[f"{kind}_ops_ms"] = (
                _train_bound_terms(b, sq, sk, "bfloat16", kind, heads))
        if not rehearse:
            split = lambda t: (t.view(b, t.shape[1], heads, 64)
                               .transpose(1, 2).detach().requires_grad_())
            qh, kh, vh = split(q), split(k), split(v)
            gh = g.view(b, sq, heads, 64).transpose(1, 2)
            mask = bias.to(q.dtype)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
            timed = {
                "primal_ms": lambda: fa.fused_attention(q, k, v, bias,
                                                        heads, 64),
                "primal_plain_ms": lambda: fa.fused_attention_reference(
                    q, k, v, bias, heads, 64),
                "fwd_ms": lambda: fa.fused_attention_fwd_train(
                    q, k, v, bias, *args),
                "fwd_plain_ms": lambda: fa.fused_attention_train_reference(
                    q, k, v, bias, *args),
                "stored_ms": lambda: fa.fused_attention_bwd_stored(
                    q, k, v, p, g, *args),
                "stored_plain_ms": lambda: fa.fused_attention_bwd_reference(
                    q, k, v, p, g, *args),
                "library_primal_ms": lambda: F.scaled_dot_product_attention(
                    qh.detach(), kh.detach(), vh.detach(), attn_mask=mask),
                "library_fwd_ms": sdpa,
                "library_fwd_bwd_ms": lambda: torch.autograd.grad(
                    sdpa(), (qh, kh, vh), gh)}
            for key, fn in timed.items():
                row[key] = _graph_ms(torch, fn)
        rows.append(row)
        log("structured-kernels: " + json.dumps(row))
        check(all(ok for ok, _ in checks.values()),
              f"short attention kernels at the trained {heads} heads "
              f"disagree with their plain versions at B={b} bf16 rate "
              f"{MAIN_RATE} ({sq},{sk}): {row} (tolerances: outputs "
              f"{TOL['bfloat16']}, gradients {TOL_BWD['bfloat16']}, p "
              f"{TOL_P}, as at 12 and 6 heads in phases kernel and "
              f"train-kernels)")
    return rows


def phase_structured(torch, device, rehearse: bool, seed: int,
                     data_root: str, stage1_bin: str, keep_dir: str
                     ) -> dict:
    """Structured mask training at full width (module docstring, phase
    21): `prune_debias_vqa --structured_masking heads` (8 steps, a trace
    window and a TensorBoard file) and `layers` (2 steps); stage 3 from
    the trained head_mask.npy, with the short kernels held at its kept
    head count first; one fp32 structured step through the kernels
    against the plain versions, and timed bf16 structured steps."""
    import glob

    import numpy as np

    from crvqa_tpu_torch.cli import prune_debias_vqa, run_vqa_stage3
    from crvqa_tpu_torch.masking import compaction
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.models import LxmertConfig, layers
    from crvqa_tpu_torch.train import stage2
    from crvqa_tpu_torch.utils.tb_events import read_scalars

    on_card = not rehearse
    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    fwd_mult, bwd_mult = launch_mult(config)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    heads, hs = config.num_attention_heads, config.head_size
    steps = N_TRAIN // TRAIN_BATCH
    eval_batches = -(-N_TEST // TRAIN_BATCH)
    rates = ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7).as_dict()
    self_specs = [s for s in lxmert_mask_specs(
        config.l_layers, config.r_layers, config.x_layers)
        if "self" in ".".join(s.path)]
    root = os.path.join(keep_dir, "structured")
    out: dict = {"self_specs": len(self_specs)}

    def argv(out_dir, kind, *extra):
        return ["--output_dir", out_dir, "--dataroot", data_root,
                "--img_root", os.path.join(data_root, "features.bin"),
                "--vocab_file", os.path.join(data_root, "vocab.txt"),
                "--device", str(device), "--dtype", "bfloat16",
                "--train_batch_size", str(TRAIN_BATCH),
                "--eval_batch_size", str(TRAIN_BATCH),
                "--num_train_epochs", "1",
                "--logging_steps", str(STRUCT_LOGGING),
                "--save_steps", "1000", "--Lang_comp", "0.3",
                "--Vis_comp", "0.3", "--Fus_comp", "0.3",
                "--zero_rate", "0.7", "--controlled_init", "magnitude",
                "--Masker_type", "lmh", "--name_of_masker", "MaskedLinear1",
                "--structured_masking", kind, "--do_train",
                "--seed", str(seed), *extra] + (["--tiny"] if rehearse
                                                 else [])

    def structured_masks(path, state, gate_shape):
        """Each structured weight of mask.pt: its 64-row head blocks (the
        whole matrix for a scalar gate) all 0 or all 1, equal to the
        final gates."""
        masks = torch.load(path, weights_only=True)
        for s in self_specs:
            kept = (state.scores[s.key] > state.thresholds[s.key]).cpu()
            check(tuple(kept.shape) == gate_shape,
                  f"structured: {s.key} gate shape {tuple(kept.shape)}")
            m = masks[f"{s.torch_name}.weight"]
            m = m.reshape(heads, hs, -1) if gate_shape else m.reshape(1, -1)
            const = m.all(dim=-1).all(dim=-1) | ~m.any(dim=-1).any(dim=-1)
            check(bool(const.all()) and torch.equal(
                m.reshape(m.shape[0], -1)[:, 0], kept.reshape(-1)),
                f"structured: mask.pt {s.torch_name}: blocks not constant "
                "or not the final gates")

    # 1. heads: 8 steps, resets at 4 and 8, a trace of steps 5-6, the
    # export and an eval
    heads_dir = os.path.join(root, "heads")
    prof_dir, tb_dir = (os.path.join(root, "profile"),
                        os.path.join(root, "tb"))
    t0 = time.monotonic()
    summary, launches = _run_counted(lambda: prune_debias_vqa.main(argv(
        heads_dir, "heads", "--do_eval", "--profile_dir", prof_dir,
        "--profile_start_step", str(STRUCT_PROFILE[0]),
        "--profile_steps", str(STRUCT_PROFILE[1]),
        "--tensorboard_dir", tb_dir)))
    wall_s = time.monotonic() - t0
    state = summary.pop("state")
    losses = summary["losses"]
    log(f"structured heads: {len(losses)} steps at batch {TRAIN_BATCH} in "
        f"{wall_s:.1f} s (set-up, the trace, the export and an eval "
        f"included); losses {[round(x, 4) for x in losses]}; launches "
        f"{launches}; gate-level zero rates {summary['zero_rates']}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"structured heads: losses {losses}")
    want = _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd * steps,
        fused_attention_bwd_stored=per_bwd * steps,
        fused_attention_fwd=per_fwd * eval_batches)
    check(launches == want, f"structured heads: launches {launches} != "
                            f"{want}")
    gates = sorted(k for k, v in state.scores.items()
                   if tuple(v.shape) == (heads,))
    log(f"structured heads: {len(gates)} specs carry ({heads},) gates; "
        f"{len(self_specs)} specs match 'self'")
    check(gates == sorted(s.key for s in self_specs),
          f"structured heads: ({heads},) gates on {len(gates)} specs, "
          f"{len(self_specs)} match 'self'")
    for s in self_specs:  # after the export's reset
        k = max(int(heads * rates[s.modality]), 1)
        off = int((state.scores[s.key] <= state.thresholds[s.key]).sum())
        check(off == k, f"structured heads: {s.key} has {off} gates at or "
                        f"below its threshold, not {k}")
    structured_masks(os.path.join(heads_dir, "mask.pt"), state, (heads,))
    del state
    _free(torch, rehearse)
    hm_path = os.path.join(heads_dir, "head_mask.npy")
    hm = np.load(hm_path)
    kept = [int(x) for x in hm.sum(axis=1)]
    log(f"structured heads: head_mask.npy {hm.shape}, heads kept per "
        f"language layer {kept}")
    check(hm.shape == (config.l_layers, heads) and hm.dtype == np.float32
          and set(np.unique(hm).tolist()) <= {0.0, 1.0},
          f"structured heads: head_mask.npy {hm.shape} {hm.dtype}")
    trace = summary["trace"]
    check(trace is not None and os.path.exists(trace),
          f"structured heads: no trace in {prof_dir}")
    split = _trace_split(trace, STRUCT_PROFILE[1])
    log(f"structured-trace: steps {STRUCT_PROFILE[0] + 1}-"
        f"{STRUCT_PROFILE[0] + STRUCT_PROFILE[1]} of the CLI: device busy "
        f"{split['busy_ms']:.3f} ms/step, wall {split['wall_ms']:.3f} "
        f"ms/step, idle share {split['idle_share']}; by category (ms/step) "
        f"{json.dumps(split['by_category_ms'])}; launches "
        f"{json.dumps(split['launches_by_category'])}")
    want_attn = (STRUCT_PROFILE[1] * per_fwd * on_card,
                 STRUCT_PROFILE[1] * per_bwd * on_card)
    check((split["attention_fwd"], split["attention_bwd"]) == want_attn,
          f"structured heads: the trace holds {split['attention_fwd']} "
          f"forward and {split['attention_bwd']} backward attention "
          f"kernels, not {want_attn}")
    for t in split["top"]:
        log(f"structured-trace: {t['ms']:9.4f} ms/step  {t['name'][:90]}")
    with open(os.path.join(heads_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    (events,) = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
    tb_loss = [(s, v) for _, s, tag, v in read_scalars(events)
               if tag == "loss"]
    jl_loss = [(x["step"], _f32(x["loss"])) for x in logged if "loss" in x]
    check(tb_loss == jl_loss and len(jl_loss) == steps // STRUCT_LOGGING,
          f"structured heads: TensorBoard loss {tb_loss} != metrics.jsonl "
          f"{jl_loss}")
    out["heads"] = {"steps": steps, "losses": losses, "launches": launches,
                    "wall_s": wall_s, "zero_rates": summary["zero_rates"],
                    "head_gate_specs": len(gates), "heads_kept": kept,
                    "trace": split, "logged_ex_s": [
                        x["ex_s"] for x in logged if "ex_s" in x]}

    # 2. layers: scalar gates, 2 steps
    layers_dir = os.path.join(root, "layers")
    lsum, llaunches = _run_counted(lambda: prune_debias_vqa.main(argv(
        layers_dir, "layers", "--data_ratio", str(STRUCT_LAYERS_RATIO))))
    lstate = lsum.pop("state")
    lsteps = len(lsum["losses"])
    log(f"structured layers: {lsteps} steps: losses "
        f"{[round(x, 4) for x in lsum['losses']]}; launches {llaunches}")
    check(lsteps == int(N_TRAIN * STRUCT_LAYERS_RATIO) // TRAIN_BATCH
          and all(np.isfinite(lsum["losses"])),
          f"structured layers: losses {lsum['losses']}")
    check(llaunches == _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd * lsteps,
        fused_attention_bwd_stored=per_bwd * lsteps),
        f"structured layers: launches {llaunches}")
    scalar = sorted(k for k, v in lstate.scores.items() if v.dim() == 0)
    check(scalar == sorted(s.key for s in self_specs),
          f"structured layers: scalar gates on {len(scalar)} specs")
    structured_masks(os.path.join(layers_dir, "mask.pt"), lstate, ())
    check(not os.path.exists(os.path.join(layers_dir, "head_mask.npy")),
          "structured layers: wrote a head_mask.npy")
    out["layers"] = {"steps": lsteps, "losses": lsum["losses"],
                     "launches": llaunches, "scalar_gates": len(scalar)}
    del lstate
    _free(torch, rehearse)

    # 3. stage 3 from the trained head_mask.npy: the kernels at its kept
    # head count, then the CLI
    h_prime = min(compaction._pad_count(hm.sum(axis=1), 2), heads)
    log(f"structured: stage 3 compacts the language layers to H' = "
        f"{h_prime} heads")
    out["h_prime"] = h_prime
    out["kernel_rows"] = _trained_heads_rows(torch, device, rehearse, seed,
                                             h_prime)
    s3_steps = S3_SYNTHETIC // S1_BATCH
    s3_argv = ["--output_dir", os.path.join(root, "stage3"), "--device",
               str(device), "--dtype", "bfloat16", "--FT_type", "lmh",
               "--stage1_ckpt", stage1_bin, "--synthetic", str(S3_SYNTHETIC),
               "--train_batch_size", str(S1_BATCH), "--eval_batch_size",
               str(S1_BATCH), "--num_train_epochs", "1", "--logging_steps",
               "2", "--save_steps", "1000", "--seed", str(seed),
               "--do_train", "--do_eval", "--head_mask_npy", hm_path] + (
                   ["--tiny"] if rehearse else [])
    with _HeadsSeen() as seen:
        s3, s3_launches = _run_counted(lambda: run_vqa_stage3.main(s3_argv))
    s3.pop("state")
    log(f"structured stage3: H' {s3['lang_num_heads']}, losses "
        f"{[round(x, 4) for x in s3['losses']]}, eval acc {s3['eval_acc']},"
        f" launches {s3_launches}, kernel heads {sorted(seen.heads)}")
    check(len(s3["losses"]) == s3_steps and all(np.isfinite(s3["losses"])),
          f"structured stage3: losses {s3['losses']}")
    check(s3["lang_num_heads"] == h_prime,
          f"structured stage3: {s3['lang_num_heads']} heads, not {h_prime}")
    check(s3_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd * s3_steps,
        fused_attention_bwd_stored=per_bwd * s3_steps,
        fused_attention_fwd=per_fwd * s3_steps),
        f"structured stage3: launches {s3_launches}")
    check(not on_card or sorted(seen.heads) == sorted({h_prime, heads}),
          f"structured stage3: the kernel ran at heads {sorted(seen.heads)}")
    out["stage3"] = {"steps": s3_steps, "losses": s3["losses"],
                     "launches": s3_launches, "eval_acc": s3["eval_acc"],
                     "kernel_heads": sorted(seen.heads)}
    _free(torch, rehearse)

    # 4. one fp32 structured step with dropout on: kernels vs plain
    # versions from the same generators; then timed bf16 steps
    model, masker, cfg, state, tx, batch = _stage2_setup(
        torch, config, device, seed + 1, STRUCT_CHECK_BATCH, "heads")
    state = stage2.make_threshold_reset(masker)(state)
    fn = stage2.make_loss_and_grads(model, masker, cfg)
    rng = (state.rng.device.get_state(), state.rng.host.get_state())
    (loss_k, _, grads_k), check_launches = _run_counted(
        lambda: fn(state, batch))
    state.rng.device.set_state(rng[0])
    state.rng.host.set_state(rng[1])
    saved, layers.fused_attention = layers.fused_attention, _plain_attention
    try:
        loss_p, _, grads_p = fn(state, batch)
    finally:
        layers.fused_attention = saved
    scores = sorted(k for k in grads_k if k.startswith("scores/"))
    flat = lambda g: torch.cat([g[k].reshape(-1) for k in scores])
    terms = STRUCT_CHECK_BATCH * BOXES  # a weight gradient's longest sum
    grads_ok, grads_err = _close_to(torch, flat(grads_k), flat(grads_p),
                                    False, terms)
    loss_ok, loss_err = _close_to(torch, loss_k.reshape(1),
                                  loss_p.reshape(1), False, terms)
    check_out = {"batch": STRUCT_CHECK_BATCH, "loss_kernels": loss_k.item(),
                 "loss_plain": loss_p.item(), "loss_abs_diff": loss_err,
                 "score_grad_max": flat(grads_p).abs().max().item(),
                 "score_grad_max_abs_diff": grads_err, "terms": terms,
                 "launches": check_launches}
    log("structured-step check: " + json.dumps(check_out))
    check(check_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd,
        fused_attention_bwd_stored=per_bwd),
        f"structured-step check: launches {check_launches}")
    check(loss_ok and grads_ok,
          f"one fp32 structured step with dropout: kernels vs plain "
          f"versions differ: {check_out} (tolerance: _close_to over "
          f"{terms} terms)")
    out["check"] = check_out
    del model, state, tx, batch, fn, grads_k, grads_p
    _free(torch, rehearse)

    bf16 = LxmertConfig.tiny(dtype=torch.bfloat16) if rehearse else (
        LxmertConfig(dtype=torch.bfloat16))
    model, masker, cfg, state, tx, batch = _stage2_setup(
        torch, bf16, device, seed, TRAIN_BATCH, "heads")
    state = stage2.make_threshold_reset(masker)(state)
    step = stage2.make_train_step(model, masker, tx, cfg)
    _, step_launches = _run_counted(lambda: step(state, batch))
    check(step_launches == _launch_counts(
        on_card, fused_attention_fwd_train=per_fwd,
        fused_attention_bwd_stored=per_bwd),
        f"structured-step: one step's launches {step_launches}")
    out["timed"] = _timed_steps(torch, step, state, batch, rehearse,
                                "structured-step")
    # one threshold reset of this state (the CLI's, every
    # --logging_steps), on the host clock to a synchronise
    sync = (lambda: None) if rehearse else torch.cuda.synchronize
    reset = stage2.make_threshold_reset(masker)
    sync()
    t0 = time.monotonic()
    reset(state)
    sync()
    out["reset_ms"] = 1e3 * (time.monotonic() - t0)
    log(f"structured-step: one threshold reset {out['reset_ms']:.3f} ms")
    del model, state, tx, batch, step
    _free(torch, rehearse)
    return out


def _visualbert_entry(rows, prefix, err_keys, library, layers, launches,
                      basis) -> dict:
    """A short kernel's numbers on VisualBERT's path: its (50,50) row
    (`rows` holds one) times the `layers` launches of one forward or step;
    `prefix` names the row's keys ("" for the primal's)."""
    (row,) = rows
    key = lambda name: f"{prefix}{name}" if prefix else name
    bound_ms, bound_by = _bound(layers * row[key("bytes_ms")],
                                layers * row[key("ops_ms")])
    return {"launches": launches,
            "max_abs_err": max(row[k] for k in err_keys),
            "ms": layers * row[key("ms")],
            "plain_ms": layers * row[key("plain_ms")],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": layers * row[library],
            "basis": f"{basis}: {layers} launches at (Sq,Sk) "
                     f"{VISUALBERT_SHAPE}, 12 heads"}


def _trained_heads_entry(structured, prefix, err_keys, library, mult,
                         launches) -> dict:
    """A short kernel's numbers at the kept head count H' of phase
    structured's trained head_mask.npy: its rows at LXMERT's (Sq, Sk),
    batch 64, summed over one stage-3 step's (or forward's) launches."""
    rows = structured["kernel_rows"]
    tot = lambda name: sum(r[f"{prefix}_{name}"] * mult[(r["sq"], r["sk"])]
                           for r in rows)
    bound_ms, bound_by = _bound(tot("bytes_ms"), tot("ops_ms"))
    return {"heads": structured["h_prime"], "launches": launches,
            "max_abs_err": max(r[k] for r in rows for k in err_keys),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(r[library] * mult[(r["sq"], r["sk"])]
                              for r in rows),
            "basis": f"stage 3 at the trained H' = {structured['h_prime']} "
                     f"heads, bf16, batch {rows[0]['batch']}: "
                     f"{sum(mult.values())} launches over (Sq,Sk) "
                     + ", ".join(f"{k}x{v}" for k, v in mult.items())}


# ----------------------------------------------------------------- phase 23

RESUME_LR = 5e-5  # the CLI's default: the parity tolerance is 2 * lr * steps
NO_DROPOUT = ("--hidden_dropout_prob", "0", "--attention_probs_dropout_prob",
              "0", "--classifier_dropout", "0")


def _tree_diff(torch, a, b, path="") -> list[str]:
    """Paths where two file trees (nested dicts of numpy arrays and bf16
    tensors) differ in structure, type, dtype, shape or any bit."""
    import numpy as np

    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            return [path or "/"]
        return [d for k in b for d in _tree_diff(torch, a[k], b[k],
                                                 f"{path}/{k}")]
    if a is None or b is None:
        return [] if a is b else [path]
    raw = lambda x: (x.contiguous().view(torch.int16).numpy().tobytes()
                     if isinstance(x, torch.Tensor)
                     else np.ascontiguousarray(x).tobytes())
    same = (type(a) is type(b) and a.dtype == b.dtype
            and tuple(a.shape) == tuple(b.shape) and raw(a) == raw(b))
    return [] if same else [path]


def _state_bits_equal(torch, a, b) -> bool:
    """Two port stage-2 states hold bit-identical tensors and generators."""
    dicts = lambda s: [s.frozen, s.scores, s.thresholds,
                       *s.train_params.values(), s.opt_state.mu,
                       s.opt_state.nu]
    for x, y in zip(dicts(a), dicts(b)):
        if set(x) != set(y) or not all(torch.equal(x[k], y[k]) for k in x):
            return False
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and torch.equal(a.rng.device.get_state(),
                            b.rng.device.get_state())
            and torch.equal(a.rng.host.get_state(), b.rng.host.get_state()))


def _write_jax(path, tree) -> dict:
    from crvqa_tpu_torch.core import checkpoint as ckpt

    t0 = time.monotonic()
    ckpt.save_jax_training_state(path, tree, metadata={
        "step": int(tree["step"])})
    return {"bytes": os.path.getsize(path),
            "write_s": time.monotonic() - t0}


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _resume_stage2(torch, device, rehearse, seed, root, total) -> dict:
    """Phase resume (a): LXMERT stage 2 at full width."""
    import numpy as np

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.cli import prune_debias_vqa
    from crvqa_tpu_torch.core import checkpoint as ckpt
    from crvqa_tpu_torch.core import convert
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.train import stage2

    on_card = not rehearse
    fp32 = (LxmertConfig.tiny if rehearse else LxmertConfig)(
        dtype=torch.float32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, classifier_dropout=0.0)
    fwd_mult, bwd_mult = launch_mult(fp32)
    per_fwd, per_bwd = sum(fwd_mult.values()), sum(bwd_mult.values())
    specs = lxmert_mask_specs(fp32.l_layers, fp32.r_layers, fp32.x_layers)
    model = stage2.lxmert_meta_model(fp32)
    cfg = stage2.Stage2Config(hidden_size=fp32.hidden_size)

    def argv(tag, dtype, save, *extra):
        return ["--output_dir", os.path.join(root, tag), "--device",
                str(device), "--dtype", dtype, "--synthetic",
                str(2 * TRAIN_BATCH), "--synthetic_pool", "2",
                "--train_batch_size", str(TRAIN_BATCH), "--eval_batch_size",
                str(TRAIN_BATCH), "--num_train_epochs", "1",
                "--logging_steps", "2", "--save_steps", str(save),
                "--learning_rate", str(RESUME_LR), "--Lang_comp", "0.3",
                "--Vis_comp", "0.3", "--Fus_comp", "0.3", "--zero_rate",
                "0.7", "--controlled_init", "magnitude", "--Masker_type",
                "lmh", "--seed", str(seed), "--do_train", *NO_DROPOUT,
                *extra] + (["--tiny"] if rehearse else [])

    def counted(tag, fn, steps):
        summary, launches = _run_counted(fn)
        _add_launches(total, launches)
        want = _launch_counts(on_card,
                              fused_attention_fwd_train=per_fwd * steps,
                              fused_attention_bwd_stored=per_bwd * steps)
        check(launches == want, f"resume {tag}: launches {launches} != "
                                f"{want} ({per_fwd} + {per_bwd} a step)")
        losses = summary["losses"]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"resume {tag}: losses {losses} (want {steps}, finite)")
        return summary, launches

    out: dict = {"per_step": [per_fwd, per_bwd]}
    # the port's own run: 2 fp32 steps, ckpt_2 in its format
    first, _ = counted("stage2 first", lambda: prune_debias_vqa.main(
        argv("first", "float32", 2)), 2)
    state = first["state"]
    ckpt.load_checkpoint(os.path.join(root, "first", "ckpt_2"), state)
    jax_path = os.path.join(root, "jax_ckpt_2")
    written = convert.jax_from_stage2_state(state, model, specs, cfg)
    out["file"] = _write_jax(jax_path, written)
    del first, state
    _free(torch, rehearse)

    # read back twice into fresh states: bit-equal to what was written,
    # and to each other (leaves and generators)
    params = cli_common.lxmert_initial_params(fp32, seed, None)
    masker = Masker.create(specs, ModalSparsity.from_compression(
        0.3, 0.3, 0.3, 0.7), controlled_init="magnitude")
    reads, states = [], []
    for _ in range(2):
        st, _ = stage2.init_state(model, masker, params, cfg, seed, device)
        t0 = time.monotonic()
        cli_common.resume_any(jax_path, st, "stage2", cfg, specs)
        if on_card:
            torch.cuda.synchronize()
        reads.append(time.monotonic() - t0)
        states.append(st)
    diff = _tree_diff(torch, convert.jax_from_stage2_state(
        states[0], model, specs, cfg), written)
    check(not diff, f"resume stage2: {len(diff)} leaves differ from what "
                    f"was written, first {diff[:3]}")
    check(_state_bits_equal(torch, *states),
          "resume stage2: two reads of one file differ")
    out["file"]["read_s"] = reads
    del written, states
    _free(torch, rehearse)

    # timed bf16 steps (dropout 0.1, the main path's) from the file
    out.update(_resume_timed_bf16(torch, device, rehearse, seed, masker,
                                  params, jax_path, specs, cfg))
    del params
    _free(torch, rehearse)

    # 2 fp32 steps from the JAX-layout file vs from the port's ckpt_2
    b, out["launches"] = counted("stage2 from the JAX file",
                                 lambda: prune_debias_vqa.main(argv(
                                     "from_jax", "float32", 0,
                                     "--resume_from", jax_path)), 2)
    c, _ = counted("stage2 from the port's file", lambda: prune_debias_vqa.main(
        argv("from_port", "float32", 0, "--resume_from",
             os.path.join(root, "first", "ckpt_2"))), 2)
    check(b["step"] == c["step"] == 4, f"resume stage2: steps {b['step']}, "
                                       f"{c['step']} (want 4)")
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                       c["losses"]))
    sb, sc = b["state"], c["state"]
    leaves = lambda s: {**{f"scores/{k}": v for k, v in s.scores.items()},
                        **{f"classifier/{k}": v for k, v in
                           s.train_params["classifier"].items()}}
    lb, lc = leaves(sb), leaves(sc)
    max_diff = max(float((lb[k].float() - lc[k].float()).abs().max())
                   for k in lb)
    out.update(losses_from_jax=b["losses"], losses_from_port=c["losses"],
               loss_rel_diff=loss_rel, leaves_max_abs_diff=max_diff)
    log(f"resume stage2: 2 fp32 steps from the JAX-layout file vs the "
        f"port's own: losses {b['losses']} / {c['losses']}, trained leaves "
        f"max |diff| {max_diff:.3g}")
    check(loss_rel <= 1e-4 and max_diff <= 2 * RESUME_LR * 2,
          f"resume stage2: the steps from the two files differ (loss rel "
          f"{loss_rel:.3g} > 1e-4 or leaves {max_diff:.3g} > "
          f"{2 * RESUME_LR * 2})")
    del b, c, sb, sc, lb, lc
    _free(torch, rehearse)

    log(f"resume stage2: JAX-layout file {out['file']['bytes']} bytes, "
        f"written in {out['file']['write_s']:.2f} s, read and carried in "
        f"{[round(r, 2) for r in reads]} s; bf16 steps from it: "
        f"{out['bf16_step_ms']:.2f} ms a step, losses "
        f"{[round(x, 4) for x in out['bf16_losses']]}")
    return out


def _resume_timed_bf16(torch, device, rehearse, seed, masker, params,
                       jax_path, specs, cfg) -> dict:
    """A bf16 stage-2 state at the main path's configuration (dropout
    0.1) resumed from the JAX-layout file, then timed train steps on one
    synthetic batch kept on the device (2 warm-up, 4 timed, synchronised;
    host clock)."""
    import numpy as np

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.models import LxmertConfig
    from crvqa_tpu_torch.train import stage2

    config = (LxmertConfig.tiny if rehearse else LxmertConfig)(
        dtype=torch.bfloat16)
    model = stage2.lxmert_meta_model(config)
    state, tx = stage2.init_state(model, masker, params, cfg, seed, device)
    cli_common.resume_any(jax_path, state, "stage2", cfg, specs)
    step_fn = stage2.make_train_step(model, masker, tx, cfg)
    batch = to_device(synthetic_batch(
        batch_size=TRAIN_BATCH, seed=seed, vocab_size=config.vocab_size,
        ans_num=config.ans_num, feat_dim=config.visual_feat_dim,
        pos_dim=config.visual_pos_dim), device, float_dtype=torch.bfloat16)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    losses = []
    for _ in range(2):
        state, m = step_fn(state, batch)
        losses.append(float(m.loss))
    sync()
    t0 = time.monotonic()
    timed = [step_fn(state, batch)[1].loss for _ in range(4)]
    sync()
    step_ms = (time.monotonic() - t0) / 4 * 1e3
    losses += [float(x) for x in timed]
    check(state.step == 2 + 6 and all(np.isfinite(losses)),
          f"resume stage2 bf16: step {state.step}, losses {losses}")
    return {"bf16_losses": losses, "bf16_step_ms": step_ms}


def _resume_mplug(torch, device, rehearse, seed, root, total) -> dict:
    """Phase resume (b): an mPLUG mask-mode state as a JAX ckpt_final,
    served by serve_mplug --ckpt beside the port's own ckpt_final."""
    import numpy as np

    from crvqa_tpu_torch.cli import vqa_mplug
    from crvqa_tpu_torch.core import convert

    rng = np.random.default_rng(seed + 41)
    fab = fabricate_mplug(root, rehearse, rng, n_requests=16)
    bs = MPLUG_TRAIN_BATCH
    targv = ["--output_dir", os.path.join(root, "train"), "--device",
             str(device), "--dtype", "bfloat16", "--seed", str(seed),
             "--zero_rate", "0.5", "--init_sparsity", "0.3",
             "--final_sparsity_epoch", "1", "--synthetic", str(2 * bs),
             "--synthetic_shapes", MPLUG_TRAIN_SHAPES, "--train_batch_size",
             str(bs), "--eval_batch_size", str(bs), "--num_train_epochs",
             "1", "--masker_update_step", "2", "--logging_steps", "2",
             "--save_steps", "0", "--do_train"] + (
                 ["--tiny"] if rehearse else [])
    summary, launches = _run_counted(lambda: vqa_mplug.main(targv))
    _add_launches(total, launches)
    check(summary["step"] == 2 and all(np.isfinite(summary["losses"])),
          f"resume mplug: training ended at {summary['step']}, losses "
          f"{summary['losses']}")
    args = vqa_mplug.build_parser().parse_args(targv)
    config, _, model = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    cfg = vqa_mplug.train_config(args, 2)
    jax_final = os.path.join(root, "jax_ckpt_final")
    out = {"file": _write_jax(jax_final, convert.jax_from_mplug_state(
        summary["state"], model, cfg, masker.specs))}
    del summary
    _free(torch, rehearse)
    beam = ({} if rehearse else
            {"midseq_attention_fwd": 18, "fused_attention_fwd": 11})
    answers = {}
    for tag, path in (("port", os.path.join(root, "train", "ckpt_final")),
                      ("jax", jax_final)):
        sargs = _mplug_args(root, device, rehearse, seed, "bfloat16", 8,
                            f"resume_{tag}", ("--ckpt", path,
                                              "--zero_rate", "0.5"))
        t0 = time.monotonic()
        responses, served = _serve_mplug(torch, root, fab["images"], sargs,
                                         device, f"resume_{tag}", beam)
        served["wall_s"] = time.monotonic() - t0
        _add_launches(total, served["launches"])
        answers[tag] = [r["answer"] for r in responses]
        out[tag] = served
    same = sum(a == b for a, b in zip(answers["port"], answers["jax"]))
    log(f"resume mplug: JAX-layout ckpt_final {out['file']['bytes']} bytes "
        f"({out['file']['write_s']:.2f} s to write); served answers equal "
        f"to the port's own ckpt_final's: {same}/{len(answers['port'])}")
    check(same == len(answers["port"]) == 16,
          f"resume mplug: {same} of {len(answers['port'])} answers equal")
    out["same_answers"] = same
    return out


def _resume_other(torch, device, rehearse, seed, root, stage1_bin,
                  total) -> dict:
    """Phase resume (c): stage 3 and VisualBERT stage 2, 2 steps written in
    the JAX layout and 2 more resumed from it."""
    import numpy as np

    from crvqa_tpu_torch.cli import common as cli_common
    from crvqa_tpu_torch.cli import prune_debias_vqa_visualbert, run_vqa_stage3
    from crvqa_tpu_torch.core import convert
    from crvqa_tpu_torch.masking.spec import visualbert_mask_specs
    from crvqa_tpu_torch.models import LxmertConfig, VisualBertConfig
    from crvqa_tpu_torch.train import stage1, stage2

    on_card = not rehearse
    tiny = ["--tiny"] if rehearse else []
    lx = (LxmertConfig.tiny if rehearse else LxmertConfig)()
    vb = (VisualBertConfig.tiny if rehearse else VisualBertConfig)()
    fwd_mult, bwd_mult = launch_mult(lx)
    runs = {
        "stage3": (run_vqa_stage3.main, S1_BATCH,
                   sum(fwd_mult.values()), sum(bwd_mult.values()),
                   ["--stage1_ckpt", stage1_bin, "--training_type",
                    "FT_randMask", "--FT_type", "lmh"],
                   lambda st: convert.jax_from_stage1_state(
                       st, stage2.lxmert_meta_model(lx),
                       stage1.Stage1Config(),
                       cli_common.lxmert_uniform_masker(lx, 0.7).specs)),
        "visualbert": (prune_debias_vqa_visualbert.main, TRAIN_BATCH,
                       vb.num_hidden_layers, vb.num_hidden_layers,
                       ["--zero_rate", "0.7", "--controlled_init",
                        "magnitude", "--Masker_type", "lmh"],
                       lambda st: convert.jax_from_stage2_state(
                           st, stage2.visualbert_meta_model(vb),
                           visualbert_mask_specs(vb.num_hidden_layers),
                           stage2.Stage2Config(classifier_key="cls"))),
    }
    out = {}
    for tag, (main, bs, per_fwd, per_bwd, extra, to_jax) in runs.items():
        def argv(name, *more):
            return ["--output_dir", os.path.join(root, f"{tag}_{name}"),
                    "--device", str(device), "--dtype", "bfloat16",
                    "--synthetic", str(2 * bs), "--synthetic_pool", "2",
                    "--train_batch_size", str(bs), "--eval_batch_size",
                    str(bs), "--num_train_epochs", "1", "--logging_steps",
                    "2", "--save_steps", "0", "--seed", str(seed),
                    "--do_train", *extra, *more] + tiny

        first = main(argv("first"))
        path = os.path.join(root, f"{tag}_jax_ckpt_2")
        info = _write_jax(path, to_jax(first["state"]))
        del first
        _free(torch, rehearse)
        resumed, launches = _run_counted(lambda: main(argv(
            "resumed", "--resume_from", path)))
        _add_launches(total, launches)
        want = _launch_counts(on_card, fused_attention_fwd_train=per_fwd * 2,
                              fused_attention_bwd_stored=per_bwd * 2)
        check(launches == want,
              f"resume {tag}: launches {launches} != {want}")
        check(resumed["step"] == 4 and len(resumed["losses"]) == 2
              and all(np.isfinite(resumed["losses"])),
              f"resume {tag}: ended at step {resumed['step']}, losses "
              f"{resumed['losses']}")
        log(f"resume {tag}: JAX-layout ckpt_2 {info['bytes']} bytes; 2 "
            f"steps from it: losses "
            f"{[round(x, 4) for x in resumed['losses']]}; launches "
            f"{launches}")
        out[tag] = dict(info, losses=resumed["losses"], launches=launches)
        del resumed
        _free(torch, rehearse)
    return out


def phase_resume(torch, device, rehearse: bool, seed: int, stage1_bin: str
                 ) -> dict:
    """The JAX package's training states on the card (module docstring,
    phase 23). `launches` sums every counted run of the phase."""
    total: dict = {}
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as root:
        for key, fn, args in (
                ("stage2", _resume_stage2, ()),
                ("mplug", _resume_mplug, ()),
                ("other", _resume_other, (stage1_bin,))):
            sub = os.path.join(root, key)
            os.makedirs(sub)
            out[key] = fn(torch, device, rehearse, seed, sub, *args, total)
            shutil.rmtree(sub)  # the full-width files are several GB
    out["launches"] = total
    return out


# ---------------------------------------------------------------- phase 23a

# phase parallel: stage 2 at batch 256 (8 steps, resets at 4 and 8, one
# checkpoint) and mPLUG mask mode at batch 16 (4 steps, resets at 2 and 4)
PAR_STAGE2_STEPS, PAR_STAGE2_RESET = 8, 4
PAR_MPLUG_STEPS, PAR_MPLUG_RESET = 4, 2
PAR_FILES = {"stage2": ("mask.pt", "classifier4masker.bin",
                        f"ckpt_{PAR_STAGE2_STEPS}"),
             "mplug": ("mask.pt", "mask_config.json", "ckpt_final")}
PAR_COLLECTIVE_REPS = 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parallel_argv(kind: str, out: str, seed: int, rehearse: bool,
                   port: int) -> list[str]:
    """The phase's CLI argv; with `port` the runtime's flags too: one
    process over NCCL (gloo in a rehearsal) at --mesh_data 1, ZeRO on
    (stage 2 asks for it, mPLUG always shards)."""
    device = "cpu" if rehearse else "cuda"
    if kind == "stage2":
        bs = 8 if rehearse else TRAIN_BATCH
        argv = ["--output_dir", out, "--device", device, "--dtype",
                "bfloat16", "--synthetic", str(bs * PAR_STAGE2_STEPS),
                "--synthetic_pool", "2", "--train_batch_size", str(bs),
                "--num_train_epochs", "1",
                "--logging_steps", str(PAR_STAGE2_RESET),
                "--save_steps", str(PAR_STAGE2_STEPS),
                "--Lang_comp", "0.3", "--Vis_comp", "0.3", "--Fus_comp",
                "0.3", "--zero_rate", "0.7", "--controlled_init",
                "magnitude", "--Masker_type", "lmh", "--do_train",
                "--seed", str(seed)]
    else:
        bs = 4 if rehearse else MPLUG_TRAIN_BATCH
        argv = ["--output_dir", out, "--device", device, "--dtype",
                "bfloat16", "--mode", "mask", "--synthetic",
                str(bs * PAR_MPLUG_STEPS), "--synthetic_shapes",
                MPLUG_TRAIN_SHAPES, "--train_batch_size", str(bs),
                "--num_train_epochs", "1",
                "--masker_update_step", str(PAR_MPLUG_RESET),
                "--logging_steps", str(PAR_MPLUG_RESET),
                "--save_steps", "100000", "--do_train", "--seed", str(seed)]
    if rehearse:
        argv.append("--tiny")
    if port:
        argv += ["--multihost", "true", "--coordinator_address",
                 f"127.0.0.1:{port}", "--num_processes", "1",
                 "--process_id", "0", "--mesh_data", "1"]
        if kind == "stage2":
            argv += ["--zero_opt", "true"]
    return argv


def parallel_child(seed: int, kind: str, out: str, port: str,
                   rehearse: str) -> dict:
    """One run of phase parallel in this (fresh) process: the CLI with the
    launch counters from 0, its wall time, logged ex/s, peak device
    memory, the process group's backend and world; with the runtime, the
    step's collectives timed alone on the run's trainable leaves (the
    gradient all-reduce and ZeRO's broadcast, CUDA events, mean of
    `PAR_COLLECTIVE_REPS`)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from crvqa_tpu_torch.cli import common, prune_debias_vqa, vqa_mplug
    from crvqa_tpu_torch.parallel.zero import ZeroPartition
    from crvqa_tpu_torch.train import mplug_train, stage2
    from crvqa_tpu_torch.train.common import allreduce_grads_

    rehearse = rehearse == "1"
    on_card = not rehearse
    # two of these processes run side by side: half the host's cores each
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    if on_card:  # as phase device sets it in the parent
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    port_n = int(port)
    cli = prune_debias_vqa if kind == "stage2" else vqa_mplug
    t0 = time.monotonic()
    summary, launches = _run_counted(lambda: cli.main(_parallel_argv(
        kind, out, seed, rehearse, port_n)))
    wall_s = time.monotonic() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        ex_s = [json.loads(x)["ex_s"] for x in f if '"ex_s"' in x]
    result = {"wall_s": wall_s, "launches": launches,
              "losses": [float(x) for x in summary["losses"]],
              "step": summary["step"], "ex_s": ex_s,
              "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None),
              "backend": dist.get_backend() if dist.is_initialized()
              else None,
              "world": dist.get_world_size() if dist.is_initialized()
              else None}
    if port_n:
        state = summary["state"]
        leaves = (stage2.trainable(state, stage2.Stage2Config())
                  if kind == "stage2" else mplug_train.trainable(
                      state, mplug_train.MPlugTrainConfig(mode="mask")))
        mesh = common.make_run_mesh(argparse.Namespace(
            mesh_data=1, mesh_model=1), state.rng.device.device)
        grads = {k: v.detach().clone() for k, v in leaves.items()}
        zero = ZeroPartition(grads, mesh)

        def timed(fn) -> float:
            fn()
            if not on_card:
                return 0.0
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(PAR_COLLECTIVE_REPS):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / PAR_COLLECTIVE_REPS

        result["allreduce_ms"] = timed(lambda: allreduce_grads_(grads, mesh))
        result["zero_broadcast_ms"] = timed(
            lambda: zero.broadcast_params_(grads))
        result["trainable_elems"] = sum(v.numel() for v in grads.values())
    return result


def _raw_diff(torch, a, b, path="") -> list[str]:
    """Paths where two torch.load trees differ in structure, type, dtype,
    shape or any bit (-0.0 and 0.0 differ; NaN payloads too)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)
                and list(a) == list(b)):
            return [path or "/"]
        return [d for k in a for d in _raw_diff(torch, a[k], b[k],
                                                f"{path}/{k}")]
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _raw_diff(torch, x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
        return [] if same else [path]
    return [] if (type(a) is type(b) and a == b) else [path]


def _files_bit_equal(torch, a_dir: str, b_dir: str, names) -> dict:
    """Per file: whether its bytes are identical and whether what it holds
    (torch.load trees, or JSON) is equal bit for bit; the differing paths
    when it is not. Identical bytes hold identical contents: the files are
    loaded only when their bytes differ (torch.save's archive could differ
    in bytes alone)."""
    out = {}
    for name in names:
        pa, pb = os.path.join(a_dir, name), os.path.join(b_dir, name)
        same_bytes = os.path.getsize(pa) == os.path.getsize(pb)
        with open(pa, "rb") as f, open(pb, "rb") as g:
            while same_bytes:
                chunk = f.read(1 << 26)
                same_bytes = chunk == g.read(1 << 26)
                if not chunk:
                    break
        if same_bytes:
            diff = []
        elif name.endswith(".json"):
            with open(pa) as f, open(pb) as g:
                diff = [] if json.load(f) == json.load(g) else ["/"]
        else:
            diff = _raw_diff(torch, torch.load(pa, weights_only=True),
                             torch.load(pb, weights_only=True))
        out[name] = {"bytes_equal": same_bytes, "bit_equal": not diff,
                     "differs_at": diff[:5],
                     "bytes": os.path.getsize(pa)}
    return out


def phase_parallel(torch, device, rehearse: bool, seed: int) -> dict:
    """The multi-device runtime on the one card (module docstring, phase
    23a): each CLI twice in fresh processes, plain and with --multihost
    over NCCL at world 1 (gloo in a rehearsal), the two side by side on
    the card (their set-up is host work); their artifacts bit-equal, the
    same launches, both step times (each pair sharing the card), the
    collectives' time alone and the peak memory."""
    on_card = not rehearse
    out = {"launches": {}}
    for kind in ("stage2", "mplug"):
        steps = PAR_STAGE2_STEPS if kind == "stage2" else PAR_MPLUG_STEPS
        batch = ((8 if rehearse else TRAIN_BATCH) if kind == "stage2"
                 else (4 if rehearse else MPLUG_TRAIN_BATCH))
        with tempfile.TemporaryDirectory(
                prefix=f"chip_smoke_parallel_{kind}_") as root:
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                futures = {tag: pool.submit(
                    _fresh_process, "parallel_child", seed,
                    f"parallel {kind} {tag}", kind, os.path.join(root, tag),
                    str(port), "1" if rehearse else "0")
                    for tag, port in (("plain", 0),
                                      ("runtime", _free_port()))}
                runs = {tag: f.result() for tag, f in futures.items()}
            plain, rt = runs["plain"], runs["runtime"]
            files = _files_bit_equal(torch, os.path.join(root, "plain"),
                                     os.path.join(root, "runtime"),
                                     PAR_FILES[kind])
        want_backend = "gloo" if rehearse else "nccl"
        check(rt["backend"] == want_backend and rt["world"] == 1
              and plain["backend"] is None,
              f"parallel {kind}: process groups plain {plain['backend']}, "
              f"runtime {rt['backend']} world {rt['world']} (want "
              f"{want_backend} at world 1)")
        check(plain["step"] == rt["step"] == steps
              and plain["losses"] == rt["losses"]
              and all(x == x for x in rt["losses"]),
              f"parallel {kind}: losses plain {plain['losses']} runtime "
              f"{rt['losses']} ({steps} steps, bit-equal)")
        check(all(f["bit_equal"] for f in files.values()),
              f"parallel {kind}: artifacts differ: {files}")
        check(plain["launches"] == rt["launches"],
              f"parallel {kind}: launches plain {plain['launches']} "
              f"runtime {rt['launches']}")
        path = (("fused_attention_fwd_train", "fused_attention_bwd_stored")
                if kind == "stage2" else
                ("midseq_attention_fwd", "midseq_attention_bwd",
                 "fused_attention_fwd_train", "fused_attention_bwd_stored"))
        check(all((rt["launches"][n] > 0) == on_card for n in path),
              f"parallel {kind}: the runtime run launched {rt['launches']}")
        _add_launches(out["launches"], rt["launches"])
        step_ms = {tag: (1e3 * batch / r["ex_s"][-1] if r["ex_s"]
                         and r["ex_s"][-1] > 0 else None)
                   for tag, r in runs.items()}
        out[kind] = {"steps": steps, "batch": batch, "files": files,
                     "step_ms": step_ms,
                     "step_overhead_ms": (
                         step_ms["runtime"] - step_ms["plain"]
                         if None not in step_ms.values() else None),
                     "plain": plain, "runtime": rt}
        log(f"parallel {kind}: " + json.dumps(out[kind]))
    return out


def kernel_summary(rows, midseq_rows, train_rows, serve, mplug, train,
                   midseq_bwd_rows, mplug_train, masked, compact, vb_serve,
                   vb_train, vqavs, stage3, structured, resume,
                   parallel) -> list[dict]:
    """One entry per kernel at its main path's shapes. The primal: one bf16
    forward at batch 32, summed over its 34 launches ((14,14) x l+x,
    (36,36) x r+x, (14,36) and (36,14) x x). The mid-length forward: one
    bf16 mPLUG encode at batch 8, summed over its 18 launches
    (`MIDSEQ_PER_ENCODE`). The training kernels: one bf16 train step at
    batch 256, dropout rate 0.1, summed over the step's 34 forward-for-grad
    and 32 backward launches (`launch_mult`). The mid-length backward: one
    bf16 mPLUG mask-training step at batch 16, dropout rate 0.1, summed
    over its 29 launches (`MIDSEQ_BWD_PER_STEP`). The short kernels'
    `launches` add VisualBERT's paths (phases visualbert-serve and
    visualbert-train) to LXMERT's, and those of phase vqavs and of phase
    stage3's serving of its .msgpack, phase structured's runs, phase
    resume's and phase parallel's runtime runs (every kernel those phases
    run counts its launches there; "resumes" in `basis` counts both); their
    `visualbert` entry gives one VisualBERT forward (batch 32) or step
    (batch 256) at (50,50), their `trained_heads` entry one stage-3 step
    (forward) at the kept head count of phase structured's head mask."""
    from crvqa_tpu_torch.models import LxmertConfig

    fwd_mult, bwd_mult = launch_mult(LxmertConfig())
    vb_layers = vb_serve["per_forward"]
    msgpack_launches = sum(
        stage3["trained"]["msgpack_serve"]["launches"].values())
    struct_runs = [structured[k]["launches"]
                   for k in ("heads", "layers", "stage3")]
    struct_launches = lambda name: sum(r[name] for r in struct_runs)
    # phase resume's runs and phase parallel's runtime runs
    resume_launches = lambda name: (resume["launches"].get(name, 0)
                                    + parallel["launches"].get(name, 0))
    main = [r for r in rows if r["batch"] == SERVE_BATCH
            and r["dtype"] == "bfloat16" and r["heads"] == 12
            and (r["sq"], r["sk"]) in fwd_mult]
    total = lambda key: sum(r[key] * fwd_mult[(r["sq"], r["sk"])]
                            for r in main)
    bound_ms, bound_by = _bound(total("bytes_ms"), total("ops_ms"))
    src = "crvqa_tpu_torch/csrc/"
    out = [{
        "name": "fused_attention_fwd", "route": "cuda",
        "source": src + "fused_attention_fwd.cu",
        "replaces": "crvqa_tpu/ops/fused_attention.py:153",
        "launches": (serve["launches"] + vb_serve["launches"]
                     + vqavs["launches"]["fused_attention_fwd"]
                     + msgpack_launches
                     + struct_launches("fused_attention_fwd")
                     + resume_launches("fused_attention_fwd")),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total("library_ms"),
        "basis": f"one bf16 LXMERT forward at batch {SERVE_BATCH}: "
                 f"{sum(fwd_mult.values())} launches over (Sq,Sk) "
                 + ", ".join(f"{k}x{v}" for k, v in fwd_mult.items())
                 + f"; launches: LXMERT serving {serve['launches']}, "
                   f"VisualBERT serving {vb_serve['launches']}, VQA-VS "
                   f"stage-2 evals {vqavs['launches']['fused_attention_fwd']}"
                   f", serving stage 3's .msgpack {msgpack_launches}, "
                   f"structured stage 2 and 3 "
                   f"{struct_launches('fused_attention_fwd')}, resumes, "
                   f"their serving and the runtime runs "
                   f"{resume_launches('fused_attention_fwd')}",
        "trained_heads": _trained_heads_entry(
            structured, "primal", ("primal_err",), "library_primal_ms",
            fwd_mult, structured["stage3"]["launches"][
                "fused_attention_fwd"]),
        "visualbert": _visualbert_entry(
            [r for r in rows if r["batch"] == SERVE_BATCH
             and r["dtype"] == "bfloat16" and r["heads"] == 12
             and (r["sq"], r["sk"]) == VISUALBERT_SHAPE],
            "", ("max_abs_err",), "library_ms", vb_layers,
            vb_serve["launches"],
            f"one bf16 VisualBERT forward at batch {SERVE_BATCH}"),
    }]
    batch = MPLUG_BATCHES[0]
    main = [r for r in midseq_rows if r["batch"] == batch
            and r["dtype"] == "bfloat16" and r["rate"] == 0.0
            and (r["sq"], r["sk"]) in MIDSEQ_PER_ENCODE]
    total = lambda key: sum(r[key] * MIDSEQ_PER_ENCODE[(r["sq"], r["sk"])]
                            for r in main)
    bound_ms, bound_by = _bound(total("bytes_ms"), total("ops_ms"))
    out.append({
        "name": "midseq_attention_fwd", "route": "cuda",
        "source": src + "midseq_attention_fwd.cu",
        "replaces": "crvqa_tpu/ops/midseq_attention.py:103",
        "launches": (mplug["main_launches"]["midseq_attention_fwd"]
                     + resume_launches("midseq_attention_fwd")),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total("library_ms"),
        "basis": f"one bf16 mPLUG encode at batch {batch}: "
                 f"{sum(MIDSEQ_PER_ENCODE.values())} launches over (Sq,Sk) "
                 + ", ".join(f"{k}x{v}" for k, v in MIDSEQ_PER_ENCODE.items())
                 + "; library_ms: scaled_dot_product_attention with the "
                   "bias as a float mask",
    })
    main = [r for r in train_rows if r["batch"] == TRAIN_BATCH
            and r["dtype"] == "bfloat16" and r["rate"] == MAIN_RATE
            and r["heads"] == 12 and (r["sq"], r["sk"]) in fwd_mult]
    vb_rows = [r for r in train_rows if r["batch"] == TRAIN_BATCH
               and r["dtype"] == "bfloat16" and r["rate"] == MAIN_RATE
               and (r["sq"], r["sk"]) == VISUALBERT_SHAPE]
    for name, kind, replaces, mult, launches, err_keys, library in (
            ("fused_attention_fwd_train", "fwd",
             "crvqa_tpu/ops/fused_attention.py:153", fwd_mult,
             train["launches"]["fused_attention_fwd_train"],
             ("fwd_err", "p_err"), "library_fwd_ms"),
            ("fused_attention_bwd_stored", "stored",
             "crvqa_tpu/ops/fused_attention.py:510", bwd_mult,
             train["launches"]["fused_attention_bwd_stored"],
             ("bwd_stored_err",), "library_fwd_bwd_ms"),
            ("fused_attention_bwd_recompute", "recompute",
             "crvqa_tpu/ops/fused_attention.py:581", bwd_mult,
             train["recompute"]["launches"]["fused_attention_bwd_recompute"],
             ("bwd_recompute_err",), "library_fwd_bwd_ms")):
        tot = lambda key: sum(r[key] * mult[(r["sq"], r["sk"])] for r in main)
        bound_ms, bound_by = _bound(tot(f"{kind}_bytes_ms"),
                                    tot(f"{kind}_ops_ms"))
        what = ("scaled_dot_product_attention forward under autograd"
                if kind == "fwd" else "scaled_dot_product_attention forward "
                "+ backward under autograd (no backward-only call exists)")
        out.append({
            "name": name, "route": "cuda",
            "source": src + ("fused_attention_fwd.cu" if kind == "fwd"
                             else "fused_attention_bwd.cu"),
            "replaces": replaces,
            "launches": (launches + vb_train["launches"][name]
                         + vqavs["launches"][name]
                         + struct_launches(name)
                         + resume_launches(name)),
            "max_abs_err": max(r[k] for r in main for k in err_keys),
            "ms": tot(f"{kind}_ms"), "plain_ms": tot(f"{kind}_plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": tot(library),
            "basis": f"one bf16 train step at batch {TRAIN_BATCH}, dropout "
                     f"{MAIN_RATE}: {sum(mult.values())} launches over "
                     f"(Sq,Sk) " + ", ".join(f"{k}x{v}"
                                             for k, v in mult.items())
                     + f"; library_ms: {what}; launches: LXMERT stage 2 "
                       f"{launches}, VisualBERT stage 2 "
                       f"{vb_train['launches'][name]}, VQA-VS stage 2 "
                       f"{vqavs['launches'][name]}, structured stage 2 "
                       f"and 3 {struct_launches(name)}, resumes and "
                       f"the runtime runs {resume_launches(name)}",
            "visualbert": _visualbert_entry(
                vb_rows, f"{kind}_", err_keys, library, vb_layers,
                vb_train["launches"][name],
                f"one bf16 VisualBERT train step at batch {TRAIN_BATCH}, "
                f"dropout {MAIN_RATE}"),
        })
        if kind != "recompute":  # stage 3 runs the stored backward
            out[-1]["trained_heads"] = _trained_heads_entry(
                structured, kind, ("fwd_err", "p_err") if kind == "fwd"
                else ("dq_err", "dk_err", "dv_err"), library, mult,
                structured["stage3"]["launches"][name])
    main = [r for r in midseq_bwd_rows if r["batch"] == MPLUG_TRAIN_BATCH
            and r["dtype"] == "bfloat16" and r["rate"] == MAIN_RATE]
    mult = MIDSEQ_BWD_PER_STEP
    tot = lambda key: sum(r[key] * mult[(r["sq"], r["sk"])] for r in main)
    fwd_step = lambda key: sum(r[key] * MIDSEQ_FWD_PER_STEP[(r["sq"],
                                                             r["sk"])]
                               for r in main)
    bound_ms, bound_by = _bound(tot("bytes_ms"), tot("ops_ms"))
    out.append({
        "name": "midseq_attention_bwd", "route": "cuda",
        "source": src + "midseq_attention_bwd.cu",
        "replaces": "crvqa_tpu/ops/midseq_attention.py:133",
        "launches": (mplug_train["main"]["launches"]["midseq_attention_bwd"]
                     + resume_launches("midseq_attention_bwd")),
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": tot("library_ms"),
        "basis": f"one bf16 mPLUG mask-training step at batch "
                 f"{MPLUG_TRAIN_BATCH}, dropout {MAIN_RATE}: "
                 f"{sum(mult.values())} launches over (Sq,Sk) "
                 + ", ".join(f"{k}x{v}" for k, v in mult.items())
                 + "; library_ms: scaled_dot_product_attention forward + "
                   "backward under autograd (no backward-only call exists); "
                   "the forward kernel over the step's "
                   f"{sum(MIDSEQ_FWD_PER_STEP.values())} launches takes "
                   f"{fwd_step('fwd_ms'):.4f} ms, scaled_dot_product_"
                   f"attention's forward {fwd_step('fwd_library_ms'):.4f} "
                   f"ms, their bound {fwd_step('fwd_bound_ms'):.4f} ms",
    })
    return out + matmul_kernel_summary(masked, compact, MM_SHAPES[0])


def matmul_kernel_summary(masked, compact, shape) -> list[dict]:
    """The kernels line's entries of the masked-matmul kernels at x
    `shape[:2]`, w `shape[1:]` (bf16, scores fp32; ds with the bf16
    cotangent the VJP hands it) and of the head-compact kernel at 4 of 12
    heads kept (bf16)."""
    src = "crvqa_tpu_torch/csrc/"
    out = []
    m, k, n = shape
    row = next(r for r in masked["rows"] if (r["m"], r["k"], r["n"])
               == (m, k, n) and r["x_dtype"] == r["w_dtype"] == "bfloat16")
    common = ("no entry point reaches the kernel: launches are phase "
              "masked-matmul-kernel's autograd runs")
    for kind, key, line, err, lib in (
            ("fwd", "fwd", 50, "y_err", "cuBLAS on the materialised masked "
             "weight"),
            ("dx", "dx", 67, "dx_err", "cuBLAS on the materialised masked "
             "weight"),
            ("ds", "ds_bf16g", 86, "ds_err", "(xᵀ g) * w with the same "
             "bf16 g")):
        name = f"masked_matmul_{kind}"
        out.append({
            "name": name, "route": "cuda", "source": src + "masked_matmul.cu",
            "replaces": f"crvqa_tpu/ops/masked_matmul.py:{line}",
            "launches": masked["launches"][name], "max_abs_err": row[err],
            "ms": row[f"{key}_ms"], "plain_ms": row[f"{key}_plain_ms"],
            "bound_ms": row[f"{key}_bound_ms"],
            "bound_by": row[f"{key}_bound_by"],
            "library_ms": row[f"{kind}_library_ms"],
            "basis": f"one call at x [{m}, {k}] bf16, w [{k}, {n}] bf16, "
                     f"scores fp32 (operand pass and the TMA + wgmma "
                     f"product of csrc/wgmma_gemm_common.cuh); {common}; "
                     f"library_ms: {lib}; ds with g cast to fp32 in the "
                     f"call {row['ds_ms']:.4f} ms; forward + backward "
                     f"under autograd {row['fwd_bwd_ms']:.4f} ms (cuBLAS "
                     f"{row['fwd_bwd_library_ms']:.4f})",
        })
    out.append({
        "name": "masked_matmul_operand_pass", "route": "cuda",
        "source": src + "masked_matmul.cu",
        "replaces": "crvqa_tpu/ops/masked_matmul.py:57",
        "launches": masked["launches"]["masked_matmul_operand_pass"],
        "max_abs_err": row["pass_err"], "ms": row["pass_ms"],
        "plain_ms": row["pass_plain_ms"], "bound_ms": row["pass_bound_ms"],
        "bound_by": row["pass_bound_by"], "library_ms": None,
        "basis": f"mask mode at w [{k}, {n}] bf16, scores fp32 (the "
                 f"binarize of `_fwd_kernel` :57-58 and `_dx_kernel` "
                 f":74-75, once a call); copy mode rounds fp32 or "
                 f"misaligned x and g; {common}",
    })
    row = next(r for r in compact["rows"] if r["case"] == f"kept{HC_KEPT}"
               and r["dtype"] == "bfloat16")
    others = ", ".join(
        f"{r['case']} {r['dtype']} {r['ms']:.4f} ms (gather + cuBLAS + "
        f"scatter {r['compact_torch_ms']:.4f}, cuBLAS on w * mask "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f})"
        for r in compact["rows"] if "ms" in r and r is not row)
    common = ("no entry point reaches the kernel: launches are phase "
              "head-compact-kernel's checking run")
    out.append({
        "name": "head_compact_matmul", "route": "cuda",
        "source": src + "head_compact_matmul.cu",
        "replaces": "crvqa_tpu/ops/structured_matmul.py:119",
        "launches": compact["launches"]["head_compact_matmul"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "basis": f"one call at x [{row['m']}, {row['k']}] bf16, "
                 f"{row['heads']} heads of 64 with {row['kept']} kept (TMA "
                 f"+ wgmma product of csrc/wgmma_gemm_common.cuh in head "
                 f"mode, zero blocks for dropped heads); {common}; "
                 "library_ms: cuBLAS on w * mask (dense_masked_matmul); "
                 "the port's gather + cuBLAS + scatter "
                 f"{row['compact_torch_ms']:.4f} ms; other rows: {others}",
    })
    p = compact["pass"]
    out.append({
        "name": "head_compact_operand_pass", "route": "cuda",
        "source": src + "head_compact_matmul.cu",
        "replaces": "crvqa_tpu/ops/structured_matmul.py:129",
        "launches": compact["launches"]["head_compact_operand_pass"],
        "max_abs_err": p["max_abs_err"], "ms": p["ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bytes_ms"],
        "bound_by": "bytes", "library_ms": p["plain_ms"],
        "basis": f"bf16(x) of an fp32 x [{p['m']}, {p['k']}] (the TPU "
                 f"kernel's .astype(bfloat16) of each operand, for an "
                 f"operand TMA cannot read in place); {common} (x and wt "
                 f"of each fp32 call); plain_ms and library_ms: the one "
                 f"PyTorch call x.to(torch.bfloat16), timed once",
    })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, tiny widths, plain versions; prints no result")
    p.add_argument("--json", type=str, default=None,
                   help="also write every measured number to this file")
    args = p.parse_args(argv)

    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: cannot import torch: {e}", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "needs one CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "crvqa_tpu_torch")):
        print(f"chip_smoke: no crvqa_tpu_torch package beside {__file__}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cpu" if args.rehearse else "cuda")

    t0 = time.monotonic()
    phase_s: dict = {}

    def phase(name, fn, *a):
        t = time.monotonic()
        result = fn(*a)
        phase_s[name] = time.monotonic() - t
        log(f"chip_smoke: phase {name} in {phase_s[name]:.1f} s")
        return result

    rehearse, seed = args.rehearse, args.seed
    # artifacts one phase hands to a later one (stage-2 exports, stage-1 .bin)
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_keep_")
    try:
        dev = phase("device", phase_device, torch, rehearse)
        build = None if rehearse else phase("build", phase_build)
        rows = phase("kernel", phase_kernel, torch, device, rehearse, seed)
        midseq_rows = phase("midseq-kernel", phase_midseq_kernel, torch,
                            device, rehearse, seed)
        train_rows = phase("train-kernels", phase_train_kernels, torch,
                           device, rehearse, seed)
        offset_rows = phase("offset-kernels", phase_offset_kernels, torch,
                            device, rehearse, seed)
        serve = phase("serve", phase_serve, torch, device, rehearse, seed,
                      keep.name)
        if not rehearse:
            phase("profile", phase_profile, torch, device, seed)
        mplug = phase("mplug-serve", phase_mplug_serve, torch, device,
                      rehearse, seed)
        train = phase("train", phase_train, torch, device, rehearse, seed,
                      keep.name)
        step = phase("step", phase_step, torch, device, rehearse, seed)
        midseq_bwd_rows = phase("midseq-bwd-kernel", phase_midseq_bwd_kernel,
                                torch, device, rehearse, seed)
        mplug_train = phase("mplug-train", phase_mplug_train, torch, device,
                            rehearse, seed)
        mplug_step = phase("mplug-step", phase_mplug_step, torch, device,
                           rehearse, seed)
        masked = phase("masked-matmul-kernel", phase_masked_matmul_kernel,
                       torch, device, rehearse, seed)
        compact = phase("head-compact-kernel", phase_head_compact_kernel,
                        torch, device, rehearse, seed)
        stage1 = phase("stage1", phase_stage1, torch, device, rehearse, seed,
                       keep.name)
        stage3 = phase("stage3", phase_stage3, torch, device, rehearse, seed,
                       stage1["bin"], train["artifacts"], keep.name,
                       serve["root"])
        vb_train = phase("visualbert-train", phase_visualbert_train, torch,
                         device, rehearse, seed, serve["root"], keep.name)
        vb_serve = phase("visualbert-serve", phase_visualbert_serve, torch,
                         device, rehearse, seed, serve["root"],
                         vb_train["artifacts"])
        vqavs = phase("vqavs", phase_vqavs, torch, device, rehearse, seed,
                      serve["root"], keep.name)
        structured = phase("structured", phase_structured, torch, device,
                           rehearse, seed, serve["root"], stage1["bin"],
                           keep.name)
        mplug_files = phase("mplug-files", phase_mplug_files, torch, device,
                            rehearse, seed)
        resume = phase("resume", phase_resume, torch, device, rehearse, seed,
                       stage1["bin"])
        parallel = phase("parallel", phase_parallel, torch, device, rehearse,
                         seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        keep.cleanup()
    log(f"chip_smoke: all phases in {time.monotonic() - t0:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in phase_s.items()})})")
    if rehearse:
        log("chip_smoke: rehearsal finished (CPU, tiny widths): no result")
        return 3
    kernels = kernel_summary(rows, midseq_rows, train_rows, serve, mplug,
                             train, midseq_bwd_rows, mplug_train, masked,
                             compact, vb_serve, vb_train, vqavs, stage3,
                             structured, resume, parallel)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": dev, "phase_s": phase_s, "build": build,
                       "kernel_rows": rows,
                       "midseq_kernel_rows": midseq_rows,
                       "train_kernel_rows": train_rows, "serve": serve,
                       "mplug": mplug, "train": train, "step": step,
                       "midseq_bwd_kernel_rows": midseq_bwd_rows,
                       "mplug_train": mplug_train, "mplug_step": mplug_step,
                       "masked_matmul": masked, "head_compact": compact,
                       "stage1": stage1, "stage3": stage3,
                       "visualbert_train": vb_train,
                       "visualbert_serve": vb_serve, "vqavs": vqavs,
                       "structured": structured,
                       "mplug_files": mplug_files, "resume": resume,
                       "offset_kernel_rows": offset_rows,
                       "parallel": parallel,
                       "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
