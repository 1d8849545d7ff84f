#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`crvqa_tpu_torch`) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py              # one CUDA card; exits non-zero on any failure
    python3 chip_smoke.py --json out.json  # ... and every number into out.json
    python3 chip_smoke.py --rehearse   # CPU, tiny widths, plain versions: a
                                       # dry run of the control flow, never a result

Phases:
  1. device   the card's name, count and power limit; TF32 off for matmuls
              and cuDNN (fp32 comparisons are full fp32).
  2. build    every CUDA source under crvqa_tpu_torch/csrc and the native
              feature store, compiled from the checkout, all at once.
  3. kernel   the primal attention kernel against its plain PyTorch version
              at the serving shapes (batch 32 and 256; every (Sq, Sk)
              LXMERT gives it; fp32 and bf16), then timed: the kernel, the
              plain version and one PyTorch library call computing the same
              function (a yardstick the port never calls).
  4. train-kernels  the forward-for-grad and both backward kernels (stored,
              recompute) against their plain versions at batch 256, the four
              (Sq, Sk), fp32 and bf16, dropout rates 0 and 0.1; timed beside
              the plain versions and `scaled_dot_product_attention` forward
              and forward + backward under autograd.
  5. serve    `crvqa_tpu_torch.cli.serve_vqa.main` at full LXMERT width
              (768 hidden, 12x64 heads, 9/5/5 layers, 2274 answers) on
              seeded weights and fabricated data: 512 requests at batch 32 in
              bf16 (the default) and fp32, through a stage-2 mask.pt and
              classifier4masker.bin. Counts every kernel launch of the
              served run, checks no response carries an error, and holds
              the fp32 answers and logits against the same model with the
              plain attention swapped in.
  6. profile  device time by kernel of one bf16 forward at batch 32.
  7. train    `crvqa_tpu_torch.cli.prune_debias_vqa.main` at full width,
              batch 256, bf16, the canonical configuration (compression
              0.3/0.3/0.3 at zero rate 0.7, magnitude init, LMH loss,
              MaskedLinear1) on fabricated VQA-CP train/test files: 24 steps
              with threshold resets, an eval, an export and a checkpoint.
              Checks finite losses, the launch counts per step and per eval
              batch, the zero rates, and serves the exported mask.pt and
              classifier4masker.bin with serve_vqa. Then 8 steps with the
              recompute backward (`BWD_IMPL = "recompute"`).
  8. step     examples per second over timed train steps (synchronised,
              after warm-up), device time by kernel of one step (profile),
              and one full-width fp32 step with dropout on through the
              kernels against the same step through the plain versions from
              the same generators.
  9. summary  a {"kernels": [...]} line, the nvidia-smi line, and last the
              {"ok": true, "device": {...}} line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
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
    """Compile every CUDA source and the feature store from the checkout,
    one compiler process each, all started together."""
    from crvqa_tpu_torch.native import feature_store
    from crvqa_tpu_torch.ops import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        jobs = {name: pool.submit(_build.load_cuda_library, name)
                for name in sources}
        jobs["feature_store"] = pool.submit(feature_store._load_lib)
        for name, job in jobs.items():
            job.result()
    seconds = time.monotonic() - t0
    log(f"build: {len(jobs)} libraries in {seconds:.1f} s "
        f"({', '.join(jobs)})")
    for name in sources:
        with open(os.path.join(_build.BUILD_DIR, f"lib{name}.so.log")) as f:
            for line in f.read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log(f"build: {name}: {line.strip()}")
    return {"seconds": seconds, "sources": sources}


# ----------------------------------------------------------------- phase 3

def _attention_inputs(torch, b, sq, sk, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    d = 12 * 64
    q = torch.randn(b, sq, d, generator=g)
    k = torch.randn(b, sk, d, generator=g)
    v = torch.randn(b, sk, d, generator=g)
    bias = torch.zeros(b, sk)
    for i in range(1, b, 3):  # -10000 pads on a third of the rows
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


def _bound_terms(b, sq, sk, dtype):
    """(ms to move the bytes, ms to do the FLOPs) of one call on an H100:
    q, k, v and the fp32 bias read once and the output written once, over
    HBM; the two products' FLOPs over the peak rate of the inputs' type."""
    item = 2 if dtype == "bfloat16" else 4
    d = 12 * 64
    nbytes = item * b * d * (2 * sq + 2 * sk) + 4 * b * sk
    flops = 4 * b * 12 * sq * sk * 64
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]


def _bound(t_bytes, t_ops):
    """The least time is the larger term; it names what bounds the work."""
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(torch, device, rehearse: bool, seed: int) -> list[dict]:
    import torch.nn.functional as F

    from crvqa_tpu_torch.ops import fused_attention as fa

    rows = []
    batches = (2,) if rehearse else (SERVE_BATCH, 256)
    for b in batches:
        for dtype in ("float32", "bfloat16"):
            for sq, sk in SERVE_SHAPES:
                q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                                  device, seed + sq + sk)
                out = fa.fused_attention(q, k, v, bias, 12, 64)
                ref = fa.fused_attention_reference(q, k, v, bias, 12, 64)
                if not rehearse:
                    torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[dtype]
                ok = bool(torch.allclose(out.float(), ref.float(), **tol))
                row = {"batch": b, "dtype": dtype, "sq": sq, "sk": sk,
                       "max_abs_err": err, "ok": ok}
                row["bytes_ms"], row["ops_ms"] = _bound_terms(b, sq, sk,
                                                              dtype)
                row["bound_ms"], row["bound_by"] = _bound(row["bytes_ms"],
                                                          row["ops_ms"])
                if not rehearse:
                    h = 12
                    mask = bias.to(q.dtype)[:, None, None, :]
                    split = lambda t: t.view(b, t.shape[1], h, 64).transpose(1, 2)
                    qh, kh, vh = split(q), split(k), split(v)
                    kern = lambda: fa.fused_attention(q, k, v, bias, 12, 64)
                    plain = lambda: fa.fused_attention_reference(
                        q, k, v, bias, 12, 64)
                    lib = lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask)
                    row["ms"] = _graph_ms(torch, kern)
                    row["plain_ms"] = _graph_ms(torch, plain)
                    row["library_ms"] = _graph_ms(torch, lib)
                    row["call_ms"] = _eager_ms(torch, kern)
                rows.append(row)
                log("kernel: " + json.dumps(row))
                check(ok, f"fused_attention_fwd disagrees with its plain "
                          f"version at B={b} {dtype} ({sq},{sk}): max abs "
                          f"err {err} (tolerance {tol})")
    return rows


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


def _train_bound_terms(b, sq, sk, dtype, kind):
    """(bytes ms, FLOPs ms) of one training-kernel call, each input read
    once and each output written once: the forward for grad reads q, k, v
    and the bias and writes out and the fp32 residual; the stored backward
    reads q, g, k, v and the residual and writes dq, dk, dv; the recompute
    backward reads the bias instead of the residual."""
    item = 2 if dtype == "bfloat16" else 4
    d, h = 12 * 64, 12
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
    b = 2 if rehearse else TRAIN_BATCH
    for dtype in ("float32", "bfloat16"):
        for rate in TRAIN_RATES:
            for sq, sk in SERVE_SHAPES:
                q, k, v, bias = _attention_inputs(torch, b, sq, sk, dtype,
                                                  device, seed + 7 * sq + sk)
                gen = torch.Generator().manual_seed(seed + sq * sk)
                g = torch.randn(q.shape, generator=gen).to(device, q.dtype)
                args = (12, 64, rate, KERNEL_SEED)
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
                row = {"batch": b, "dtype": dtype, "rate": rate, "sq": sq,
                       "sk": sk,
                       "fwd_err": _max_err(torch, [out], [ref_out]),
                       "p_err": _max_err(torch, [p], [ref_p]),
                       "bwd_stored_err": _max_err(torch, stored, ref_s),
                       "bwd_recompute_err": _max_err(torch, recomp, ref_r),
                       "stored_vs_recompute": _max_err(torch, stored, recomp)}
                ok = (torch.allclose(out.float(), ref_out.float(), **TOL[dtype])
                      and torch.allclose(p, ref_p, atol=TOL_P, rtol=0)
                      and all(torch.allclose(x.float(), y.float(),
                                             **TOL_BWD[dtype])
                              for x, y in zip(stored + recomp, ref_s + ref_r)))
                for kind in ("fwd", "stored", "recompute"):
                    t_bytes, t_ops = _train_bound_terms(b, sq, sk, dtype, kind)
                    row[f"{kind}_bytes_ms"], row[f"{kind}_ops_ms"] = (t_bytes,
                                                                      t_ops)
                if not rehearse:
                    split = lambda t: (t.view(b, t.shape[1], 12, 64)
                                       .transpose(1, 2).detach()
                                       .requires_grad_())
                    qh, kh, vh = split(q), split(k), split(v)
                    gh = g.view(b, sq, 12, 64).transpose(1, 2)
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
                            q, k, v, fa.probs_residual(q, k, bias, 12, 64), g,
                            *args)))
                    row["library_fwd_ms"] = _graph_ms(torch, sdpa)
                    row["library_fwd_bwd_ms"] = _graph_ms(
                        torch, lambda: torch.autograd.grad(
                            sdpa(), (qh, kh, vh), gh))
                rows.append(row)
                log("train-kernels: " + json.dumps(row))
                check(ok, f"training attention kernels disagree with their "
                          f"plain versions at B={b} {dtype} rate {rate} "
                          f"({sq},{sk}): {row} (tolerances {TOL[dtype]}, "
                          f"p {TOL_P}, backward {TOL_BWD[dtype]})")
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


def _serve(root, dtype, store, device, tiny, seed, tag, artifacts=None):
    """serve_vqa over the requests; `artifacts` is the directory of the
    mask.pt and classifier4masker.bin to serve (default: `root`)."""
    import numpy as np

    from crvqa_tpu_torch.cli import serve_vqa

    artifacts = artifacts or root
    out = os.path.join(root, f"responses_{tag}.jsonl")
    argv = ["--dataroot", root, "--img_root", os.path.join(root, store),
            "--vocab_file", os.path.join(root, "vocab.txt"),
            "--mask_pt", os.path.join(artifacts, "mask.pt"),
            "--classifier_bin", os.path.join(artifacts,
                                             "classifier4masker.bin"),
            "--dtype", dtype, "--seed", str(seed),
            "--serve_batch_size", str(SERVE_BATCH), "--max_wait_ms", "5",
            "--input", os.path.join(root, "requests.jsonl"),
            "--output", out, "--device", str(device)]
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
    check(len(responses) == SERVE_REQUESTS
          and [r["question_id"] for r in responses] == list(
              range(SERVE_REQUESTS)),
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


def _plain_attention(q, k, v, bias, num_heads, head_size, rate=0.0, seed=0):
    """The model's attention on the plain versions: the primal's at rate 0
    without autograd, else the forward for grad's with the same
    counter-hash dropout, differentiated by autograd."""
    import torch

    from crvqa_tpu_torch.ops import fused_attention as fa

    if rate == 0.0 and not (torch.is_grad_enabled() and q.requires_grad):
        return fa.fused_attention_reference(q, k, v, bias, num_heads,
                                            head_size)
    return fa.fused_attention_train_reference(q, k, v, bias, num_heads,
                                              head_size, rate, seed)[0]


def phase_serve(torch, device, rehearse: bool, seed: int) -> dict:
    import numpy as np

    from crvqa_tpu_torch.models import LxmertConfig, layers
    from crvqa_tpu_torch.ops.fused_attention import fused_attention

    config = LxmertConfig.tiny() if rehearse else LxmertConfig()
    per_forward = config.l_layers + config.r_layers + 4 * config.x_layers
    forwards = 1 + SERVE_REQUESTS // SERVE_BATCH  # warm-up + full batches
    expected = 0 if rehearse else per_forward * forwards
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
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
            "bf16_agreement": agree / len(bf16), "fp32_logit_diff": dlogit}


def phase_profile(torch, device, seed: int) -> None:
    """Device time by kernel over one full-width bf16 forward at batch 32
    (report only: a profiler that records no device time says so)."""
    from torch.profiler import ProfilerActivity, profile

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
    with torch.inference_mode():
        for _ in range(3):
            model(**inputs)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                model(**inputs)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0) / 5
    dev_us = lambda e: (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("profile: the profiler recorded no device time: not measured")
        return
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / 5
    log(f"profile: bf16 forward, batch {SERVE_BATCH}: host wall "
        f"{wall_ms:.3f} ms/forward (profiler on), device busy "
        f"{busy_ms:.3f} ms/forward, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        log(f"profile: {dev_us(e) / 1e3 / 5:9.4f} ms/forward "
            f"{e.count // 5:5d} calls/forward  {e.key[:90]}")


# ----------------------------------------------------------------- phase 7

def _counters() -> dict:
    """Each kernel's wrapper, by the name its launch counter reports."""
    from crvqa_tpu_torch.ops import fused_attention as fa

    return {"fused_attention_fwd": fa.fused_attention,
            "fused_attention_fwd_train": fa.fused_attention_fwd_train,
            "fused_attention_bwd_stored": fa.fused_attention_bwd_stored,
            "fused_attention_bwd_recompute": fa.fused_attention_bwd_recompute}


def _run_counted(fn):
    """fn() with every launch counter set to 0 just before it and read just
    after: (fn's result, {kernel: launches})."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    result = fn()
    return result, {name: c.launches for name, c in counters.items()}


def phase_train(torch, device, rehearse: bool, seed: int) -> dict:
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
        want = {"fused_attention_fwd_train": per_fwd * steps,
                "fused_attention_bwd_stored": per_bwd * steps,
                "fused_attention_bwd_recompute": 0,
                "fused_attention_fwd": per_fwd * eval_batches}
        check(launches == {k: v * on_card for k, v in want.items()},
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
        rwant = {"fused_attention_fwd_train": per_fwd * rsteps,
                 "fused_attention_bwd_stored": 0,
                 "fused_attention_bwd_recompute": per_bwd * rsteps,
                 "fused_attention_fwd": 0}
        rlosses = rsummary["losses"]
        log(f"train: recompute backward, {len(rlosses)} steps: losses "
            f"{[round(x, 4) for x in rlosses]}; launches {rlaunches}")
        check(len(rlosses) == rsteps and all(np.isfinite(rlosses)),
              "train (recompute): losses missing or not finite")
        check(rlaunches == {k: v * on_card for k, v in rwant.items()},
              f"train (recompute): launches {rlaunches} != {rwant}")
    return {"steps": steps, "losses": losses, "launches": launches,
            "per_forward": per_fwd, "per_backward": per_bwd,
            "eval_batches": eval_batches, "zero_rates": rates,
            "best_acc": summary["best_acc"], "logged_ex_s": ex_s,
            "wall_s": wall_s, "served": served,
            "recompute": {"steps": rsteps, "losses": rlosses,
                          "launches": rlaunches}}


# ----------------------------------------------------------------- phase 8

def _stage2_setup(torch, config, device, seed, batch_size):
    """A stage-2 state at `config` in the canonical configuration and one
    synthetic batch on the device."""
    import dataclasses

    from crvqa_tpu_torch.data.prefetch import to_device
    from crvqa_tpu_torch.data.synthetic import synthetic_batch
    from crvqa_tpu_torch.masking.masker import Masker
    from crvqa_tpu_torch.masking.sparsity_control import ModalSparsity
    from crvqa_tpu_torch.masking.spec import lxmert_mask_specs
    from crvqa_tpu_torch.models import build_lxmert
    from crvqa_tpu_torch.train import stage2

    masker = Masker.create(
        lxmert_mask_specs(config.l_layers, config.r_layers, config.x_layers),
        ModalSparsity.from_compression(0.3, 0.3, 0.3, 0.7),
        controlled_init="magnitude")
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
    """Device time by kernel over `steps` calls of fn (report only: a
    profiler that records no device time says so)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    dev_us = lambda e: (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
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


# ----------------------------------------------------------------- summary

def kernel_summary(rows, train_rows, serve, train) -> list[dict]:
    """One entry per kernel at its main path's shapes. The primal: one bf16
    forward at batch 32, summed over its 34 launches ((14,14) x l+x,
    (36,36) x r+x, (14,36) and (36,14) x x). The training kernels: one bf16
    train step at batch 256, dropout rate 0.1, summed over the step's 34
    forward-for-grad and 32 backward launches (`launch_mult`)."""
    from crvqa_tpu_torch.models import LxmertConfig

    fwd_mult, bwd_mult = launch_mult(LxmertConfig())
    main = [r for r in rows if r["batch"] == SERVE_BATCH
            and r["dtype"] == "bfloat16"]
    total = lambda key: sum(r[key] * fwd_mult[(r["sq"], r["sk"])]
                            for r in main)
    bound_ms, bound_by = _bound(total("bytes_ms"), total("ops_ms"))
    src = "crvqa_tpu_torch/csrc/"
    out = [{
        "name": "fused_attention_fwd", "route": "cuda",
        "source": src + "fused_attention_fwd.cu",
        "replaces": "crvqa_tpu/ops/fused_attention.py:153",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": total("library_ms"),
        "basis": f"one bf16 forward at batch {SERVE_BATCH}: "
                 f"{sum(fwd_mult.values())} launches over (Sq,Sk) "
                 + ", ".join(f"{k}x{v}" for k, v in fwd_mult.items()),
    }]
    main = [r for r in train_rows if r["batch"] == TRAIN_BATCH
            and r["dtype"] == "bfloat16" and r["rate"] == MAIN_RATE]
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
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r[k] for r in main for k in err_keys),
            "ms": tot(f"{kind}_ms"), "plain_ms": tot(f"{kind}_plain_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": tot(library),
            "basis": f"one bf16 train step at batch {TRAIN_BATCH}, dropout "
                     f"{MAIN_RATE}: {sum(mult.values())} launches over "
                     f"(Sq,Sk) " + ", ".join(f"{k}x{v}"
                                             for k, v in mult.items())
                     + f"; library_ms: {what}",
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
    try:
        dev = phase_device(torch, args.rehearse)
        if not args.rehearse:
            phase_build()
        rows = phase_kernel(torch, device, args.rehearse, args.seed)
        train_rows = phase_train_kernels(torch, device, args.rehearse,
                                         args.seed)
        serve = phase_serve(torch, device, args.rehearse, args.seed)
        if not args.rehearse:
            phase_profile(torch, device, args.seed)
        train = phase_train(torch, device, args.rehearse, args.seed)
        step = phase_step(torch, device, args.rehearse, args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases in {time.monotonic() - t0:.1f} s")
    if args.rehearse:
        log("chip_smoke: rehearsal finished (CPU, tiny widths): no result")
        return 3
    kernels = kernel_summary(rows, train_rows, serve, train)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": dev, "kernel_rows": rows,
                       "train_kernel_rows": train_rows, "serve": serve,
                       "train": train, "step": step, "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
