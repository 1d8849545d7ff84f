"""Batched mPLUG inference server on the card (counterpart of
`crvqa_tpu/cli/serve_mplug.py`; same argv plus `--device`, same JSON-lines
protocol and stats line as `serve_vqa`).

- Requests `{"question_id": ..., "question": str, "image": <path>}` (plus
  the optional "ocr" / "object_label" fields spliced with `--add_ocr` /
  `--add_object`); responses `{"question_id", "answer"}` in arrival order.
  A request without a question, or with an unreadable image, gets an
  "error" response; the rest of its batch answers.
- Answers by beam search (`--eval_method beam`, the default: beam 5,
  `--max_answer_len 12`, `--decode_cache true`) or by ranking a fixed
  `--answer_list` (`--eval_method rank`: first-token top-`--k_test`
  shortlist and chain-rule re-rank; `--k_test 0` scores the whole list).
- `--mode mask` (default) serves a masker over the mPLUG specs at
  `--zero_rate`; `--mode full` the unmasked weights. Weights are seeded
  from `--seed`; `--ckpt` lays a checkpoint written by
  `crvqa_tpu_torch.cli.vqa_mplug` (a `ckpt_<step>` or `ckpt_final`) over
  them: its trained parameters, scores and thresholds; or the JAX
  package's `ckpt_final` / `ckpt_<step>`, whose parameters (all of them),
  scores and thresholds are kept, as the JAX server keeps them. `--init_ckpt` and
  `--use_checkpoint` are parsed and not read, as the JAX server parses and
  ignores them (a logged line says so): serving never loads the training
  init, and has no backward to recompute for. The runtime's flags
  (`--mesh_data`, `--mesh_model`, `--multihost` and its three) are parsed
  and not read either: one process serves on `--device`.
- Every batch is padded to `--serve_batch_size` (beam search and ranking
  are row-independent: padding cannot change a real row's answer).
- Runs on `--device cuda` (default), where the attentions go through the
  mid-length and short attention kernels; `--device cpu` runs their plain
  versions (the tests' path). Without a card and without `--device cpu`
  it raises.

`build_server(args, device)` returns the `run_batch` function the loop
drives (`chip_smoke.py` drives it directly); `main` adds the warm-up batch
(`warm_up`) and the serve loop, and returns the loop's stats.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..train import mplug_train
from . import common, vqa_mplug
from .serve_vqa import serve_loop


def build_parser() -> argparse.ArgumentParser:
    p = vqa_mplug.build_parser()
    p.prog = "serve_mplug"
    p.add_argument("--ckpt", type=str, default=None,
                   help="a ckpt_final / ckpt_<step> written by "
                        "crvqa_tpu_torch.cli.vqa_mplug (same --mode, --seed "
                        "and masker flags) or by the JAX package's")
    p.add_argument("--serve_batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=20.0)
    p.add_argument("--input", type=str, default="-",
                   help="'-' = stdin, else a requests .jsonl file")
    p.add_argument("--output", type=str, default="-",
                   help="'-' = stdout, else a responses .jsonl file")
    return p


def build_state(args, config, model, masker, device
                ) -> mplug_train.MPlugState:
    """Seeded fp32 weights from `--seed` (the masker's scores from them),
    cast to the model's dtypes on `device`; then `--ckpt` over them."""
    cfg = mplug_train.MPlugTrainConfig(mode=args.mode, distill=args.distill)
    state = mplug_train.init_state(
        model, vqa_mplug.initial_params(args, config), cfg, device,
        masker=masker, seed=args.seed)
    if args.ckpt:
        common.resume_any(args.ckpt, state, "mplug", cfg,
                          masker.specs if masker is not None else None)
    return state


def build_server(args, device: torch.device,
                 images: Optional[Mapping[str, np.ndarray]] = None
                 ) -> Callable:
    """run_batch(requests, pixels=None) -> responses for the served model
    on `device`. A request's "image" is a file path, or, when `images` is
    given, a key into it (pre-transformed [res, res, 3] arrays: uint8 with
    `--device_normalize`, else normalised fp32). `pixels` hands a batch's
    images in directly (the warm-up)."""
    if not args.vocab_file:
        raise ValueError("serve_mplug requires --vocab_file")
    for flag in ("init_ckpt", "use_checkpoint"):
        if getattr(args, flag):
            common.logger.info(
                "serve_mplug: --%s is not read (as in the JAX server): the "
                "served weights come from --seed and --ckpt", flag)
    for flag, default in common.MESH_FLAGS.items():
        if getattr(args, flag) != default:
            common.logger.info(
                "serve_mplug: --%s is not read (as in the JAX server): one "
                "process serves on --device", flag)
    config, tokenizer, model = vqa_mplug.build_model(args)
    masker = (vqa_mplug.build_masker(args, config) if args.mode == "mask"
              else None)
    state = build_state(args, config, model, masker, device)
    cfg = mplug_train.MPlugTrainConfig(mode=args.mode, distill=args.distill)

    from ..data.mplug_data import (_tokenize_fixed, augment_question,
                                   load_images, question_token_len)

    rank_fn = None
    if args.eval_method == "rank":
        if not args.answer_list:
            raise ValueError("--eval_method rank needs --answer_list")
        rank_fn, answers, best_index = vqa_mplug.build_rank_fn(
            args, config, tokenizer, model, masker, cfg, device)
    gen_fn = mplug_train.make_generate_step(
        model, cfg, masker=masker, beam_size=args.beam_size,
        max_len=args.max_answer_len, min_length=args.min_length,
        use_cache=args.decode_cache)

    bs = args.serve_batch_size
    q_len = question_token_len(args.add_ocr, args.max_input_length)
    res = config.vit.image_res
    eos = config.eos_token_id

    def readable(name) -> bool:
        if not isinstance(name, str):
            return False
        return name in images if images is not None else os.path.isfile(name)

    def decode_answer(row: np.ndarray) -> str:
        toks = [int(t) for t in row[1:]]
        if eos in toks:
            toks = toks[: toks.index(eos)]
        return tokenizer.decode(toks).strip()

    def device_batch(texts: list, pixels: np.ndarray) -> dict:
        """Questions and their images as the model's device batch, padded
        to the one batch shape (pad rows are discarded)."""
        n = len(texts)
        if n < bs:
            texts = texts + [""] * (bs - n)
            pixels = np.concatenate(
                [pixels, np.repeat(pixels[-1:], bs - n, axis=0)])
        ids, mask = _tokenize_fixed(tokenizer, texts, q_len)
        return {"images": torch.from_numpy(pixels).to(device),
                "question_ids": torch.from_numpy(ids).to(device, torch.long),
                "question_mask": torch.from_numpy(mask).to(device)}

    def model_fn(state, batch: dict):
        """The model's work on one device batch: the rank scores, or the
        beam search's (ids, scores)."""
        if rank_fn is not None:
            return rank_fn(state, batch)
        return gen_fn(state, batch)

    def run_batch(requests: list, pixels: Optional[np.ndarray] = None
                  ) -> list:
        responses: list = [None] * len(requests)
        live = []
        for i, r in enumerate(requests):
            if not isinstance(r, dict) or "question" not in r:
                responses[i] = {
                    "question_id": (r.get("question_id")
                                    if isinstance(r, dict) else None),
                    "error": "request needs question and image"}
            elif pixels is None and not readable(r.get("image")):
                responses[i] = {"question_id": r.get("question_id"),
                                "error": f"unreadable image {r.get('image')}"}
            else:
                live.append(i)
        if not live:
            return responses
        n = len(live)
        texts = [augment_question(requests[i], args.add_ocr, args.add_object)
                 for i in live]
        if pixels is None:
            names = [requests[i]["image"] for i in live]
            pixels = (np.stack([images[k] for k in names])
                      if images is not None else
                      load_images(names, res, workers=args.data_workers,
                                  raw=args.device_normalize))
        batch = device_batch(texts, pixels)
        if rank_fn is not None:
            best = best_index(model_fn(state, batch))
            for j, i in enumerate(live):
                responses[i] = {"question_id": requests[i].get("question_id"),
                                "answer": answers[int(best[j])]}
            return responses
        out_ids, _ = model_fn(state, batch)
        out_ids = out_ids[:n].cpu().numpy()
        for j, i in enumerate(live):
            responses[i] = {"question_id": requests[i].get("question_id"),
                            "answer": decode_answer(out_ids[j])}
        return responses

    run_batch.image_res = res
    # one device batch's model call, apart from the host work around it
    # (`utils/mfu.count_flops` counts it): model_fn(state, device_batch(
    # questions, images))
    run_batch.device_batch, run_batch.model_fn = device_batch, model_fn
    run_batch.state = state
    return run_batch


def warm_up(args, run_batch) -> float:
    """One dummy batch (builds the kernel libraries, primes the allocator);
    returns its seconds."""
    res = run_batch.image_res
    t0 = time.monotonic()
    run_batch([{"question_id": -1, "question": "warm up"}],
              pixels=np.zeros((1, res, res, 3),
                              np.uint8 if args.device_normalize
                              else np.float32))
    return time.monotonic() - t0


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    run_batch = build_server(args, device)
    seconds = warm_up(args, run_batch)
    print(f"serve_mplug: ready (warm-up {seconds:.1f}s, device {device}, "
          f"batch {args.serve_batch_size}, {args.eval_method}"
          f"{f' {args.beam_size}' if args.eval_method == 'beam' else ''})",
          file=sys.stderr, flush=True)
    return serve_loop(args, run_batch, tag="serve_mplug")


if __name__ == "__main__":
    main()
