"""Batched VQA inference server on the card (counterpart of
`crvqa_tpu/cli/serve_vqa.py`; same argv plus `--device`, same JSON-lines
protocol, same stats line).

- One request `{"question_id": ..., "question": str, "image_id": str}` per
  line on stdin (or `--input`), one response `{"question_id", "answer",
  "prob"}` per line on stdout (or `--output`), in arrival order. A bad
  request gets an `"error"` response; it never takes down its batch.
- Micro-batching: up to `--serve_batch_size` requests, waiting at most
  `--max_wait_ms` after the first; every batch is padded to that one shape.
- Params: a stage-1/3 checkpoint (`--ckpt`, or a seeded init without one),
  then optionally the stage-2 subnetwork (`--mask_pt` folded in as
  `w * mask` once at load, `--classifier_bin` swapped in).
- `--model_type lxmert` (default) or `visualbert`: VisualBERT reads the
  2048-d box features as its `visual_embeds` (no spatials), its mask.pt
  by the uniform VisualBERT table and its head as `cls`.
- Runs on `--device cuda` (default), where every attention goes through
  the fused-attention kernel; `--device cpu` runs the plain versions (the
  tests' path). Without a card and without `--device cpu` it raises.
- End of input prints the stats line (requests, batches, occupancy,
  per-batch latency percentiles with host preprocessing included) to
  stderr; `main` also returns it with the raw batch latencies.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..masking.prune import lxmert_specs_for, prune_state_dict
from ..masking.spec import visualbert_mask_specs
from ..models import (LxmertConfig, VisualBertConfig, build_lxmert,
                      build_visualbert)
from ..train.common import model_inputs
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("serve_vqa")
    p.add_argument("--model_type", type=str, default="lxmert",
                   choices=["lxmert", "visualbert"])
    p.add_argument("--ckpt", type=str, default=None,
                   help="params checkpoint: stage-1/3 torch .bin")
    p.add_argument("--mask_pt", type=str, default=None,
                   help="stage-2 mask.pt -> serve the pruned subnetwork")
    p.add_argument("--classifier_bin", type=str, default=None,
                   help="stage-2 classifier4masker.bin")
    p.add_argument("--zero_rate", type=float, default=0.7,
                   help="accepted for argv compatibility: the served masks "
                        "are read from --mask_pt as they are")
    p.add_argument("--dataroot", type=str, required=True,
                   help="dir with cache/train_test_label2ans.pkl")
    p.add_argument("--img_root", type=str, required=True,
                   help="image-feature pickle or native .bin store")
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--ans_num", type=int, default=2274)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--serve_batch_size", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="max time to hold a non-full batch after its first "
                        "request")
    p.add_argument("--input", type=str, default="-",
                   help="'-' = stdin, else a requests .jsonl file")
    p.add_argument("--output", type=str, default="-",
                   help="'-' = stdout, else a responses .jsonl file")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    common.add_kernel_flags(p)
    return p


def load_serving_params(args, model, config) -> dict[str, torch.Tensor]:
    """Checkpoint, then the optional stage-2 subnetwork artifacts, over
    `model`'s state_dict (the `run_vqa_stage3.py:227-324` pruning applied
    once at load: served weights are exactly `w * mask`)."""
    visualbert = args.model_type == "visualbert"
    state = common.load_params_any(args.ckpt, model.state_dict())
    if args.mask_pt:
        from ..core import torch_compat

        specs = (visualbert_mask_specs(config.num_hidden_layers) if visualbert
                 else lxmert_specs_for(config))
        masks = torch_compat.import_mask_pt(args.mask_pt, specs)
        state = prune_state_dict(state, masks)
    if args.classifier_bin:
        state = common.overlay_classifier(
            state, args.classifier_bin, key="cls" if visualbert
            else "classifier")
    return state


def build_serving_model(args, device: torch.device):
    """The served model on `device` in eval mode: seeded init from
    `--seed` unless `--ckpt` supplies every parameter."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.model_type == "visualbert":
        config_cls, build = VisualBertConfig, build_visualbert
    else:
        config_cls, build = LxmertConfig, build_lxmert
    config = (config_cls.tiny(dtype=dtype) if args.tiny
              else config_cls(ans_num=args.ans_num, dtype=dtype))
    generator = (None if args.ckpt
                 else torch.Generator().manual_seed(args.seed))
    model = build(config, "cpu", generator)
    model.load_state_dict(load_serving_params(args, model, config),
                          strict=True)
    return model.to(device).eval()


class _Batcher:
    """Reader thread + bounded queue; the main loop pulls the first pending
    request blocking, then drains up to batch_size-1 more within
    max_wait_ms. A single reader preserves arrival order."""

    _EOF = object()

    def __init__(self, stream, batch_size: int, max_wait_ms: float):
        self.q: queue.Queue = queue.Queue(maxsize=4 * batch_size)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.done = False
        self._t = threading.Thread(target=self._read, args=(stream,),
                                   daemon=True)
        self._t.start()

    def _read(self, stream):
        # the finally-EOF is load-bearing: if this thread dies without
        # enqueueing the sentinel, next_batch() blocks forever and the
        # server hangs — malformed lines are dropped, never fatal
        try:
            for line in stream:
                line = line.strip()
                if not line:
                    continue
                try:
                    self.q.put(json.loads(line))
                except ValueError as e:
                    print(f"serve: dropped malformed request line: {e}",
                          file=sys.stderr, flush=True)
        finally:
            self.q.put(self._EOF)

    def next_batch(self) -> Optional[list]:
        if self.done:
            return None
        first = self.q.get()
        if first is self._EOF:
            self.done = True
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            try:
                item = self.q.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            if item is self._EOF:
                self.done = True
                break
            batch.append(item)
        return batch


def serve_loop(args, run_batch, tag: str) -> dict:
    """Micro-batch from --input, write responses to --output in arrival
    order, print the stats line at EOF. Returns the stats plus the raw
    per-batch latencies (`batch_ms`) and the seconds from the first batch's
    start to the last batch's end (`wall_s`)."""
    bs = args.serve_batch_size
    in_stream = sys.stdin if args.input == "-" else open(args.input)
    out_stream = sys.stdout if args.output == "-" else open(args.output, "w")
    batcher = _Batcher(in_stream, bs, args.max_wait_ms)

    n_req = n_batch = 0
    lat_ms: list = []
    t_first = t_last = None
    while True:
        reqs = batcher.next_batch()
        if reqs is None:
            break
        t0 = time.monotonic()
        t_first = t0 if t_first is None else t_first
        try:
            resps = run_batch(reqs)
        except Exception as e:  # a long-lived server must outlive one bad
            # batch: every request in it gets an error response instead of
            # the whole process dying with the in-flight queue
            resps = [{"question_id": (r.get("question_id")
                                      if isinstance(r, dict) else None),
                      "error": f"{type(e).__name__}: {e}"} for r in reqs]
        for resp in resps:
            out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()
        t_last = time.monotonic()
        lat_ms.append(1000 * (t_last - t0))
        n_req += len(reqs)
        n_batch += 1
    if args.input != "-":
        in_stream.close()
    if args.output != "-":
        out_stream.close()

    stats: dict = {}
    if n_batch:
        lat = np.asarray(lat_ms)
        stats = {"requests": n_req, "batches": n_batch,
                 "occupancy": round(n_req / (n_batch * bs), 3),
                 "batch_ms_p50": round(float(np.percentile(lat, 50)), 2),
                 "batch_ms_p99": round(float(np.percentile(lat, 99)), 2)}
        print(f"{tag} stats: {json.dumps(stats)}", file=sys.stderr,
              flush=True)
    return {**stats, "batch_ms": lat_ms,
            "wall_s": (t_last - t_first) if n_batch else 0.0}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = build_serving_model(args, device)

    from ..data import vqacp

    tokenizer = vqacp.make_tokenizer(args.vocab_file)
    _, label2ans = vqacp.load_answer_vocab(args.dataroot)
    features = vqacp.open_image_features(args.img_root)

    @torch.inference_mode()
    def forward(batch):
        logits, _ = model(**model_inputs(batch))
        return logits

    def device_batch(ids, feats, pos):
        b = {"input_ids": torch.from_numpy(ids).to(device, torch.long),
             # all-ones mask = the reference's positional model call
             # (mask_trainer_Robust_VQA.py:808)
             "attention_mask": torch.ones(ids.shape, dtype=torch.float32,
                                          device=device)}
        if args.model_type == "visualbert":
            # single stream: the box features are the visual_embeds
            # (mask_trainer_visualBERT_VQA.py:820); no spatials
            b["visual_embeds"] = torch.from_numpy(feats).to(device)
        else:
            b["visual_feats"] = torch.from_numpy(feats).to(device)
            b["visual_pos"] = torch.from_numpy(pos).to(device)
        return b

    bs = args.serve_batch_size

    def run_batch(requests: list) -> list:
        # per-request validation: a bad request gets an error RESPONSE and
        # is excluded from the model batch
        responses: list = [None] * len(requests)
        live = []
        for i, r in enumerate(requests):
            if (not isinstance(r, dict) or "question" not in r
                    or "image_id" not in r):
                responses[i] = {
                    "question_id": (r.get("question_id")
                                    if isinstance(r, dict) else None),
                    "error": "request needs question and image_id"}
            elif str(r["image_id"]) not in features:
                responses[i] = {"question_id": r.get("question_id"),
                                "error": f"unknown image_id {r['image_id']}"}
            else:
                live.append(i)
        if not live:
            return responses
        n = len(live)
        questions = [requests[i]["question"] for i in live]
        image_ids = np.asarray([str(requests[i]["image_id"]) for i in live])
        if n < bs:  # pad to the one batch shape; pad rows are discarded
            questions += [""] * (bs - n)
            image_ids = np.concatenate(
                [image_ids, np.repeat(image_ids[-1:], bs - n)])
        ids, _ = vqacp.tokenize_questions(questions, tokenizer)
        feats, pos = features.lookup(image_ids)
        logits = forward(device_batch(ids, feats, pos)).cpu().numpy()[:n]
        top = logits.argmax(axis=1)
        probs = 1.0 / (1.0 + np.exp(-logits[np.arange(n), top]))
        for j, i in enumerate(live):
            responses[i] = {"question_id": requests[i].get("question_id"),
                            "answer": label2ans[int(top[j])],
                            "prob": round(float(probs[j]), 6)}
        return responses

    # warm-up on a dummy batch: builds the kernel library and primes the
    # allocator before the first request arrives
    t0 = time.monotonic()
    run_batch([{"question_id": -1, "question": "warm up",
                "image_id": features.ids()[0]}])
    print(f"serve_vqa: ready (warm-up {time.monotonic() - t0:.1f}s, device "
          f"{device}, batch {bs}, wait {args.max_wait_ms}ms)",
          file=sys.stderr, flush=True)

    return serve_loop(args, run_batch, tag="serve_vqa")


if __name__ == "__main__":
    main()
