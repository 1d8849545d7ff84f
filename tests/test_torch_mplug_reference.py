"""The port's mPLUG mask training (`train/mplug_train.py` on the model of
`models/mplug/`) against the benchmark's plain PyTorch reference
(`portbench/reference/mplug.py`, written from the published equations) on
the CPU, at a tiny width in float32 with seeded random weights:

- one training forward and backward: the loss and every score and
  LM-head gradient; then one whole step's change of every leaf (the clip
  and the two-group AdamW); then a reset's thresholds. At dropout 0 and
  at 0.1, where the reference replays the program's draws (the hidden
  masks and the eager attention's from the device generator, the short
  and mid-length kernels' counter-hash masks from the host seeds);
- the decoder's grouped memory (each question's memory read once by its
  answer rows) against a replicated one: the same logits;
- the reference's parameter table against the program's state_dict at
  the published widths (on `meta`), and its masked matrices against
  `mplug_mask_specs`.
"""
import pytest
import torch

from crvqa_tpu_torch.masking.masker import weight_name
from crvqa_tpu_torch.models.mplug import MPlugConfig
from crvqa_tpu_torch.train import mplug_train
from portbench.families import mplug as family
from portbench.harness.cells import Benchmark
from portbench.harness.inputs import make_weights
from portbench.harness.mplug_inputs import make_pool
from portbench.reference import mplug as ref
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

BENCH = Benchmark()
SEED = 2718281829
# 128 px in 8 px patches: 257 visual tokens, so at 4 heads the ViT, the
# fusion cross-attention, the stride layer and the grouped decoder
# cross-attention take the mid-length kernel's path (its plain version on
# the CPU), the text self-attention the short kernel's and the decoder's
# causal self-attention the eager one
TINY = dict(image_res=128, patch_size=8, vision_width=32, vision_layers=2,
            vision_heads=4, vocab_size=128, hidden_size=32,
            num_attention_heads=4, intermediate_size=64,
            text_encoder_layers=2, fusion_layers=4, text_decode_layers=2,
            stride_layer=3, max_position_embeddings=64, dtype="float32")
TRAFFIC = dict(batch_size=4, pool_batches=1,
               answers={"slots": 3, "tokens": 7, "votes": 10,
                        "words": {"min": 1, "max": 3}},
               question_tokens={"min": 3, "max": 8})


def _setup(rate: float):
    cfg = dict(BENCH.config("mplug-base"), **TINY)
    cfg.update(hidden_dropout_prob=rate, attention_probs_dropout_prob=rate,
               attn_dropout=rate)
    trf = dict(BENCH.traffic("mplug-mask-b128"), **TRAFFIC)
    # past the warm-up, where the two groups' rates differ (3e-5, 5e-6)
    trf["optimizer"] = dict(trf["optimizer"], sched=dict(
        trf["optimizer"]["sched"], warmup_epochs=0))
    weights = lambda: make_weights(ref.param_table(cfg), SEED, "cpu")
    prog = family.build(cfg, trf, weights(), SEED, "cpu")
    family.check_settings(prog, family.optimizer_settings(trf))
    reference = ref.MPlugReference(cfg, family.optimizer_settings(trf),
                                   weights(), SEED)
    batch = make_pool(cfg, trf, SEED, "cpu")[0]
    return cfg, trf, prog, reference, batch


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (0 where both are 0)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else float(
        a.abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_mask_step_matches_the_reference(rate):
    cfg, trf, prog, reference, batch = _setup(rate)
    by_key = {s.key: weight_name(s) for s in prog.masker.specs}
    name = lambda k: (by_key[k.split("/", 1)[1]] if k.startswith("scores/")
                      else k.split("/", 1)[1])
    # forward and backward on the state's own generators
    gens = [prog.state.rng.device, prog.state.rng.host,
            reference.device_gen, reference.host_gen]
    saved = [g.get_state() for g in gens]
    loss, grads = mplug_train.make_loss_and_grads(
        prog.model, prog.config, prog.masker)(prog.state, batch)
    ref_loss, ref_grads = reference.loss_and_grads(batch, block=3)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    grads = {name(k): g for k, g in grads.items()}
    assert set(grads) == set(ref_grads)
    assert len(grads) == len(ref.masked_weights(cfg)) + 5
    worst = max(_gap(grads[k], ref_grads[k]) for k in grads)
    assert worst <= 2e-5, worst
    # the same forward again inside one whole step, then the reset
    for g, state in zip(gens, saved):
        g.set_state(state)
    before = {k: v.detach().clone() for k, v in prog.trainable().items()}
    step = mplug_train.make_train_step(prog.model, prog.config, prog.masker,
                                       mesh=prog.mesh, zero=prog.zero)
    step(prog.state, batch)
    ref_before = {k: v.clone() for k, v in reference.trainable().items()}
    _, clipped = reference.step(batch, block=3)
    # the first AdamW step moves an entry by about lr * g / (|g| + eps):
    # entries whose gradient is within a few eps of 0 carry the products'
    # round-off into the change at full size, so the change is compared
    # where |g| is at least 1e-4 of its leaf's largest; each side's new
    # value is rounded to float32 once (2 ulp of it allowed)
    ulp = torch.finfo(torch.float32).eps
    worst = 0.0
    for k, v in prog.trainable().items():
        after = reference.trainable()[k]
        want = after - ref_before[k]
        sure = clipped[k].abs() >= 1e-4 * clipped[k].abs().max()
        assert float(sure.float().mean()) >= 0.95
        excess = ((v.detach() - before[k]) - want).abs() - 2 * ulp * (
            after.abs())
        worst = max(worst, float(excess[sure].max()) / float(
            want.abs().max()))
    assert worst <= 1e-5, worst
    mplug_train.make_threshold_reset(prog.masker)(prog.state, 0.5)
    want = reference.reset(0.5)
    for k, t in prog.thresholds().items():
        assert float(t) == pytest.approx(float(want[k]), rel=1e-6, abs=0)


def test_grouped_and_replicated_decoder_memory_give_the_same_logits():
    cfg, trf, _, reference, batch = _setup(0.0)
    p, _ = reference.params(grad=False)
    draws = lambda: ref.Replay(None, None).block(0, 4, 3)
    grouped = ref.answer_logits(p, batch, cfg, draws())
    replicated = ref.answer_logits(p, batch, cfg, draws(), grouped=False)
    assert _gap(grouped, replicated) <= 1e-5
    # and the program's decoder, which attends the memory grouped
    prog_cfg, _, prog, _, _ = _setup(0.0)
    logits = mplug_train.run_masked(
        prog.model, prog.masker, prog.state, lambda m, *a: m.answer_logits(
            *a), *(batch[k] for k in ("images", "question_ids",
                                      "question_mask", "answer_ids",
                                      "answer_mask")))
    assert _gap(logits, grouped) <= 1e-5


def test_parameter_table_is_the_programs_state_dict_at_published_widths():
    cfg = BENCH.config("mplug-base")
    model = mplug_train.mplug_meta_model(MPlugConfig())
    program = {k: tuple(v.shape) for k, v in model.named_parameters()}
    table = {n: tuple(s) for n, s, _ in ref.param_table(cfg)}
    assert table == program
    assert [n for n, _, _ in ref.param_table(cfg)] == list(program)
    assert not list(model.named_buffers())


def test_masked_matrices_are_mplug_mask_specs():
    cfg = BENCH.config("mplug-base")
    args = family.cli_args(cfg, BENCH.traffic("mplug-mask-b128"), 0, "cpu")
    from crvqa_tpu_torch.cli import vqa_mplug

    config, _, _ = vqa_mplug.build_model(args)
    masker = vqa_mplug.build_masker(args, config)
    program = [weight_name(s) for s in masker.specs]
    reference = [n for n, _ in ref.masked_weights(cfg)]
    # 24 ViT MLP, 36 text, 5 x 10 + 6 fusion, 120 decoder matrices
    assert program == reference and len(program) == 236
    assert masker.zerorate_dict == {"Uni": cfg["masker"]["zero_rate"]}
    assert masker.controlled_init == cfg["masker"]["controlled_init"]
    assert masker.binarizer_name == cfg["masker"]["binarizer"]
    model = mplug_train.mplug_meta_model(config)
    assert ref.head_params(cfg) == list(mplug_train.split_head_params(
        dict(model.named_parameters()),
        mplug_train.MPlugTrainConfig().head_substrings))

