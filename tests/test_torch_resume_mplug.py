"""Resume the JAX package's mPLUG training states in the port
(`core/convert.mplug_state_from_jax` / `jax_from_mplug_state`,
`cli/common.resume_any`), on the tiny mPLUG at fp32 with every dropout at
0, on synthetic batches, in three runs of `vqa_mplug`: `--mode mask` (the
default adamw; this file), `--mode mask --distill true` (the momentum
twins and their scores; tests/test_torch_resume_mplug_distill.py) and
`--mode full --opt lamb` (every parameter trained, a second layout of the
`--opt` table; tests/test_torch_resume_mplug_full.py): one JAX run pair
per file, so the three run on three test workers.

The JAX package trains 2 steps and writes `ckpt_2`, then 2 more from it
(a resumed run replays its epochs' batches from the first, in either
package) and writes `ckpt_final`, as its CLI `crvqa_tpu.cli.vqa_mplug`
does with this argv (`jax_runs`: the CLI's own model, masker and train
config, a jitted init, one jitted train step on the CLI's synthetic batches,
the threshold reset after the last step, and the JAX package's
`save_checkpoint`). Then:

- the port resumed from `ckpt_2`, before any step, written back in the
  JAX layout, equals the file bit for bit;
- the port's CLI resumed from `ckpt_2` with the same argv ends (its final
  threshold reset included) at the JAX `ckpt_final`: the step-4 loss rtol
  1e-4; parameters, scores and thresholds atol 2 * lr * steps; moments
  within 1e-3 of their moment's largest value
  (tests/test_torch_resume_interchange.py); counts exact;
- the port's JAX-layout file of the mask run loads in the JAX package's
  `load_checkpoint` into its CLI's state template with the JAX file's
  leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crvqa_tpu.cli import vqa_mplug as jvqa_mplug
from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.data.mplug_data import synthetic_mplug_batch
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.cli import common, vqa_mplug
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.train import mplug_train
from tests.test_torch_resume_interchange import (_array, assert_bit_equal,
                                                 flat, moment_scale)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-3
ARGV = ["--tiny", "--dtype", "float32", "--seed", "7", "--synthetic", "16",
        "--train_batch_size", "8", "--eval_batch_size", "8",
        "--num_train_epochs", "1", "--masker_update_step", "100",
        "--logging_steps", "2", "--save_steps", "2", "--init_sparsity",
        "0.3", "--final_sparsity_epoch", "1", "--lr1", str(LR), "--lr2",
        str(LR), "--warmup_lr", str(LR), "--hidden_dropout_prob", "0",
        "--attention_probs_dropout_prob", "0"]
KINDS = {"mask": [], "distill": ["--distill", "true"],
         "full": ["--mode", "full", "--opt", "lamb"]}


def _jax_train_config(args, n_train):
    """The JAX CLI's `MPlugTrainConfig` for `args` (vqa_mplug.py main)."""
    steps_per_epoch = max(n_train // args.train_batch_size, 1)
    return jtrain.MPlugTrainConfig(
        mode=args.mode, lr1=args.lr1, lr2=args.lr2,
        weight_decay=(0.02 if args.weight_decay is None
                      else args.weight_decay),
        warmup_steps=(steps_per_epoch if args.warmup_steps is None
                      else args.warmup_steps),
        total_steps=int(steps_per_epoch * args.num_train_epochs),
        min_lr=args.min_lr, sched=args.sched, decay_rate=args.decay_rate,
        decay_steps=args.decay_steps,
        steps_per_epoch=(steps_per_epoch
                         if args.sched_granularity == "epoch"
                         and args.warmup_steps is None else 0),
        epochs=int(args.num_train_epochs),
        warmup_epochs=args.warmup_epochs, warmup_lr_init=args.warmup_lr,
        decay_epochs=args.decay_epochs, opt=args.opt,
        opt_momentum=args.opt_momentum, max_grad_norm=args.max_grad_norm,
        use_bias_reweight=args.use_bias_reweight, distill=args.distill,
        alpha=args.alpha,
        alpha_warmup_steps=steps_per_epoch if args.alpha_warm_up else 0)


def jax_runs(kind, tmp_path_factory):
    """The JAX run of `kind` to `ckpt_2` and its resumed continuation to
    `jax_resumed/ckpt_final` (the module docstring); returns (kind, root,
    the continuation's step-4 loss)."""
    root = tmp_path_factory.mktemp(kind)
    args = jvqa_mplug.build_parser().parse_args(
        ARGV + KINDS[kind] + ["--do_train", "--output_dir", str(root)])
    config, _, model = jvqa_mplug.build_model(args)
    masker = (jvqa_mplug.build_masker(args, config)[0]
              if args.mode == "mask" else None)
    ql, al, apq = (int(x) for x in args.synthetic_shapes.split(","))
    batches = [synthetic_mplug_batch(
        batch_size=args.train_batch_size, image_res=config.vit.image_res,
        q_len=ql, a_len=al, answers_per_question=apq,
        uint8_images=args.device_normalize,
        vocab_size=config.bert.vocab_size, seed=i)
        for i in range(args.synthetic // args.train_batch_size)]
    batches = [{k: jnp.asarray(v) for k, v in b.items()
                if k not in ("qid", "valid")} for b in batches]
    b0 = batches[0]
    params = jax.jit(model.init)(
        jax.random.PRNGKey(args.seed), b0["images"], b0["question_ids"],
        b0["question_mask"], b0["answer_ids"], b0["answer_mask"],
        b0["weights"])["params"]
    cfg = _jax_train_config(args, args.synthetic)
    state, tx = jtrain.init_state(model, params, cfg,
                                  jax.random.PRNGKey(args.seed),
                                  masker=masker)
    step = jtrain.make_train_step(model, cfg, tx, masker=masker)
    for b in batches:  # steps 1, 2 (one epoch)
        state, _ = step(state, b)
    jckpt.save_checkpoint(str(root / "jax" / "ckpt_2"), state,
                          metadata={"step": 2})
    # the file's values, as a resume reads them back
    for b in batches:  # steps 3, 4: the resumed run's epoch from its start
        state, loss = step(state, b)
    if masker is not None:
        state = jtrain.make_threshold_reset(masker)(state, None)
    jckpt.save_checkpoint(str(root / "jax_resumed" / "ckpt_final"), state)
    return kind, root, float(loss)


@pytest.fixture(scope="module", params=["mask"])
def run(request, tmp_path_factory):
    return jax_runs(request.param, tmp_path_factory)


def _port_state(kind, root, path):
    """A port training state built as the CLI builds it, resumed from
    `path`; with its model, config and masker specs."""
    args = vqa_mplug.build_parser().parse_args(
        ARGV + KINDS[kind] + ["--output_dir", str(root / "p"), "--device",
                              "cpu"])
    config, _, model = vqa_mplug.build_model(args)
    masker = (vqa_mplug.build_masker(args, config) if args.mode == "mask"
              else None)
    cfg = vqa_mplug.train_config(args, 2)
    state = mplug_train.init_state(
        model, vqa_mplug.initial_params(args, config), cfg, "cpu",
        masker=masker, seed=args.seed, train=True)
    specs = masker.specs if masker is not None else None
    common.resume_any(str(path), state, "mplug", cfg, specs)
    return state, model, cfg, specs


def test_resume_is_bit_equal_at_load(run):
    kind, root, _ = run
    state, model, cfg, specs = _port_state(kind, root,
                                           root / "jax" / "ckpt_2")
    assert state.step == 2 and state.opt_state.count == 2
    assert_bit_equal(convert.jax_from_mplug_state(state, model, cfg, specs),
                     ckpt.load_jax_training_state(
                         str(root / "jax" / "ckpt_2")))


def test_two_steps_match_the_jax_continuation(run):
    kind, root, jloss = run
    summary = vqa_mplug.main(
        ARGV + KINDS[kind] + ["--do_train", "--device", "cpu",
                              "--output_dir", str(root / "port"),
                              "--resume_from", str(root / "jax" / "ckpt_2")])
    state = summary["state"]
    _, model, cfg, specs = _port_state(kind, root, root / "jax" / "ckpt_2")
    got = flat(convert.jax_from_mplug_state(state, model, cfg, specs))
    want = flat(ckpt.load_jax_training_state(
        str(root / "jax_resumed" / "ckpt_final")))
    start = flat(ckpt.load_jax_training_state(str(root / "jax" / "ckpt_2")))
    assert set(got) == set(want)
    np.testing.assert_allclose(summary["losses"][-1], jloss, rtol=1e-4)
    moved = 0
    for k, w in want.items():
        if k == "/rng" or w is None or isinstance(w, dict):
            continue
        a, b = _array(got[k]), _array(w)
        if "/mu/" in k or "/nu/" in k:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-3 * moment_scale(want, k),
                                       err_msg=k)
        elif k.endswith("count") or k == "/step":
            assert int(a) == int(b) == 4, k
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * 2,
                                       err_msg=k)
            moved += not np.array_equal(b, _array(start[k]))
    assert moved > 0


@pytest.mark.parametrize("run", ["mask"], indirect=True)
def test_port_written_state_loads_in_the_jax_package(run, tmp_path):
    kind, root, _ = run
    state, model, cfg, specs = _port_state(kind, root,
                                           root / "jax" / "ckpt_2")
    path = tmp_path / "ckpt_2"
    ckpt.save_jax_training_state(
        str(path), convert.jax_from_mplug_state(state, model, cfg, specs))
    args = jvqa_mplug.build_parser().parse_args(
        ARGV + ["--output_dir", str(tmp_path / "j")])
    config, _, jmodel = jvqa_mplug.build_model(args)
    masker, _ = jvqa_mplug.build_masker(args, config)
    b0 = synthetic_mplug_batch(batch_size=1, image_res=config.vit.image_res,
                               vocab_size=config.bert.vocab_size)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), b0["images"], b0["question_ids"],
        b0["question_mask"], b0["answer_ids"], b0["answer_mask"],
        b0["weights"])["params"]
    template, _ = jtrain.init_state(jmodel, params,
                                    jtrain.MPlugTrainConfig(mode="mask"),
                                    jax.random.PRNGKey(1), masker=masker)
    mine = jckpt.load_checkpoint(str(path), template)
    theirs = jckpt.load_checkpoint(str(root / "jax" / "ckpt_2"), template)
    a = jax.tree_util.tree_flatten_with_path(mine)[0]
    b = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype, p
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(p))
