"""The `--opt` table of the mPLUG resume (`core/convert.MPLUG_OPT_LAYOUTS`,
`mplug_opt_state_from_jax`): for every name of the JAX factory
(`OPTAX_OPTS + TIMM_OPTS`) and adahessian, the JAX package's
`make_two_group_adamw` (its `_inner_optimizer` in the two groups of
`multi_transform`; adahessian's own pair transformation) takes two
updates on a small two-group tree laid out as mask mode's trainables
(scores by flat key: a visual and a body group, bias leaves undecayed, a
128 x 130 leaf Adafactor factors, a 4-D leaf), its state goes through a
file written by the JAX package's `save_checkpoint`, is carried into the
port's optimizer state, and both sides take a third update from the same
gradients. The parameters after it agree within tests/test_torch_optim.py's
tolerance (rtol 1e-5, atol 1e-7; fp32). Names outside the table raise "not
yet ported".
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crvqa_tpu.core import checkpoint as jckpt
from crvqa_tpu.train import mplug_train as jtrain
from crvqa_tpu_torch.core import checkpoint as ckpt
from crvqa_tpu_torch.core import convert
from crvqa_tpu_torch.train import mplug_train as ttrain
from crvqa_tpu_torch.train.common import clip_by_global_norm_
from crvqa_tpu_torch.train.optim import OPTAX_OPTS, TIMM_OPTS
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

SHAPES = {"visual_encoder/a/kernel": (6, 5), "visual_encoder/a/bias": (5,),
          "b/kernel": (5, 4), "b/bias": (4,), "c/kernel": (128, 130),
          "d/kernel": (4, 3, 2, 2)}


def _config(opt):
    return dict(opt=opt, lr1=3e-2, lr2=1e-2, weight_decay=0.05,
                warmup_steps=2, total_steps=8, min_lr=1e-4, sched="cosine",
                max_grad_norm=2.0, opt_momentum=0.8)


def _jax_tree(arrays):
    return {"head": {}, "scores": {k: jnp.asarray(v)
                                   for k, v in arrays.items()}}


@pytest.mark.parametrize("opt", list(OPTAX_OPTS + TIMM_OPTS)
                         + ["adahessian"])
def test_third_update_after_the_carry_equals_jax(opt, tmp_path):
    second = opt == "adahessian"
    kw = _config(opt)
    jtx = jtrain.make_two_group_adamw(jtrain.MPlugTrainConfig(**kw))
    update = jax.jit(jtx.update)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    jp = _jax_tree(params)
    jst = jtx.init(jp)

    def grads():
        return {k: (rng.normal(size=s) * 1.5).astype(np.float32)
                for k, s in SHAPES.items()}

    def jax_step(jp, jst, g, h):
        inp = (_jax_tree(g), _jax_tree(h)) if second else _jax_tree(g)
        upd, jst = update(inp, jst, jp)
        return optax.apply_updates(jp, upd), jst

    for _ in range(2):
        g = grads()
        jp, jst = jax_step(jp, jst, g, grads())
    path = str(tmp_path / "ckpt_2")
    jckpt.save_checkpoint(path, {"opt_state": jst})
    carried = ckpt.load_msgpack(path)["opt_state"]

    cfg = ttrain.MPlugTrainConfig(**kw)
    tp = {f"scores/{k}": torch.from_numpy(np.array(v, copy=True))
          for k, v in jp["scores"].items()}
    ttx = ttrain.make_two_group_adamw(cfg, tp)
    tst = ttx.init(tp)
    convert.mplug_opt_state_from_jax(tst, carried, opt, "mask")
    assert tst.count == 2

    g, h = grads(), grads()
    jp, _ = jax_step(jp, jst, g, h)
    tg = {f"scores/{k}": torch.from_numpy(v.copy()) for k, v in g.items()}
    if second:
        th = {f"scores/{k}": torch.from_numpy(v.copy())
              for k, v in h.items()}
        ttx.step(tp, (tg, th), tst)
    else:
        clip_by_global_norm_(list(tg.values()), cfg.max_grad_norm)
        ttx.step(tp, tg, tst)
    for k in SHAPES:
        np.testing.assert_allclose(tp[f"scores/{k}"].numpy(),
                                   np.asarray(jp["scores"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_a_name_outside_the_table_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="--opt adabelief.*not yet"):
        convert.mplug_opt_layout("adabelief")
    assert convert.mplug_opt_layout("lookahead_adamw") is \
        convert.mplug_opt_layout("adamw")
