"""The port's multi-device runtime (crvqa_tpu_torch/parallel/): its units
over 2 gloo ranks (one spawn: tests/torch_parallel_worker.py `units`, the
counterpart of the JAX package's tests/mp_worker.py `run_units`), the
mesh's errors, the refusal of every launch that would leave a rank
training alone, the attention keep masks with row and head offsets, and
`dryrun_multichip(2)` in a fresh process."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crvqa_tpu_torch.cli import common, prune_debias_vqa
from crvqa_tpu_torch.ops import fused_attention as fa
from crvqa_tpu_torch.ops import midseq_attention as ms
from crvqa_tpu_torch.parallel import mesh as pm
from crvqa_tpu_torch.parallel.dryrun import free_port
from crvqa_tpu_torch.parallel.zero import partition
from tests.torch_parallel_worker import REPO, TIMEOUT_S, rank_env, run_ranks


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    out = tmp_path_factory.mktemp("units")
    port = free_port()
    run_ranks(lambda r: [sys.executable, "-m", "tests.torch_parallel_worker",
                         "units", str(r), "2", str(port), str(out)], 2)
    return out, [json.load(open(out / f"units_{r}.json")) for r in (0, 1)]


def test_process_local_slice_keeps_the_data_block(units):
    _, (r0, r1) = units
    assert (r0["data_index"], r1["data_index"]) == (0, 1)
    assert r0["rows"] == [0, 3, 6, 9] and r1["rows"] == [12, 15, 18, 21]
    assert r0["scalar"] == r1["scalar"] == 5
    for r in (r0, r1):
        assert "not divisible by process_count 2" in r["odd_batch"]


def test_gathers_round_trip_in_data_index_order(units):
    _, ranks = units
    want = np.arange(24).reshape(8, 3).tolist()
    for r in ranks:
        assert r["gathered"] == want
        assert r["gathered_local"] == [0, 1, 2, 10, 11, 12]
        assert r["gathered_bool"] == [True, True, False, True]
        assert r["mean"] == [1.5, 1.5, 1.5]


def test_exactly_one_rank_writes(units):
    out, _ = units
    assert sorted(os.listdir(out / "rank0")) == ["tree", "tree.meta.json"]
    assert not (out / "rank1").exists()


def test_preemption_consensus_when_only_rank_1_is_signalled(units):
    _, ranks = units
    for r in ranks:
        assert r["stopped"] is True
        assert r["saved"] == [["ckpt_3", True]]


def test_zero_deals_whole_leaves_and_gathers_the_whole_state(units):
    _, (r0, r1) = units
    # greedy by bytes onto the lighter rank: d (25) -> 0, a (12) -> 1,
    # b (8) -> 1 (20 < 25), c (2) -> 1 (20 < 25)
    assert r0["owned"] == ["d"] and r1["owned"] == ["a", "b", "c"]
    for r in (r0, r1):
        assert r["full_order"] == ["a", "b", "c", "d"]
        assert r["full_abs"] == ["a", "b", "c", "d"]
        for k, v in r["full_mu"].items():
            assert v == [float(ord(k))] * len(v), k
    assert partition({"a": 12, "b": 8, "c": 2, "d": 25}, 2) == {
        "d": 0, "a": 1, "b": 1, "c": 1}


@pytest.mark.parametrize("data,model,world,ok", [
    (-1, 1, 4, (4, 1)), (-1, 2, 4, (2, 2)), (2, 2, 4, (2, 2)),
    (2, 1, 1, None), (-1, 2, 1, None), (3, 1, 4, None)])
def test_mesh_config_resolve(data, model, world, ok):
    cfg = pm.MeshConfig(data=data, model=model)
    if ok is not None:
        assert cfg.resolve(world) == ok
    else:
        with pytest.raises(ValueError, match="does not cover"):
            cfg.resolve(world)


def test_world_one_mesh_is_the_identity():
    mesh = pm.make_mesh(pm.MeshConfig(), torch.device("cpu"))
    assert (mesh.rank, mesh.data, mesh.model, mesh.distributed) == (
        0, 1, 1, False)
    batch = {"x": np.arange(6)}
    assert pm.process_local_slice(batch, mesh) is batch
    assert pm.host_all_gather_local(np.arange(3), mesh).tolist() == [0, 1, 2]
    assert pm.any_process(True, mesh) and not pm.any_process(False, mesh)


@pytest.mark.parametrize("extra,env,err", [
    (["--multihost", "true"], {}, "torchrun"),
    (["--multihost", "true", "--coordinator_address", "127.0.0.1:1"], {},
     "--num_processes"),
    (["--multihost", "true", "--coordinator_address", "127.0.0.1:1",
      "--num_processes", "2", "--process_id", "2"], {}, "outside a world"),
    ([], {"WORLD_SIZE": "2"}, "without --multihost"),
    (["--mesh_data", "2"], {}, "does not cover 1 devices")],
    ids=["no-world", "no-size", "bad-rank", "env-without-flag", "mesh"])
def test_launches_that_would_train_alone_raise(tmp_path, monkeypatch, extra,
                                               env, err):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=err):
        prune_debias_vqa.main(["--output_dir", str(tmp_path), "--tiny",
                               "--device", "cpu", "--synthetic", "8",
                               *extra])


def test_an_unreachable_coordinator_raises():
    """A rank whose coordinator never answers raises at the timeout
    instead of training alone."""
    code = ("import datetime\n"
            "from crvqa_tpu_torch.parallel import mesh\n"
            f"mesh.initialize_multihost('127.0.0.1:{free_port()}', 2, 1, "
            "'cpu', timeout=datetime.timedelta(seconds=3))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=rank_env(), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode != 0


# --------------------------------------------- keep masks with offsets

@pytest.mark.parametrize("row0,head0", [(0, 0), (3, 0), (0, 2), (5, 1)])
def test_short_keep_mask_offsets_slice_the_global_mask(row0, head0):
    b, h, sq, sk, rate, seed = 8, 4, 5, 7, 0.3, -12345
    whole = fa._drop_factor(b, sq, h, sk, rate, seed, "cpu")
    part = fa._drop_factor(3, sq, 2, sk, rate, seed, "cpu", row0, head0)
    torch.testing.assert_close(
        part, whole[row0:row0 + 3, head0:head0 + 2], rtol=0, atol=0)


@pytest.mark.parametrize("row0,head0", [(0, 0), (2, 0), (0, 2), (4, 1)])
def test_midseq_keep_mask_offsets_slice_the_global_mask(row0, head0):
    b, h, sq, sk, rate, seed = 8, 4, 6, 9, 0.2, 777
    whole = ms.drop_factor(b, h, sq, sk, rate, seed, "cpu")
    part = ms.drop_factor(3, 2, sq, sk, rate, seed, "cpu", row0, head0)
    torch.testing.assert_close(
        part, whole[row0:row0 + 3, head0:head0 + 2], rtol=0, atol=0)


def test_attention_with_offsets_is_the_global_attention_sliced():
    """The plain forwards with dropout: a block of rows and heads computed
    alone with its offsets equals that block of the whole batch's."""
    g = torch.Generator().manual_seed(0)
    b, h, d, sq, sk = 4, 4, 16, 5, 6
    q = torch.randn(b, sq, h * d, generator=g)
    k = torch.randn(b, sk, h * d, generator=g)
    v = torch.randn(b, sk, h * d, generator=g)
    bias = torch.zeros(b, sk)
    for fn in (fa.fused_attention, ms.midseq_attention):
        whole = fn(q, k, v, bias, h, d, 0.4, 99)
        rows, cols = slice(2, 4), slice(d, 3 * d)  # rows 2-3, heads 1-2
        part = fn(q[rows, :, cols].contiguous(), k[rows, :, cols].contiguous(),
                  v[rows, :, cols].contiguous(), bias[rows], 2, d, 0.4, 99,
                  row0=2, head0=1)
        torch.testing.assert_close(part, whole[rows, :, cols], rtol=1e-6,
                                   atol=1e-6)


def test_dryrun_multichip_two_ranks_in_a_fresh_process():
    proc = subprocess.run(
        [sys.executable, "-c",
         "from crvqa_tpu_torch.parallel.dryrun import dryrun_multichip; "
         "dryrun_multichip(2); print('dryrun ok')"],
        cwd=REPO, env=rank_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "dryrun ok" in proc.stdout


def test_mesh_flags_defaults_are_the_single_process_run():
    args = prune_debias_vqa.build_parser().parse_args(["--output_dir", "x"])
    assert {k: getattr(args, k) for k in common.MESH_FLAGS} == \
        common.MESH_FLAGS
