"""The port stands alone: `crvqa_tpu_torch`, `chip_smoke.py`,
`chip_times.py` and the multi-process tests' rank bodies
(tests/torch_parallel_worker.py) import neither JAX (jax, flax, optax), nor the msgpack and
ml_dtypes packages behind flax's checkpoints (the port reads and writes
them with its own codec), nor anything of the JAX package."""
import ast
import pathlib
import pkgutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "crvqa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
             "crvqa_tpu")


def _port_modules():
    import crvqa_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        crvqa_tpu_torch.__path__, "crvqa_tpu_torch."))


def test_every_module_is_found():
    mods = _port_modules()
    for expected in ("crvqa_tpu_torch.ops.fused_attention",
                     "crvqa_tpu_torch.ops.kthvalue",
                     "crvqa_tpu_torch.models.lxmert",
                     "crvqa_tpu_torch.cli.serve_vqa",
                     "crvqa_tpu_torch.cli.prune_debias_vqa",
                     "crvqa_tpu_torch.native.feature_store",
                     "crvqa_tpu_torch.masking.binarizers",
                     "crvqa_tpu_torch.masking.masker",
                     "crvqa_tpu_torch.masking.sparsity_control",
                     "crvqa_tpu_torch.losses.vqa_losses",
                     "crvqa_tpu_torch.train.common",
                     "crvqa_tpu_torch.train.stage2",
                     "crvqa_tpu_torch.train.evaluation",
                     "crvqa_tpu_torch.data.synthetic",
                     "crvqa_tpu_torch.data.prefetch",
                     "crvqa_tpu_torch.core.checkpoint",
                     "crvqa_tpu_torch.core.convert",
                     "crvqa_tpu_torch.ops.midseq_attention",
                     "crvqa_tpu_torch.models.mplug.vit",
                     "crvqa_tpu_torch.models.mplug.bert",
                     "crvqa_tpu_torch.models.mplug.mplug",
                     "crvqa_tpu_torch.models.mplug.generator",
                     "crvqa_tpu_torch.masking.mplug_specs",
                     "crvqa_tpu_torch.data.augment",
                     "crvqa_tpu_torch.data.mplug_data",
                     "crvqa_tpu_torch.train.mplug_train",
                     "crvqa_tpu_torch.cli.vqa_mplug",
                     "crvqa_tpu_torch.cli.serve_mplug",
                     "crvqa_tpu_torch.ops.masked_matmul",
                     "crvqa_tpu_torch.ops.structured_matmul",
                     "crvqa_tpu_torch.masking.compaction",
                     "crvqa_tpu_torch.train.stage1",
                     "crvqa_tpu_torch.cli.run_vqa_stage1",
                     "crvqa_tpu_torch.cli.run_vqa_stage3",
                     "crvqa_tpu_torch.models.visualbert",
                     "crvqa_tpu_torch.cli.prune_debias_vqa_visualbert",
                     "crvqa_tpu_torch.core.msgpack",
                     "crvqa_tpu_torch.data.vqavs",
                     "crvqa_tpu_torch.data.preprocess",
                     "crvqa_tpu_torch.cli.prune_debias_vqavs",
                     "crvqa_tpu_torch.evals",
                     "crvqa_tpu_torch.evals.vqa_eval",
                     "crvqa_tpu_torch.evals.scoring",
                     "crvqa_tpu_torch.evals.compare_mask",
                     "crvqa_tpu_torch.native.wordpiece",
                     "crvqa_tpu_torch.data.build_vqacp_ocr",
                     "crvqa_tpu_torch.parallel",
                     "crvqa_tpu_torch.parallel.mesh",
                     "crvqa_tpu_torch.parallel.zero",
                     "crvqa_tpu_torch.parallel.dryrun"):
        assert expected in mods


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [REPO / "chip_smoke.py", REPO / "chip_times.py",
                            REPO / "tests" / "torch_parallel_worker.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"
