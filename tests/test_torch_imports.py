"""The PyTorch port stands alone: importing it loads no jax, and no file
of it imports jax or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_port_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) > 20, mods\n"
        "for m in ('kernels.paged_attention_quant', 'kernels.ngram_match',\n"
        "          'core.drafters.ngram', 'kernels.ragged_attention',\n"
        "          'core.policies.adaedl', 'core.policies.goodput',\n"
        "          'core.policies.slo', 'core.drafters.self_draft',\n"
        "          'training.train', 'training.optimizer', 'training.data',\n"
        "          'training.checkpoint', 'launch.train', 'models.moe',\n"
        "          'configs.granite_moe_3b_a800m', 'configs.mixtral_8x22b',\n"
        "          'configs.granite_8b', 'configs.qwen2_5_32b',\n"
        "          'configs.qwen3_32b', 'configs.paper_llama_pair',\n"
        "          'configs.paper_gemma_pair', 'serving.frontend',\n"
        "          'serving.server', 'launch.serve', 'models.ssm',\n"
        "          'models.rglru', 'configs.mamba2_130m',\n"
        "          'configs.recurrentgemma_2b', 'models.flash',\n"
        "          'configs.qwen2_vl_2b', 'configs.seamless_m4t_medium',\n"
        "          'launch.mesh', 'launch.sharding', 'launch.steps',\n"
        "          'launch.op_cost', 'launch.dryrun', 'core.dtensor_ops',\n"
        "          'core.cost_hooks', 'kernels.shape_only', 'core.tp',\n"
        "          'workloads', 'serving.loadgen', 'examples.quickstart',\n"
        "          'examples.train_draft_model', 'examples.serve_dynamic_sl',\n"
        "          'examples.stream_serving',\n"
        "          'examples.low_acceptance_regime'):\n"
        "    assert 'repro_torch.' + m in mods, m\n"
        "import torch.distributed as dist\n"
        "assert 'torch.testing._internal.distributed.fake_pg' not in "
        "sys.modules\n"
        "assert not dist.is_initialized()\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


def test_fake_process_group_only_inside_functions():
    """The dry run's fake process group (``fake_pg``) is imported inside
    the functions that make one (``launch/mesh.py``), never at a module's
    top level."""
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any("fake_pg" in (n or "") for n in names), f


@pytest.mark.parametrize("layer", ["core", "models", "kernels", "training",
                                   "serving"])
def test_layers_below_launch_import_nothing_of_it(layer):
    """Only ``launch/`` knows meshes, rules and the cost counter: the
    layers below it reach the dry run through ``core/cost_hooks.py`` and
    ``core/dtensor_ops.py``, and import no module of ``launch/``, not
    even inside a function."""
    files = sorted((PORT / layer).rglob("*.py"))
    assert files
    for f in files:
        for mod in _imported_modules(f):
            assert not mod.startswith("repro_torch.launch"), (f, mod)


@pytest.mark.parametrize("entry", ["engine", "init_params",
                                   "init_round_state", "workloads.serve"])
def test_entry_points_default_to_cuda(entry):
    """Without device='cpu' the entry points ask for CUDA, and on a
    machine without it they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.core.config import ServingConfig, SpecDecodeConfig
    from repro_torch.core.spec_decode import init_round_state
    from repro_torch.models.weights import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "init_params":
            init_params(cfg, seed=0)
        elif entry == "init_round_state":
            init_round_state(cfg, cfg, SpecDecodeConfig(), 2, 64, paged=(8, 16))
        elif entry == "workloads.serve":
            from repro_torch import workloads
            p = init_params(cfg, seed=0, device="cpu")
            workloads.serve(cfg, cfg, p, p, [[1, 2, 3]], max_new=2)
        else:
            p = init_params(cfg, seed=0, device="cpu")
            ServingEngine(p, cfg, p, cfg, SpecDecodeConfig(),
                          ServingConfig(max_batch_size=2, max_seq_len=64))
