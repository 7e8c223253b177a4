"""The PyTorch port stands alone: no JAX in it, configs and weights cross over.

* ``import eventstreamgpt_tpu_torch`` (every module) works with JAX, PyYAML,
  pandas and pyarrow blocked; no module imports pandas or pyarrow at module
  level, and only `data.dl_cache`'s converter and parquet export (their
  bodies) import pyarrow at all. No module imports ``yaml`` or the root
  ``scripts`` package at any level (`utils.yaml_subset` reads the configs).
* An AST scan finds no ``jax``, ``flax`` or ``eventstreamgpt_tpu`` import in
  the port or in ``chip_smoke.py``, and no ``triton`` import.
* A JAX config's ``to_dict()`` round-trips through the port's config (and
  through JSON) to the same dictionary.
* `load_jax_params` raises on a flax leaf it cannot place and on a port
  parameter left unfilled.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import eventstreamgpt_tpu_torch
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig

from .test_generation import BASE_KWARGS, MEASUREMENT_CONFIGS, make_prompt

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "eventstreamgpt_tpu_torch"
FORBIDDEN = ("jax", "flax", "eventstreamgpt_tpu")
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(eventstreamgpt_tpu_torch.__path__, prefix="eventstreamgpt_tpu_torch.")
)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'eventstreamgpt_tpu', 'pandas', 'pyarrow', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {['eventstreamgpt_tpu_torch'] + MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize(
    "module",
    ["eventstreamgpt_tpu_torch.data.device_dataset", "eventstreamgpt_tpu_torch.data.torch_dataset",
     "eventstreamgpt_tpu_torch.training.pretrain", "eventstreamgpt_tpu_torch.tools.profile_train",
     "eventstreamgpt_tpu_torch.utils.enums", "eventstreamgpt_tpu_torch.serving.spec",
     "eventstreamgpt_tpu_torch.serving.router", "eventstreamgpt_tpu_torch.serving.fleet",
     "eventstreamgpt_tpu_torch.reliability", "eventstreamgpt_tpu_torch.reliability.serving_faults",
     "eventstreamgpt_tpu_torch.reliability.preemption", "eventstreamgpt_tpu_torch.tools.row_invariance",
     "eventstreamgpt_tpu_torch.data.dl_cache", "eventstreamgpt_tpu_torch.data.prefetch",
     "eventstreamgpt_tpu_torch.training.metrics", "eventstreamgpt_tpu_torch.training.generative_metrics",
     "eventstreamgpt_tpu_torch.reliability.faults", "eventstreamgpt_tpu_torch.reliability.integrity",
     "eventstreamgpt_tpu_torch.reliability.sentinel", "eventstreamgpt_tpu_torch.analysis.compile_guard",
     "eventstreamgpt_tpu_torch.models.fine_tuning_model", "eventstreamgpt_tpu_torch.training.embedding",
     "eventstreamgpt_tpu_torch.models.remat", "eventstreamgpt_tpu_torch.evaluation",
     "eventstreamgpt_tpu_torch.evaluation.general_generative_evaluation",
     "eventstreamgpt_tpu_torch.evaluation.mcf_evaluation", "eventstreamgpt_tpu_torch.utils.yaml_subset",
     "eventstreamgpt_tpu_torch.utils.config_tool", "eventstreamgpt_tpu_torch.scripts",
     "eventstreamgpt_tpu_torch.scripts.pretrain", "eventstreamgpt_tpu_torch.scripts.finetune",
     "eventstreamgpt_tpu_torch.scripts.zeroshot", "eventstreamgpt_tpu_torch.scripts.get_embeddings",
     "eventstreamgpt_tpu_torch.scripts.generate_trajectories", "eventstreamgpt_tpu_torch.scripts.launch_hp_sweep",
     "eventstreamgpt_tpu_torch.scripts.prepare_pretrain_subsets"],
)  # fmt: skip
def test_sweep_covers_the_resident_feed(module):
    """The resident feed, the chunked step, speculative decoding, the fleet's
    router, the serving fault plan, the row-invariance tool, the DL-cache
    reader, the prefetch thread, the metrics, the training reliability
    modules, the capture guard, the stream classifier, embedding
    extraction, remat, trajectory generation with the MCF evaluation, the
    YAML reader, the config tool and the entry points are in the blocked
    import sweep above."""
    assert module in MODULES


def test_generation_names_import_with_jax_blocked():
    """The cohort ``generate()`` API and the NA cache types import without JAX."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'eventstreamgpt_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from eventstreamgpt_tpu_torch.generation import (GenerationOutput, MaxLengthCriteria, StoppingCriteria,\n"
        "    StoppingCriteriaList, generate, sample_predictions)\n"
        "from eventstreamgpt_tpu_torch.generation.generation_utils import program_stats\n"
        "from eventstreamgpt_tpu_torch.models.transformer import NAPast\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            roots |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_imports(path):
    assert not (imported_roots(path) & set(FORBIDDEN)), path


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_triton_imports(path):
    """Every kernel of the port is CUDA C++ under ``csrc/``; nothing imports Triton."""
    assert "triton" not in imported_roots(path), path


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_yaml_or_root_scripts_imports(path):
    """The card's machine has no PyYAML (`utils.yaml_subset` reads the
    configs), and the port's entry points are its own (`scripts`), not the
    repository's root ``scripts`` package."""
    assert not (imported_roots(path) & {"yaml", "scripts"}), path


def module_level_roots(path: Path) -> set[str]:
    """The roots imported outside any function or class body."""
    roots = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_pandas_or_pyarrow_at_import(path):
    """The card's machine has neither: nothing imports them at module level,
    and only the converter and parquet export (``data/dl_cache.py``) import pyarrow at all."""
    assert not (module_level_roots(path) & {"pandas", "pyarrow"}), path
    if path.name != "dl_cache.py":
        assert not (imported_roots(path) & {"pandas", "pyarrow"}), path


def jax_config():
    return JaxConfig(
        measurement_configs=dict(MEASUREMENT_CONFIGS),
        **dict(BASE_KWARGS, TTE_generation_layer_type="log_normal_mixture", TTE_lognormal_generation_num_components=3),
    )


def test_config_round_trips():
    jd = jax_config().to_dict()
    assert StructuredTransformerConfig.from_dict(jd).to_dict() == jd
    via_json = json.loads(json.dumps(jd))
    port = StructuredTransformerConfig.from_dict(via_json)
    assert port.to_dict() == jd
    assert JaxConfig.from_dict(json.loads(json.dumps(port.to_dict()))).to_dict() == jd


@pytest.fixture(scope="module")
def flax_params():
    params = JaxModel(jax_config()).init(jax.random.PRNGKey(0), make_prompt(B=2, L=3))
    return jax.tree_util.tree_map(np.asarray, params)


def port_model():
    return CIPPTForGenerativeSequenceModeling(StructuredTransformerConfig.from_dict(jax_config().to_dict()))


def test_load_fills_every_parameter(flax_params):
    model = load_jax_params(port_model(), flax_params)
    q = flax_params["params"]["encoder"]["h0"]["attn"]["attention"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(model.encoder.h0.attn.attention.q_proj.weight.detach().numpy(), q.T)


def test_load_raises_on_missing_leaf(flax_params):
    params = jax.tree_util.tree_map(lambda x: x, flax_params)
    del params["params"]["output_layer"]["TTE_layer"]["proj"]["bias"]
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_params(port_model(), params)


def test_load_raises_on_extra_leaf(flax_params):
    params = jax.tree_util.tree_map(lambda x: x, flax_params)
    params["params"]["encoder"]["h0"]["mlp"]["c_gate"] = {"kernel": np.zeros((16, 16), np.float32)}
    with pytest.raises(ValueError, match="no port parameter"):
        load_jax_params(port_model(), params)


def test_load_raises_on_shape_mismatch(flax_params):
    params = jax.tree_util.tree_map(lambda x: x, flax_params)
    params["params"]["encoder"]["ln_f"]["scale"] = np.ones(17, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(port_model(), params)


def test_chip_smoke_defines_each_name_once():
    """A later phase's helper must not shadow an earlier phase's of the same name."""
    names = [
        t.id if isinstance(node, ast.Assign) else node.name
        for node in ast.parse((REPO / "chip_smoke.py").read_text()).body
        if isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.Assign))
        for t in (node.targets if isinstance(node, ast.Assign) else [node])
        if not isinstance(node, ast.Assign) or isinstance(t, ast.Name)
    ]
    assert len(names) == len(set(names)), sorted({n for n in names if names.count(n) > 1})
