"""The port's checkpoint directory against the JAX package's, on the CPU.

* The port's `save_pretrained` / `load_pretrained` round trip is bit for bit
  (CI and NA models), and its ``config.json`` loads in both packages to equal
  dictionaries, as JAX's does.
* A checkpoint JAX writes (orbax) and reads back, its tree taken as numpy
  arrays, goes through `convert.checkpoint_from_jax` into the port's format;
  the port's `load_pretrained` then gives JAX's forward at rtol 1e-5, atol
  1e-6, and `convert.export_params` gives back JAX's tree exactly.
* Loading is strict: a missing tensor, an unexpected one, or one of another
  shape or dtype raises ``ValueError`` naming it.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from eventstreamgpt_tpu.models.config import StructuredTransformerConfig as JaxConfig
from eventstreamgpt_tpu.training import load_pretrained as jax_load_pretrained
from eventstreamgpt_tpu.training import save_pretrained as jax_save_pretrained
from eventstreamgpt_tpu_torch.convert import checkpoint_from_jax, export_params, init_params_from_seed
from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.training import PRETRAINED_WEIGHTS_DIR, build_model, load_pretrained, save_pretrained

from .test_torch_engine import to_torch
from .test_torch_model import flat_preds
from .test_torch_service import build_ci

FORWARD = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(precision="fp32", sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64)


@pytest.fixture(scope="module")
def ci():
    return build_ci()


@pytest.mark.parametrize("na", [False, True], ids=["ci", "na"])
def test_round_trip_is_bitwise(tmp_path, na):
    config = serving_config(**SMALL, **(NA_OVERRIDES if na else {}))
    model = init_params_from_seed(build_model(config), seed=3)
    weights = save_pretrained(tmp_path, model, config)
    assert weights == tmp_path / PRETRAINED_WEIGHTS_DIR
    loaded, cfg = load_pretrained(tmp_path, device="cpu")
    assert type(loaded) is type(model) and cfg.to_dict() == config.to_dict()
    want, got = model.state_dict(), loaded.state_dict()
    assert list(want) == list(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # Into a given model, too; with no device, the CUDA device (raises without one).
    again, _ = load_pretrained(tmp_path, model=build_model(config), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), want.values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pretrained(tmp_path)


def test_config_json_loads_in_both_packages(tmp_path, ci):
    jcfg, _, params, tcfg, tmodel, _ = ci
    save_pretrained(tmp_path / "port", tmodel, tcfg)
    jax_save_pretrained(tmp_path / "jax", params, config=jcfg)
    for d in ("port", "jax"):
        fp = tmp_path / d / "config.json"
        assert JaxConfig.from_json_file(fp).to_dict() == StructuredTransformerConfig.from_json_file(fp).to_dict()
    assert StructuredTransformerConfig.from_json_file(tmp_path / "jax" / "config.json").to_dict() == tcfg.to_dict()


def test_jax_checkpoint_converts_to_the_port_and_back(tmp_path, ci):
    jcfg, jmodel, params, _, _, prompt = ci
    jax_save_pretrained(tmp_path / "jax", params, config=jcfg)
    jparams, jcfg2 = jax_load_pretrained(tmp_path / "jax")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    checkpoint_from_jax(tree, jcfg2, tmp_path / "port")
    model, config = load_pretrained(tmp_path / "port", device="cpu")
    assert config.to_dict() == jcfg.to_dict()
    want = flat_preds(jax.jit(functools.partial(jmodel.apply, is_generation=True))(jparams, prompt).preds)
    with torch.no_grad():
        got = flat_preds(model(to_torch(prompt), is_generation=True).preds)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FORWARD)
    # The reverse direction gives JAX's tree back, leaf for leaf.
    back = jax.tree_util.tree_leaves_with_path(export_params(model))
    orig = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, params)))
    assert len(back) == len(orig)
    for path, leaf in back:
        np.testing.assert_array_equal(leaf, orig[path], err_msg=jax.tree_util.keystr(path))


STRICT_CASES = {
    "missing": (lambda sd: sd.pop("encoder.ln_f.bias"), r"missing \['encoder.ln_f.bias'\]"),
    "unexpected": (lambda sd: sd.update(extra=torch.zeros(2)), r"unexpected \['extra'\]"),
    "shape": (lambda sd: sd.update({"encoder.ln_f.bias": torch.zeros(3)}), r"encoder.ln_f.bias is \(3,\)"),
    "dtype": (lambda sd: sd.update({"encoder.ln_f.bias": sd["encoder.ln_f.bias"].double()}),
              "encoder.ln_f.bias is .*float64"),
}  # fmt: skip


@pytest.mark.parametrize("case", sorted(STRICT_CASES))
def test_loading_is_strict(tmp_path, ci, case):
    _, _, _, tcfg, tmodel, _ = ci
    edit, match = STRICT_CASES[case]
    save_pretrained(tmp_path, tmodel, tcfg)
    fp = tmp_path / PRETRAINED_WEIGHTS_DIR / "model.pt"
    sd = torch.load(fp, weights_only=True)
    edit(sd)
    torch.save(sd, fp)
    with pytest.raises(ValueError, match=match):
        load_pretrained(tmp_path, device="cpu")
