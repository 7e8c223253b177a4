"""The port's ``Examples:`` blocks run, module by module, as the JAX
package's do (``tests/test_doctests.py``)."""

import doctest
import importlib
import pkgutil

import pytest

import eventstreamgpt_tpu_torch

MODULES = sorted(
    ["eventstreamgpt_tpu_torch"]
    + [m.name for m in pkgutil.walk_packages(eventstreamgpt_tpu_torch.__path__, prefix="eventstreamgpt_tpu_torch.")]
)


@pytest.mark.parametrize("module_name", MODULES)
def test_doctests(module_name):
    mod = importlib.import_module(module_name)
    results = doctest.testmod(mod, optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failure(s) in {module_name}"
