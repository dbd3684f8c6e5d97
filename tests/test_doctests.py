"""Executable documentation: run every docstring example in the package
under stdlib doctest (parity with the reference's
xdoctest nox session, `noxfile.py:137-149`, without the extra dep).

Runs on the CPU backend via tests/conftest.py. Modules with no examples
pass trivially; adding a `>>>` example anywhere in `genjax_tpu` makes it
a test automatically.
"""

import doctest
import importlib
import pkgutil

import pytest

import genjax_tpu

# Modules whose import has side effects unsuitable for the doctest pass.
_SKIP: set[str] = set()


def _module_names():
    names = ["genjax_tpu"]
    for m in pkgutil.walk_packages(genjax_tpu.__path__, "genjax_tpu."):
        if m.name not in _SKIP:
            names.append(m.name)
    return sorted(names)


@pytest.mark.parametrize("modname", _module_names())
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    result = doctest.testmod(
        mod,
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
        verbose=False,
    )
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {modname}"


def test_examples_exist():
    """Guard against the doc pass silently becoming vacuous: the package
    must carry a healthy number of runnable examples."""
    total = 0
    finder = doctest.DocTestFinder()
    for name in _module_names():
        mod = importlib.import_module(name)
        for dt in finder.find(mod):
            total += len(dt.examples)
    assert total >= 100, f"only {total} doctest examples found"
