"""The top-level import surface of the port: ``tests/test_public_api.py``
rebound onto ``calfkit_tpu_torch`` (every lazy export resolves, the
vocabulary the migration guide promises is present with
``TorchLocalModelClient`` where the JAX package has ``JaxLocalModelClient``,
an unknown name raises ``AttributeError``, and ``import calfkit_tpu_torch``
imports none of ``calfkit_tpu_torch.{inference, engine, nodes, client,
providers, mesh}``), and the port's lazy names against the JAX package's."""

from __future__ import annotations

import importlib

import pytest

import calfkit_tpu
import calfkit_tpu_torch
from tests._torch_rebind import ported_module

# the JAX package's local client and the port's
LOCAL = {"JaxLocalModelClient": "TorchLocalModelClient"}
CASES = [name for name in vars(importlib.import_module("tests.test_public_api").TestPublicSurface)
         if name.startswith("test_")]


def _suite() -> type:
    # every ``calfkit_tpu`` in the suite's strings (the subprocess's code)
    # names the port, and the JAX package's local client the port's
    return ported_module("tests.test_public_api", sources=True,
                         constants=LOCAL)["TestPublicSurface"]


def test_the_contract_is_the_reference_suite():
    assert CASES == ["test_every_lazy_export_resolves", "test_core_vocabulary_present",
                     "test_unknown_name_raises_attribute_error", "test_import_is_lazy"]


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_the_port(name):
    getattr(_suite()(), name)()


def test_lazy_names_equal_the_reference():
    """The port's lazy names are the JAX package's, its local client
    renamed, and each resolves from a module of the port."""
    assert set(calfkit_tpu_torch._LAZY) == {LOCAL.get(n, n) for n in calfkit_tpu._LAZY}
    for name, module in calfkit_tpu_torch._LAZY.items():
        assert module.split(".")[0] == "calfkit_tpu_torch", (name, module)
        assert getattr(importlib.import_module(module), name) is getattr(calfkit_tpu_torch, name)
