"""Rebinding a test module of the JAX package onto the port.

:func:`ported_module` gives a test module's globals with every name it
imports from ``calfkit_tpu`` bound to the port's name of the same module,
and its own functions and classes (the test classes among them) rebuilt
over those globals; imports inside a rebuilt body resolve ``calfkit_tpu.*``
to ``calfkit_tpu_torch.*`` (and ``pydantic``'s ``ValidationError`` to the
port's wire codec's, which the port raises; its other names stay
pydantic's), and string constants naming a
``calfkit_tpu.`` module (a ``monkeypatch`` target, a logger) name the
port's.  Names a suite takes from ``tests._chaos`` (the JAX package's
chaos harness, re-exported) are bound to their port twins of the same
module and qualified name in ``calfkit_tpu_torch.sim``, at module scope and
inside test bodies alike.  A name whose port module or attribute does not
exist yet is bound to a stand-in that raises when it is used, so a suite
that imports an unported module still rebinds and its other cases run.
``overrides`` replace further module-scope names before the suite's own
functions and classes are rebuilt (a ``variant`` keeps each set apart).
The test files ``tests/test_torch_mesh.py``, ``tests/test_torch_transports.py``
and ``tests/test_torch_fleet.py`` run the reference's suites through it.
"""

from __future__ import annotations

import ast
import builtins
import functools
import importlib
import inspect
import types

REF, PORT = "calfkit_tpu", "calfkit_tpu_torch"
CHAOS = "tests._chaos"  # the JAX package's harness, re-exported for its suites


def _port_name(name: str) -> str:
    if name == REF or name.startswith(REF + "."):
        return PORT + name[len(REF):]
    if name == "pydantic":  # the port's wire codec stands where pydantic stood
        return f"{PORT}.models._wire"
    return name


@functools.cache
def _pydantic_twin() -> types.ModuleType:
    """``pydantic`` as a suite's body imports it: its ``ValidationError`` is
    the port's (what the port raises), every other name pydantic's own (a
    user's ``BaseModel`` works on the port through the model protocol)."""
    import pydantic

    twin = types.ModuleType("pydantic")
    twin.__getattr__ = lambda name: getattr(pydantic, name)
    twin.ValidationError = importlib.import_module(f"{PORT}.models._wire").ValidationError
    return twin


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if name == CHAOS and level == 0 and fromlist:
        return _chaos_twins()
    if name == "pydantic" and level == 0:
        try:
            return _pydantic_twin()
        except ImportError:
            pass
    return builtins.__import__(_port_name(name) if level == 0 else name,
                               globals, locals, fromlist, level)


_PORT_BUILTINS = {**vars(builtins), "__import__": _port_import}


def _port_code(code: types.CodeType) -> types.CodeType:
    """``code`` with every string constant naming a ``calfkit_tpu.`` module
    naming the port's, nested code objects included."""
    consts = tuple(
        _port_code(c) if isinstance(c, types.CodeType)
        else _port_name(c) if isinstance(c, str) and c.startswith(REF + ".")
        else c
        for c in code.co_consts
    )
    return code.replace(co_consts=consts)


def _rebind_function(fn: types.FunctionType, g: dict) -> types.FunctionType:
    out = types.FunctionType(_port_code(fn.__code__), g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    out.__kwdefaults__ = fn.__kwdefaults__
    out.__qualname__ = fn.__qualname__
    out.__dict__.update(fn.__dict__)  # pytest marks
    return out


def _rebind_member(value, g: dict):
    if isinstance(value, types.FunctionType):
        return _rebind_function(value, g)
    if isinstance(value, (staticmethod, classmethod)):
        return type(value)(_rebind_member(value.__func__, g))
    if isinstance(value, property):
        return property(*(_rebind_member(f, g) if f else None
                          for f in (value.fget, value.fset, value.fdel)))
    return value


def _port_twin(obj):
    """The port's object of the same module and qualified name."""
    module = importlib.import_module(_port_name(obj.__module__))
    for part in obj.__qualname__.split("."):
        module = getattr(module, part)
    return module


class Absent:
    """Stands for a name whose port module or attribute does not exist yet:
    calling it, or reading an attribute off it, raises."""

    def __init__(self, where: str):
        self._where = where

    def _missing(self):
        return ModuleNotFoundError(f"{self._where} is not ported to {PORT}")

    def __call__(self, *args, **kwargs):
        raise self._missing()

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._missing()


@functools.cache
def _chaos_twins() -> types.ModuleType:
    """``tests._chaos`` with every name bound to its port twin."""
    twins = types.ModuleType(CHAOS)
    for name, obj in vars(importlib.import_module(CHAOS)).items():
        if getattr(obj, "__module__", "").split(".")[0] == REF:
            setattr(twins, name, _port_twin(obj))
    return twins


def _port_value(source: str, attr: "str | None"):
    """The port's module ``source`` names (``tests._chaos``: its twins), or
    its attribute ``attr``; an :class:`Absent` where either is missing."""
    if source == CHAOS:
        return _chaos_twins() if attr is None else getattr(_chaos_twins(), attr)
    try:
        target = importlib.import_module(_port_name(source))
    except ModuleNotFoundError:
        return Absent(_port_name(source))
    if attr is None:
        return target
    value = getattr(target, attr, Absent)
    return Absent(f"{_port_name(source)}.{attr}") if value is Absent else value


def _rebind_class(cls: type, g: dict, module_name: str) -> type:
    bases = tuple(
        g[b.__name__] if b.__module__ == module_name
        else _port_twin(b) if b.__module__.split(".")[0] == REF
        else b
        for b in cls.__bases__
    )
    body = {k: _rebind_member(v, g) for k, v in vars(cls).items()
            if k not in ("__dict__", "__weakref__")}
    new = type(cls)(cls.__name__, bases, body)
    # a method calling super() holds the class in its __class__ cell: the
    # rebuilt class's methods must hold the rebuilt class
    for name, value in body.items():
        fn = value.__func__ if isinstance(value, (staticmethod, classmethod)) else value
        if isinstance(fn, types.FunctionType) and "__class__" in fn.__code__.co_freevars:
            cells = tuple(types.CellType(new) if free == "__class__" else cell
                          for free, cell in zip(fn.__code__.co_freevars, fn.__closure__))
            out = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                                     fn.__defaults__, cells)
            out.__kwdefaults__, out.__qualname__ = fn.__kwdefaults__, fn.__qualname__
            out.__dict__.update(fn.__dict__)
            setattr(new, name, type(value)(out) if fn is not value else out)
    return new


def _imported_names(module) -> "dict[str, tuple[str, str | None]]":
    """Module-scope ``calfkit_tpu`` and ``tests._chaos`` imports: bound name
    -> (module, attribute)."""
    out = {}
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0 \
                and (node.module.split(".")[0] == REF or node.module == CHAOS):
            for alias in node.names:
                out[alias.asname or alias.name] = (node.module, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == REF:
                    out[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else REF, None)
    return out


_PORTED: dict = {}


def ported_module(module_name: str, *, variant: str = "",
                  overrides: "dict | None" = None) -> dict:
    """The suite module's globals with its ``calfkit_tpu`` names bound to the
    port's, ``overrides`` applied, and its own functions and classes rebuilt
    over them."""
    key = (module_name, variant)
    if key in _PORTED:
        return _PORTED[key]
    module = importlib.import_module(module_name)
    g = dict(vars(module))
    g["__builtins__"] = _PORT_BUILTINS
    imported = _imported_names(module)
    assert imported, module_name
    for name, (source, attr) in imported.items():
        g[name] = _port_value(source, attr)
    g.update(overrides or {})
    own = [(name, obj) for name, obj in vars(module).items()
           if getattr(obj, "__module__", None) == module_name
           and isinstance(obj, (types.FunctionType, type))
           and name not in (overrides or {})]
    # classes in definition order, so a base is rebuilt before its subclasses
    own.sort(key=lambda item: inspect.getsourcelines(item[1])[1])
    for name, obj in own:
        g[name] = (_rebind_function(obj, g) if isinstance(obj, types.FunctionType)
                   else _rebind_class(obj, g, module_name))
    _PORTED[key] = g
    return g
