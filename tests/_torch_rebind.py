"""Rebinding a test module of the JAX package onto the port.

:func:`ported_module` gives a test module's globals with every name it
imports from ``calfkit_tpu`` bound to the port's name of the same module,
and its own functions and classes (the test classes among them) rebuilt
over those globals; imports inside a rebuilt body resolve ``calfkit_tpu.*``
to ``calfkit_tpu_torch.*`` (and ``pydantic`` to the port's wire codec,
whose ``ValidationError`` the port raises), and string constants naming a
``calfkit_tpu.`` module (a ``monkeypatch`` target, a logger) name the
port's.  The test files ``tests/test_torch_mesh.py`` and
``tests/test_torch_transports.py`` run the reference's suites through it.
"""

from __future__ import annotations

import ast
import builtins
import importlib
import inspect
import types

REF, PORT = "calfkit_tpu", "calfkit_tpu_torch"


def _port_name(name: str) -> str:
    if name == REF or name.startswith(REF + "."):
        return PORT + name[len(REF):]
    if name == "pydantic":  # the port's wire codec stands where pydantic stood
        return f"{PORT}.models._wire"
    return name


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
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


def _rebind_class(cls: type, g: dict, module_name: str) -> type:
    bases = tuple(
        g[b.__name__] if b.__module__ == module_name
        else _port_twin(b) if b.__module__.split(".")[0] == REF
        else b
        for b in cls.__bases__
    )
    body = {k: _rebind_member(v, g) for k, v in vars(cls).items()
            if k not in ("__dict__", "__weakref__")}
    return type(cls)(cls.__name__, bases, body)


def _imported_names(module) -> "dict[str, tuple[str, str | None]]":
    """Module-scope ``calfkit_tpu`` imports: bound name -> (module, attribute)."""
    out = {}
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0 \
                and node.module.split(".")[0] == REF:
            for alias in node.names:
                out[alias.asname or alias.name] = (node.module, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == REF:
                    out[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else REF, None)
    return out


_PORTED: dict = {}


def ported_module(module_name: str) -> dict:
    """The suite module's globals with its ``calfkit_tpu`` names bound to the
    port's and its own functions and classes rebuilt over them."""
    if module_name in _PORTED:
        return _PORTED[module_name]
    module = importlib.import_module(module_name)
    g = dict(vars(module))
    g["__builtins__"] = _PORT_BUILTINS
    imported = _imported_names(module)
    assert imported, module_name
    for name, (source, attr) in imported.items():
        target = importlib.import_module(_port_name(source))
        g[name] = target if attr is None else getattr(target, attr)
    own = [(name, obj) for name, obj in vars(module).items()
           if getattr(obj, "__module__", None) == module_name
           and isinstance(obj, (types.FunctionType, type))]
    # classes in definition order, so a base is rebuilt before its subclasses
    own.sort(key=lambda item: inspect.getsourcelines(item[1])[1])
    for name, obj in own:
        g[name] = (_rebind_function(obj, g) if isinstance(obj, types.FunctionType)
                   else _rebind_class(obj, g, module_name))
    _PORTED[module_name] = g
    return g
