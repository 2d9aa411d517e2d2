"""Shared CLI helpers: the command tree on ``argparse``, node loading, mesh
resolution.

The JAX package's ``ck`` is built on ``click``; the port's has the same
commands, options, defaults and messages on the standard library's
``argparse``.  :class:`Command` and :class:`Group` hold what a click
command holds (name, parameters, help, the callback it runs);
:class:`CliError` stands where ``click.ClickException`` stood: a command
raises it, and the command line prints ``Error: <message>`` on stderr and
exits with code 1.  A usage error exits with 2, as click's does.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence


class CliError(Exception):
    """A command's failure, reported as ``Error: <message>`` on stderr with
    exit code 1 (the port's ``click.ClickException``)."""

    exit_code = 1

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def show(self) -> None:
        echo(f"Error: {self.message}", err=True)


def echo(message: Any = "", *, nl: bool = True, err: bool = False) -> None:
    """Write ``message`` (and a newline) to stdout, or stderr with ``err``,
    and flush: ``click.echo``."""
    stream = sys.stderr if err else sys.stdout
    stream.write(f"{message}\n" if nl else str(message))
    stream.flush()


def prompt_int(text: str, default: int) -> int:
    """Ask for an integer until one is given; an empty answer takes
    ``default`` (``click.prompt(text, type=int, default=default)``)."""
    while True:
        raw = input(f"{text} [{default}]: ").strip()
        if not raw:
            return default
        try:
            return int(raw)
        except ValueError:
            echo(f"Error: {raw!r} is not a valid integer.", err=True)


# --------------------------------------------------------------------------- #
# the command tree
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Argument:
    """A positional parameter; ``nargs=-1`` takes any number of values (a
    tuple), at least one when ``required``."""

    name: str
    nargs: int = 1
    required: bool = True


@dataclass(frozen=True)
class Option:
    """``--flag VALUE`` (or, with ``is_flag``, a bare ``--flag``) bound to
    the callback's parameter ``name``."""

    flag: str
    name: str
    default: Any = None
    type: Callable[[str], Any] = str
    is_flag: bool = False
    help: "str | None" = None
    show_default: bool = False


def option(flag: str, name: "str | None" = None, **kw: Any) -> Option:
    return Option(flag, name or flag.lstrip("-").replace("-", "_"), **kw)


def flag(flag_: str, name: "str | None" = None, *, help: "str | None" = None) -> Option:
    return option(flag_, name, default=False, type=bool, is_flag=True, help=help)


class _Parser(argparse.ArgumentParser):
    """Usage errors as click reports them: usage, a hint, ``Error: ...``,
    exit code 2."""

    def error(self, message: str) -> None:  # type: ignore[override]
        self.print_usage(sys.stderr)
        echo(f"Try '{self.prog} --help' for help.\n\nError: {message}", err=True)
        raise SystemExit(2)


def _summary(text: "str | None") -> "str | None":
    return text.strip().splitlines()[0] if text and text.strip() else None


class Command:
    """A leaf command: ``callback(**values)`` over its parsed ``params``."""

    def __init__(self, name: str, callback: Callable[..., Any],
                 params: "Sequence[Argument | Option]" = (), help: "str | None" = None):
        self.name = name
        self.callback = callback
        self.params = list(params)
        self.help = help if help is not None else inspect.getdoc(callback)

    def _fill(self, parser: argparse.ArgumentParser) -> None:
        for p in self.params:
            if isinstance(p, Argument):
                nargs = (("+" if p.required else "*") if p.nargs == -1
                         else None if p.required else "?")
                parser.add_argument(p.name, nargs=nargs, default=() if p.nargs == -1 else None,
                                    metavar=p.name.upper())
            elif p.is_flag:
                parser.add_argument(p.flag, dest=p.name, action="store_true", help=p.help)
            else:
                help_ = p.help
                if p.show_default:
                    help_ = f"{help_ or ''}  [default: {p.default}]".strip()
                parser.add_argument(p.flag, dest=p.name, type=p.type, default=p.default,
                                    help=help_)
        parser.set_defaults(_command=self)

    def parser(self, prog: "str | None" = None) -> argparse.ArgumentParser:
        parser = _Parser(prog=prog or self.name, description=self.help)
        self._fill(parser)
        return parser

    def parse(self, args: "Sequence[str]", prog: "str | None" = None) -> "tuple[Command, dict]":
        """→ (the command ``args`` name, its callback's keyword values); a
        group named without a subcommand prints its help and exits 2."""
        values = vars(self.parser(prog).parse_args(list(args)))
        command = values.pop("_command")
        group_parser = values.pop("_group_parser", None)
        if isinstance(command, Group):
            group_parser.print_help(sys.stderr)
            raise SystemExit(2)
        for p in command.params:
            if isinstance(p, Argument) and p.nargs == -1:
                values[p.name] = tuple(values[p.name])
        return command, values

    def main(self, args: "Sequence[str] | None" = None, prog_name: "str | None" = None) -> None:
        """Run as a program: parse ``args`` (default: the command line),
        run the callback, exit 0; a :class:`CliError` exits 1 after its
        message, an interrupt 1 after ``Aborted!``."""
        command, values = self.parse(sys.argv[1:] if args is None else args, prog_name)
        try:
            command.callback(**values)
        except CliError as exc:
            exc.show()
            raise SystemExit(exc.exit_code) from None
        except KeyboardInterrupt:
            echo("\nAborted!", err=True)
            raise SystemExit(1) from None
        raise SystemExit(0)

    def __call__(self, args: "Sequence[str] | None" = None, prog_name: "str | None" = None) -> None:
        self.main(args, prog_name)


class Group(Command):
    """A command of subcommands (``commands``: name → command); run with
    none, it prints its help and exits 2."""

    def __init__(self, name: str, help: str, version: "str | None" = None):
        super().__init__(name, lambda: None, (), help)  # parsing never runs a group
        self.version = version
        self.commands: dict[str, Command] = {}

    def add_command(self, command: Command) -> Command:
        self.commands[command.name] = command
        return command

    def command(self, name: str, *params: "Argument | Option",
                help: "str | None" = None) -> Callable[[Callable[..., Any]], Command]:
        """Decorator: the function as the subcommand ``name``."""
        return lambda fn: self.add_command(Command(name, fn, params, help))

    def _fill(self, parser: argparse.ArgumentParser) -> None:
        if self.version is not None:
            parser.add_argument("--version", action="version",
                                version=f"%(prog)s, version {self.version}",
                                help="Show the version and exit.")
        parser.set_defaults(_command=self, _group_parser=parser)
        subparsers = parser.add_subparsers(metavar="COMMAND", parser_class=_Parser)
        for name, command in self.commands.items():
            sub = subparsers.add_parser(name, help=_summary(command.help),
                                        description=command.help)
            command._fill(sub)


def command(name: str, *params: "Argument | Option",
            help: "str | None" = None) -> Callable[[Callable[..., Any]], Command]:
    """Decorator: the function as the command ``name`` (``click.command``)."""
    return lambda fn: Command(name, fn, params, help)


# --------------------------------------------------------------------------- #
# node loading and mesh resolution
# --------------------------------------------------------------------------- #


def is_file_spec(module_part: str) -> bool:
    """The single authority for file-vs-module spec classification —
    shared by the loader, the reload watcher, and daemon absolutization."""
    return module_part.endswith(".py") or "/" in module_part


def load_object(spec: str) -> Any:
    """Load ``module:attr`` / ``path/to/file.py:attr``, or — with no
    ``:attr`` — every node defined at the module's top level (node files
    need no boilerplate)."""
    if ":" in spec:
        module_part, attr = spec.rsplit(":", 1)
    else:
        module_part, attr = spec, None
    if is_file_spec(module_part):
        path = Path(module_part).resolve()
        if not path.exists():
            raise CliError(f"no such file: {path}")
        sys.path.insert(0, str(path.parent))
        spec_obj = importlib.util.spec_from_file_location(path.stem, path)
        module = importlib.util.module_from_spec(spec_obj)
        sys.modules[path.stem] = module
        spec_obj.loader.exec_module(module)
    else:
        try:
            module = importlib.import_module(module_part)
        except ModuleNotFoundError as exc:
            if exc.name and not (
                module_part == exc.name
                or module_part.startswith(exc.name + ".")
            ):
                # the spec resolved; one of ITS imports is missing — name
                # the real missing dependency, not the spec grammar
                raise CliError(
                    f"error importing {module_part!r}: {exc}"
                ) from exc
            raise CliError(
                f"cannot import {module_part!r} "
                "(specs are 'module:attr', 'file.py:attr', or a bare "
                "'file.py' to collect its nodes)"
            ) from exc
    if attr is None:
        from calfkit_tpu_torch.nodes.base import BaseNodeDef

        found = [
            value
            for name, value in vars(module).items()
            if not name.startswith("_") and isinstance(value, BaseNodeDef)
        ]
        # dedupe while preserving definition order (an attr alias like
        # ``TEAM = [a, b]`` is a list, not a BaseNodeDef — untouched here)
        unique: list[Any] = []
        for node in found:
            if all(node is not seen for seen in unique):
                unique.append(node)
        if not unique:
            raise CliError(
                f"{module_part!r} defines no nodes at top level; "
                "name one with 'module:attr'"
            )
        return unique
    try:
        return getattr(module, attr)
    except AttributeError as exc:
        raise CliError(
            f"{module_part!r} has no attribute {attr!r}"
        ) from exc


def load_nodes(specs: tuple[str, ...]) -> list[Any]:
    """Load every spec, deduping by ``node_id`` (first-seen order): a node
    imported into one spec and also loaded from its own file — even as a
    re-exec'd second instance — is served once; two different nodes
    claiming one name resolve to the first seen."""
    nodes: list[Any] = []
    seen: set[str] = set()
    for spec in specs:
        obj = load_object(spec)
        for node in obj if isinstance(obj, (list, tuple)) else [obj]:
            key = getattr(node, "node_id", None)
            if key is not None:
                if key in seen:
                    continue
                seen.add(key)
            nodes.append(node)
    return nodes


def resolve_mesh_for_cli(url: str | None, *, hosts_worker: bool = True) -> Any:
    """The CLI flavor of the shared grammar, errors as :class:`CliError`.

    ``hosts_worker=True`` (ck run / ck dev run) defaults to memory:// — the
    command hosts the worker in-process, so an isolated mesh is meaningful.
    Worker-less commands (chat, topics) must point at a REAL mesh: memory://
    there would be a silent no-op world.
    """
    from calfkit_tpu_torch.mesh.urls import resolve_mesh

    try:
        transport, _ = resolve_mesh(
            url,
            default="memory://" if hosts_worker else None,
            allow_memory=hosts_worker,
        )
        return transport
    except ValueError as exc:
        raise CliError(str(exc)) from exc
