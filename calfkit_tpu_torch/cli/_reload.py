"""``--reload`` support: restart a serve subprocess when watched files change.

The watcher is a stat-polling scan (no file-watch library needed): edit a
file and the worker restarts with the new code; the serve runs in a child
process so a restart is a clean re-import.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from pathlib import Path
from typing import Iterable

_MAX_WATCHED = 2000


def watch_roots_for_specs(specs: Iterable[str]) -> list[Path]:
    """Directories worth watching for the given node specs."""
    from calfkit_tpu_torch.cli._common import is_file_spec

    roots: list[Path] = []
    for spec in specs:
        module_part = spec.rsplit(":", 1)[0]
        if is_file_spec(module_part):
            path = Path(module_part).resolve()
            if path.exists():
                roots.append(path.parent)
        else:  # a module name: watch the cwd tree like the reference does
            roots.append(Path.cwd())
    # dedupe, parents swallow children
    uniq: list[Path] = []
    for root in sorted(set(roots)):
        if not any(root.is_relative_to(kept) for kept in uniq):
            uniq.append(root)
    return uniq


def snapshot(roots: Iterable[Path]) -> dict[str, float]:
    """mtimes of every watched .py file (bounded scan)."""
    seen: dict[str, float] = {}
    for root in roots:
        for path in root.rglob("*.py"):
            if any(part.startswith(".") or part == "__pycache__"
                   for part in path.parts):
                continue
            try:
                seen[str(path)] = path.stat().st_mtime
            except OSError:
                continue
            if len(seen) >= _MAX_WATCHED:
                return seen
    return seen


def serve_with_reload(
    child_argv: list[str],
    roots: list[Path],
    *,
    poll_interval: float = 0.5,
    echo=print,
    max_restarts: int | None = None,
) -> int:
    """Run ``child_argv`` as a subprocess; restart it whenever a watched
    ``.py`` changes.  Returns the child's final exit code."""
    import signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt  # SIGTERM must not orphan the serving child

    with contextlib.suppress(ValueError):  # non-main thread (tests)
        signal.signal(signal.SIGTERM, _term)
    restarts = 0
    while True:
        before = snapshot(roots)
        proc = subprocess.Popen(child_argv)
        try:
            changed = None
            while changed is None:
                code = proc.poll()
                if code is not None:
                    return code  # child exited on its own: propagate
                time.sleep(poll_interval)
                now = snapshot(roots)
                if now != before:
                    changed = [p for p in now if now.get(p) != before.get(p)]
                    changed += [p for p in before if p not in now]
            echo(f"change detected ({Path(changed[0]).name}): restarting")
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        except KeyboardInterrupt:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            return 0
        restarts += 1
        if max_restarts is not None and restarts >= max_restarts:
            return 0


def reload_child_argv(specs: tuple[str, ...], passthrough: list[str]) -> list[str]:
    return [
        sys.executable, "-m", "calfkit_tpu_torch.cli.main", "run", *specs,
        *passthrough,
    ]
