"""Parts of the benchmark found by name: ``benchmark/<kind>/<name>.py``.

A configuration names its scene generator (``scenes/``), texture
generator (``textures/``) and camera (``cameras/``); a traffic file its
entry point's driver (``entries/``); ``BENCHMARK.json`` its per-layer
metrics' readers (``metrics/``). A later cell that needs a new one adds
a file; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
_LOADED: dict = {}


def available(kind: str) -> list[str]:
    return sorted(p.stem for p in (BENCH_DIR / kind).glob("*.py"))


def load(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``; a name with no file
    is refused with the names there are."""
    key = (kind, name)
    if key not in _LOADED:
        path = BENCH_DIR / kind / f"{name}.py"
        if "/" in name or not path.is_file():
            raise ValueError(f"no {kind[:-1]} {name!r} (benchmark/{kind}/ "
                             f"has {available(kind)})")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def check_keys(where: str, got, allowed) -> None:
    """Refuse keys that nothing reads."""
    extra = sorted(set(got) - set(allowed))
    if extra:
        raise ValueError(f"{where}: unknown keys {extra} (known: "
                         f"{sorted(allowed)})")
