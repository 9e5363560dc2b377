"""UDF plugin loading (port of ballista_tpu/plugin.py).

Reference parity: the dlopen-based plugin system
(core/src/plugin/{mod,udf,plugin_manager}.rs) — plugins in a configured
directory are loaded at session start and register UDFs. Re-imagined for
a Python host: each plugin is a `*.py` module in `ballista.plugin.dir`
exposing

    BALLISTA_PLUGIN_API = 1          # version gate (rustc-version check
                                     # analog, udf.rs:28-55)
    def register(ctx): ...           # calls ctx.register_udf(...)

A UDF the port registers takes and returns torch tensors (`exprs.
register_udf`); a plugin written for both packages names its output type
from the context's own package (`type(ctx).__module__`).

Modules with a mismatched/missing API version are rejected (the reference
refuses plugins built by a different compiler version).
"""

from __future__ import annotations

import glob
import importlib.util
import os
from typing import List

PLUGIN_API_VERSION = 1


class PluginError(RuntimeError):
    pass


def load_plugins(plugin_dir: str, ctx) -> List[str]:
    """Load every *.py plugin in plugin_dir; returns loaded module names."""
    if not plugin_dir:
        return []
    if not os.path.isdir(plugin_dir):
        raise PluginError(f"plugin dir does not exist: {plugin_dir!r}")
    loaded = []
    for path in sorted(glob.glob(os.path.join(plugin_dir, "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(
            f"ballista_tpu_torch_plugin_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        api = getattr(mod, "BALLISTA_PLUGIN_API", None)
        if api != PLUGIN_API_VERSION:
            raise PluginError(
                f"plugin {name!r} declares API {api!r}, "
                f"this engine requires {PLUGIN_API_VERSION}")
        register = getattr(mod, "register", None)
        if not callable(register):
            raise PluginError(f"plugin {name!r} has no register(ctx)")
        register(ctx)
        loaded.append(name)
    return loaded
