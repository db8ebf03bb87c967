"""On-disk kernel cache (counterpart of bifrost_tpu/cache.py).

The port's compiled artifacts are the nvcc builds of build.py: one
library a kernel source, and one for each bf.map program M1 generates
(under ``map/``).  They are named by a hash of their source and flags, so
a directory of them is a cache a later process reads instead of running
nvcc again.  By default that directory is the package's ``build/``
(`build.DEFAULT_BUILD_DIR`, listed in .gitignore).

The `kernel_cache` flag (environment BIFROST_TPU_KERNEL_CACHE) moves it:
"" (the default) leaves the builds where they are; "1"/"on"/"true"/"yes"
selects `DEFAULT_CACHE_DIR`; any other value is the directory itself.
`Service.start()` and `FleetScheduler.start()` call
`maybe_enable_from_config()`, so every tenant admission, restart and
respec of a process finds what an earlier process built.
"""

from __future__ import annotations

import os
import shutil

from . import build, config

DEFAULT_CACHE_DIR = os.path.expanduser("~/.bifrost_tpu_torch/kernel_cache")
# Flag values that mean "enabled, at the default directory" rather than
# naming a directory.
_ON_TOKENS = ("1", "on", "true", "yes", "default")
_OFF_TOKENS = ("", "0", "off", "false", "no", "none")
_enabled = False


def _resolve_dir(val=None):
    """Map a flag or path value to a cache directory, or None for off."""
    if val is None:
        return DEFAULT_CACHE_DIR
    tok = str(val).strip()
    if tok.lower() in _OFF_TOKENS:
        return None
    if tok.lower() in _ON_TOKENS:
        return DEFAULT_CACHE_DIR
    return os.path.expanduser(tok)


def enable_kernel_disk_cache(path=None):
    """Send the kernel builds to the cache directory (idempotent) -> it:
    `path`, else the flag's directory, else `DEFAULT_CACHE_DIR`."""
    global _enabled
    path = _resolve_dir(path) or _resolve_dir(config.get("kernel_cache")) \
        or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    build.set_build_dir(path)
    _enabled = True
    return path


def maybe_enable_from_config():
    """Enable the cache iff the `kernel_cache` flag asks for it -> the
    directory, or None when the flag is off.  Never raises: the cache is
    where builds go, not a condition of starting."""
    path = _resolve_dir(config.get("kernel_cache"))
    if path is None:
        return None
    try:
        return enable_kernel_disk_cache(path)
    except Exception:  # noqa: BLE001 — an unwritable cache is not fatal
        return None


def disable_kernel_disk_cache():
    """Builds go back to the package's ``build/``."""
    global _enabled
    build.set_build_dir(None)
    _enabled = False


def kernel_cache_info():
    """-> dict(enabled, path, entries): the directory the builds go to
    (the package's ``build/`` while the cache is off) and the libraries in
    it, generated ones included."""
    path = str(build.BUILD_DIR)
    entries = 0
    for d in (path, os.path.join(path, "map")):
        if os.path.isdir(d):
            entries += sum(1 for f in os.listdir(d) if f.endswith(".so"))
    return {"enabled": _enabled, "path": path, "entries": entries}


def clear_kernel_disk_cache():
    """Delete the directory `kernel_cache_info` reports (libraries loaded
    already stay loaded; the next process builds again)."""
    path = str(build.BUILD_DIR)
    if os.path.isdir(path):
        shutil.rmtree(path)
