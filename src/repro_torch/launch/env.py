"""Host process environment for launches, and the startup knob audit.

* **tcmalloc**: host allocator traffic (pinned staging buffers, per-step
  temporaries) is malloc-bound under glibc, so launches LD_PRELOAD
  tcmalloc when present. This module *detects* it (a preload must happen
  before process start, too late from Python); ``host_env`` gives the
  environment of a new process with it;
* the large-alloc report threshold, so numpy staging buffers don't spam
  the console;
* the audit: every ``REPRO_*`` knob the port reads, with the default
  each reader applies when the variable is unset. A launch logs ONE
  structured line up front, in the JAX package's format, so any run's
  effective configuration is reconstructable from its log.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

__all__ = ["TCMALLOC_PATHS", "find_tcmalloc", "tcmalloc_active",
           "host_env", "warn_if_no_tcmalloc", "KNOBS", "effective_knobs",
           "audit_line", "log_config"]

TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

LARGE_ALLOC_THRESHOLD = 60_000_000_000  # quiet numpy staging buffers


def find_tcmalloc() -> Optional[str]:
    """First present tcmalloc shared object, or None."""
    for p in TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def tcmalloc_active() -> bool:
    """Whether this process was started with tcmalloc preloaded."""
    return "tcmalloc" in os.environ.get("LD_PRELOAD", "")


def host_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The launch environment as a dict (for subprocess launches):
    ``LD_PRELOAD`` gains a tcmalloc when one is found (effective only for
    *new* processes), plus the large-alloc report threshold."""
    env = dict(os.environ if base is None else base)
    so = find_tcmalloc()
    if so and "tcmalloc" not in env.get("LD_PRELOAD", ""):
        env["LD_PRELOAD"] = (so + (" " + env["LD_PRELOAD"]
                                   if env.get("LD_PRELOAD") else ""))
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                   str(LARGE_ALLOC_THRESHOLD))
    return env


def warn_if_no_tcmalloc(print_fn: Callable[[str], None] = print) -> bool:
    """Warn when running without tcmalloc; True when it is preloaded."""
    if tcmalloc_active():
        return True
    so = find_tcmalloc()
    hint = (f"host_env() will preload {so}" if so
            else "no tcmalloc .so found on this host")
    print_fn(f"# warning: tcmalloc not preloaded ({hint}); "
             "benchmark timings may be noisier")
    return False


# Every REPRO_* variable the port reads (``grep -rn environ
# src/repro_torch``), with its reader's default. The reference's other
# knobs steer code the port does not have: the Pallas attention dispatch
# and the XLA host device count (the port's ranks are processes:
# ``--world N``). The autotuner's pair picks the kernels' launch plans
# (``kernels/autotune.py``), as the reference's picks its Pallas blocks.
KNOBS: Dict[str, str] = {
    "REPRO_AUTOTUNE": "1",            # launch-plan autotuner (0/1/force)
    "REPRO_AUTOTUNE_CACHE": "",       # sweep cache path ("" = ./.repro_autotune.json)
    "REPRO_OBS": "0",                 # 0 off | 1 trace+metrics | 2 +numeric
    "REPRO_LUT_DECODE": "",           # posit8 table override ("" = per device)
    "REPRO_CAUSAL_SKIP": "0",         # skip fully-masked KV blocks
    "REPRO_FAULT_RATE": "0",          # injected faults per scheduler tick
    "REPRO_FAULT_SEED": "0",          # fault injector PRNG seed
    "REPRO_FAULT_KIND": "nar",        # nar | flip
    "REPRO_SHARD_COMPRESS": "",       # TP collective compression override
}


def effective_knobs(env: Optional[Dict[str, str]] = None
                    ) -> Dict[str, Dict[str, object]]:
    """Each knob's effective value: ``{"value": str, "set": bool}``
    (``set`` tells an explicit setting from the reader's default)."""
    env = os.environ if env is None else env
    out: Dict[str, Dict[str, object]] = {}
    for name, default in KNOBS.items():
        raw = env.get(name)
        out[name] = {"value": default if raw is None else raw,
                     "set": raw is not None}
    return out


def audit_line(env: Optional[Dict[str, str]] = None) -> str:
    """The one-line startup config audit: every knob as ``NAME=value``,
    explicit settings marked with ``!``, prefixed ``# repro-config``."""
    knobs = effective_knobs(env)
    parts = [f"{n}={k['value'] or '(unset)'}{'!' if k['set'] else ''}"
             for n, k in sorted(knobs.items())]
    return "# repro-config " + " ".join(parts)


def log_config(print_fn: Callable[[str], None] = print,
               env: Optional[Dict[str, str]] = None) -> str:
    """Emit (and return) the startup audit line."""
    line = audit_line(env)
    print_fn(line)
    return line
