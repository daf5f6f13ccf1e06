"""Launch-plan autotuner for the hand-written kernels: best of a sweep,
cached.

The reference tunes its Pallas kernels' tile sizes (``block=``). The
port's kernels fix their tiles at compile time and take their launch
plan at run time instead, so the plan is what is tuned here:

* the wire matmul (``takum_matmul``, op ``"qmatmul"``) and the LNS
  matmul (``lns_matmul``, op ``"lns_qmatmul"``, linear accumulation):
  ``(variant, split)``, the regime (0 streaming, 1 tiles) and how many
  blocks share K; the K tiles per split follow from the shape
  (:func:`fit_plan`). Gauss accumulation runs in order and is never
  split, so it has nothing to tune;
* contiguous attention (``takum_attention.attention``, op
  ``"attention"``): the KV tile ``bk`` (``(bk,)``), which decides the
  tiles a query block visits.

Paged attention takes no runtime choice: its partition is fixed by the
key width at compile time (``csrc/attention.cu``, ``Geo``), so its space
would be its single plan, and it has no entry.

Key space
---------
Entries are keyed ``"{op}|{format}|{bucket}|{backend}"``: ``op`` one of
:data:`OPS`; ``format`` the registry name (``"takum8"``,
``"lns-takum8"``, ``"none"`` for a float cache); ``bucket`` a shape
bucket, each dim rounded up to a power of two (``m8k8192n32768``) or the
cache length (``t1024``); ``backend`` ``torch.cuda.get_device_name()``
on the card, ``"cpu"`` otherwise: a plan that wins on one card means
nothing on another.

Storage
-------
Two JSON tables, the local one over the checked-in one:

* ``autotune_defaults.json`` (beside this module, checked in): tuned
  entries that ship with the package. It holds none yet, so a call that
  finds nothing in the local cache takes the planner's own choice
  (``launch_plan``, ``DEFAULT_BK``);
* a local cache (``$REPRO_AUTOTUNE_CACHE``, else ``.repro_autotune.json``
  in the working directory): what a sweep writes, and what every later
  run from that directory reads. ``main`` prints the path it wrote.

``REPRO_AUTOTUNE`` picks the mode, as the reference's:

* ``0``: off. Lookups return nothing; every call takes the planner's
  choice;
* ``1`` (default): lookup only, never sweep;
* ``force``: :func:`cached_or_sweep` sweeps even on a hit and writes the
  local cache (``python -m repro_torch.kernels.autotune``).

Every space starts with the planner's choice and selection is by strict
improvement, so a tuned plan beats or ties it. On the card a candidate
is timed by CUDA-graph replays (event times over calls of 0.1-0.3 ms
spread by up to 30%, replays within 0.5%). A candidate that fails to
build or launch is skipped and named in the sweep's log and its entry;
the plan chosen is always one that ran.

Wrappers resolve a plan once per (op, format, shape) and remember it
(:func:`resolved_plan`), so a call costs one dict lookup. The local
cache's path is read once a process; a sweep in this process, or
:func:`clear`, forgets the remembered plans and the path, so a change of
``REPRO_AUTOTUNE`` or ``REPRO_AUTOTUNE_CACHE`` in a running process takes
effect after :func:`clear`. ``autotune.hit`` and ``autotune.miss`` in
``obs.metrics.GLOBAL`` count the table's lookups.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["OPS", "DEFAULTS_PATH", "mode", "local_cache_path", "backend",
           "matmul_bucket", "attention_bucket", "bucket_of", "lookup",
           "default_plan", "fit_plan", "resolved_plan", "qmm_space",
           "lns_space", "attn_space", "space_of", "cached_or_sweep",
           "graph_seconds", "clear", "main"]

DEFAULTS_PATH = os.path.join(os.path.dirname(__file__),
                             "autotune_defaults.json")

OPS = ("qmatmul", "lns_qmatmul", "attention")

# K splits tried beside the planner's
_SPLITS = (1, 2, 4, 8, 16, 32, 64)
# KV tiles of contiguous attention tried beside the planner's
_ATTN_CANDIDATES = ((256,), (128,), (512,), (1024,))


def mode() -> str:
    """Current autotune mode: '0' | '1' | 'force' (default '1')."""
    m = os.environ.get("REPRO_AUTOTUNE", "1")
    if m not in ("0", "1", "force"):
        raise ValueError(f"REPRO_AUTOTUNE={m!r}: expected 0, 1 or force")
    return m


_LOCAL: List[str] = []


def local_cache_path() -> str:
    """``$REPRO_AUTOTUNE_CACHE``, else ``.repro_autotune.json`` in the
    working directory (read once a process, again after :func:`clear`)."""
    if not _LOCAL:
        path = os.environ.get("REPRO_AUTOTUNE_CACHE")
        if not path:
            try:
                path = os.path.join(os.getcwd(), ".repro_autotune.json")
            except FileNotFoundError:  # a removed working directory: none
                path = ".repro_autotune.json"
        _LOCAL.append(path)
    return _LOCAL[0]


_BACKEND: List[str] = []


def backend() -> str:
    """The card's name, or ``"cpu"`` without one (read once a process)."""
    if not _BACKEND:
        import torch
        _BACKEND.append(torch.cuda.get_device_name()
                        if torch.cuda.is_available() else "cpu")
    return _BACKEND[0]


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------


def _p2(x: int) -> int:
    """Round up to a power of two (min 8)."""
    x = max(int(x), 8)
    return 1 << (x - 1).bit_length()


def matmul_bucket(m: int, k: int, n: int) -> str:
    """Bucket a [M, K] @ [K, N] problem: each dim to its power of two."""
    return f"m{_p2(m)}k{_p2(k)}n{_p2(n)}"


def attention_bucket(tmax: int) -> str:
    """Bucket an attention problem by the cache's length."""
    return f"t{_p2(tmax)}"


def bucket_of(op: str, shape) -> str:
    """``shape`` is (M, K, N) for the matmuls and (T,) for attention."""
    if op == "attention":
        return attention_bucket(shape[0])
    return matmul_bucket(*shape)


def _key(op: str, fmt: str, bucket: str, backend_: Optional[str]) -> str:
    if op not in OPS:
        raise ValueError(f"unknown autotune op {op!r} (known: {OPS})")
    return f"{op}|{fmt}|{bucket}|{backend_ or backend()}"


# ---------------------------------------------------------------------------
# Table I/O (defaults + local cache, local wins)
# ---------------------------------------------------------------------------


_loaded: Dict[str, dict] = {}  # path -> the table (mtime-validated)
_mtimes: Dict[str, float] = {}
# (op, format, shape) -> plan
_resolved: Dict[tuple, tuple] = {}


def clear() -> None:
    """Forget the loaded tables, the local cache's path and every
    resolved plan."""
    _loaded.clear()
    _mtimes.clear()
    _resolved.clear()
    _LOCAL.clear()


def _load(path: str) -> dict:
    try:
        mt = os.path.getmtime(path)
    except OSError:
        return {"schema": 1, "entries": {}}
    if path not in _loaded or _mtimes.get(path) != mt:
        with open(path) as f:
            _loaded[path] = json.load(f)
        _mtimes[path] = mt
    return _loaded[path]


def _entry(op, fmt, bucket, backend_) -> Optional[dict]:
    key = _key(op, fmt, bucket, backend_)
    for path in (local_cache_path(), DEFAULTS_PATH):  # local wins
        ent = _load(path).get("entries", {}).get(key)
        if ent is not None:
            return ent
    return None


def lookup(op: str, fmt: str, bucket: str,
           backend: Optional[str] = None) -> Optional[Tuple[int, ...]]:
    """The tuned plan for a key, or None (a miss, or
    ``REPRO_AUTOTUNE=0``). Counts
    ``autotune.hit`` / ``autotune.miss`` in ``obs.metrics.GLOBAL``."""
    if mode() == "0":
        return None
    ent = _entry(op, fmt, bucket, backend)
    from repro_torch.obs.metrics import GLOBAL
    GLOBAL.counter("autotune.hit" if ent is not None
                   else "autotune.miss").inc()
    return None if ent is None else tuple(ent["plan"])


def _record(op, fmt, bucket, backend_, plan, seconds, skipped) -> None:
    path = local_cache_path()
    doc = _load(path)
    doc.setdefault("schema", 1)
    doc.setdefault("entries", {})[_key(op, fmt, bucket, backend_)] = {
        "plan": list(plan),
        "us": round(seconds * 1e6, 3),
        "backend": backend_ or backend(),
        "skipped": [list(c) for c in skipped],
        "swept": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    _loaded[path] = doc
    _mtimes[path] = os.path.getmtime(path)
    _resolved.clear()


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _planner(op: str):
    from repro_torch.kernels import lns_matmul, takum_matmul
    return takum_matmul if op == "qmatmul" else lns_matmul


def default_plan(op: str, shape, bits: int = 8) -> tuple:
    """The planner's own choice: ``launch_plan``'s (variant, split, K
    tiles per split) for the matmuls, ``(DEFAULT_BK,)`` for attention."""
    if op == "attention":
        from repro_torch.kernels.takum_attention import DEFAULT_BK
        return (DEFAULT_BK,)
    if op == "qmatmul":
        return _planner(op).launch_plan(*shape, bits)
    return _planner(op).launch_plan(*shape, "linear", bits)


def fit_plan(op: str, plan: tuple, shape, bits: int = 8) -> Optional[tuple]:
    """A table's plan at ``shape``: ``(variant, split)`` -> (variant,
    split, K tiles per split) for the matmuls (the split capped by K's
    tiles, and by the streaming kernel's stage of x), ``(bk,)`` as it is
    for attention. None where the plan cannot run the shape."""
    if op == "attention":
        return (int(plan[0]),) if plan and plan[0] > 0 else None
    mod = _planner(op)
    m, k, _ = shape
    variant, split = int(plan[0]), int(plan[1])
    if variant not in (0, 1) or split < 1 or (variant == 0
                                              and m > mod.STREAM_M):
        return None
    ktile = mod.KTILE if op == "qmatmul" else mod.KTILE[variant]
    kt = max(1, -(-k // ktile))
    per = -(-kt // min(split, kt))
    if op == "qmatmul" and variant == 0:
        mc = mod.STREAM_BLOCKS[bits][0]
        per = min(per, mod.STREAM_X_FLOATS // (mc * ktile))
    return variant, -(-kt // per), per


def resolved_plan(op: str, spec, shape) -> tuple:
    """The plan a wrapper launches ``spec``'s words with at ``shape``
    ((M, K, N), or (T,) for attention): the table's entry fitted to the
    shape, or the planner's choice (a miss, mode 0). Remembered per
    (op, format, shape) until :func:`clear` or a sweep."""
    key = (op, spec.name, tuple(shape))
    plan = _resolved.get(key)
    if plan is None:
        hit = lookup(op, spec.name, bucket_of(op, shape))
        plan = fit_plan(op, hit, shape, spec.n) if hit else None
        if plan is None:
            plan = default_plan(op, shape, spec.n)
        _resolved[key] = plan
    return plan


# ---------------------------------------------------------------------------
# Spaces and sweeping
# ---------------------------------------------------------------------------


def _matmul_space(op: str, shape, bits: int) -> Tuple[tuple, ...]:
    v0, s0, _ = default_plan(op, shape, bits)
    out: List[tuple] = [(v0, s0)]
    variants = (0, 1) if shape[0] <= _planner(op).STREAM_M else (1,)
    for v in variants:
        for s in _SPLITS:
            fit = fit_plan(op, (v, s), shape, bits)
            if fit is not None and fit[:2] not in out:
                out.append(fit[:2])
    return tuple(out)


def qmm_space(shape, bits: int = 8) -> Tuple[tuple, ...]:
    """The wire matmul's (variant, split) candidates at (M, K, N), the
    planner's first."""
    return _matmul_space("qmatmul", shape, bits)


def lns_space(shape, bits: int = 8) -> Tuple[tuple, ...]:
    """The LNS matmul's (linear accumulation) candidates, the planner's
    first."""
    return _matmul_space("lns_qmatmul", shape, bits)


def attn_space(fallback_bk: int) -> Tuple[tuple, ...]:
    out = [(int(fallback_bk),)]
    out += [c for c in _ATTN_CANDIDATES if c != (int(fallback_bk),)]
    return tuple(out)


def space_of(op: str, shape, bits: int = 8) -> Tuple[tuple, ...]:
    if op == "qmatmul":
        return qmm_space(shape, bits)
    if op == "lns_qmatmul":
        return lns_space(shape, bits)
    return attn_space(default_plan(op, shape)[0])


def graph_seconds(run: Callable[[], object], reps: int = 20) -> float:
    """Seconds a call of ``run`` takes on the card: ``reps`` calls
    captured in one CUDA graph, replayed once between two events (three
    warm calls first, on a side stream)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            run()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / reps / 1e3


def cached_or_sweep(op: str, fmt: str, bucket: str,
                    space: Sequence[tuple],
                    run: Callable[[tuple], Callable[[], object]],
                    backend: Optional[str] = None,
                    log: Optional[Callable[[str], None]] = None,
                    timer: Optional[Callable[[Callable[[], object]],
                                             float]] = None):
    """``(plan, us, swept)`` for a key, as the reference's.

    A hit in mode ``1``: the table's plan, untimed (the same on every
    call). Mode ``force``: time every candidate of ``space`` (the
    planner's first; a later one replaces the best only when strictly
    faster) and write the local cache. Mode ``0`` or a miss outside
    ``force``: ``space[0]``, untimed.

    ``run(plan)`` returns a zero-argument callable that runs the kernel
    with that plan; ``timer(call)`` its seconds a call
    (:func:`graph_seconds` by default). A candidate whose build, launch
    or timing raises is skipped and named in ``log`` and the entry."""
    m = mode()
    fallback = tuple(space[0])
    if m == "0":
        return fallback, None, False
    cached = lookup(op, fmt, bucket, backend)
    if cached is not None and m != "force":
        return (cached, (_entry(op, fmt, bucket, backend) or {}).get("us"),
                False)
    if m != "force":
        return fallback, None, False
    timer = timer or graph_seconds
    best, best_t, skipped = None, None, []
    for cand in space:
        try:
            t = timer(run(tuple(cand)))
        except Exception as e:  # noqa: BLE001 - named, then skipped
            skipped.append(tuple(cand))
            if log:
                log(f"#   {tuple(cand)}: skipped ({type(e).__name__}: "
                    f"{str(e)[:160]})")
            continue
        if log:
            log(f"#   {tuple(cand)}: {t * 1e6:.3f} us")
        if best_t is None or t < best_t:  # strict: the first wins ties
            best, best_t = tuple(cand), t
    if best is None:
        raise RuntimeError(f"autotune {op}|{fmt}|{bucket}: every candidate "
                           f"failed ({skipped})")
    _record(op, fmt, bucket, backend, best, best_t, skipped)
    return best, best_t * 1e6, True


# ---------------------------------------------------------------------------
# Sweeps on the card
# ---------------------------------------------------------------------------


def sweep_matmul(op: str, fmt: str, shape, *, seed: int = 0, log=print,
                 timer=None):
    """Sweep one matmul problem on the card (``op`` ``"qmatmul"`` or
    ``"lns_qmatmul"``, ``fmt`` a registry name, ``shape`` (M, K, N)) in
    the current mode; ``(plan, us, swept)``. Seeded operands: normal x
    and weights of scale 1/sqrt(K), encoded to ``fmt``'s words."""
    import torch

    from repro_torch import formats
    from repro_torch.kernels import lns_matmul, takum_codec, takum_matmul
    m, k, n = shape
    spec = formats.resolve(fmt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    ww = takum_codec.encode(w, spec)
    if op == "qmatmul":
        def run(plan):
            full = fit_plan(op, plan, shape, spec.n)
            return lambda: takum_matmul.qmatmul(x, ww, spec, plan=full)
    else:
        xw = takum_codec.encode(x, spec)

        def run(plan):
            full = fit_plan(op, plan, shape, spec.n)
            return lambda: lns_matmul.lns_matmul(xw, ww, spec, plan=full)
    bucket = matmul_bucket(*shape)
    log(f"# sweep {op}/{fmt} {bucket} {tuple(shape)} [{backend()}]")
    out = cached_or_sweep(op, fmt, bucket, space_of(op, shape, spec.n),
                          run, log=log, timer=timer)
    log(f"#   -> {out[0]} ({out[1]} us)")
    return out


def sweep_attention(fmt: str, t: int, *, b: int = 4, hkv: int = 10,
                    g: int = 4, hd: int = 128, seed: int = 0, log=print,
                    timer=None):
    """Sweep contiguous attention's KV tile for one decode row a query
    head over a ``t``-key cache of ``fmt`` words (``"none"``: bf16)."""
    import torch

    from repro_torch import formats
    from repro_torch.kernels import takum_attention, takum_codec
    spec = formats.resolve(fmt)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q4 = torch.randn((b, hkv, g, hd), generator=gen, device="cuda")
    kv = torch.randn((b, t, hkv, hd), generator=gen, device="cuda")
    words = (kv.to(torch.bfloat16) if spec.is_identity
             else takum_codec.encode(kv, spec))

    def run(plan):
        return lambda: takum_attention.attention(
            q4, words, words, t - 1, spec=spec, tq=1, bk=plan[0])
    bucket = attention_bucket(t)
    log(f"# sweep attention/{spec.name} {bucket} [{backend()}]")
    out = cached_or_sweep("attention", spec.name, bucket,
                          space_of("attention", (t,)), run, log=log,
                          timer=timer)
    log(f"#   -> {out[0]} ({out[1]} us)")
    return out


# the standard problems of ``main``: phi3-medium-14b's projections at a
# decode batch and a prefill chunk, and its KV heads at two cache lengths
MATMUL_SHAPES = ((4, 5120, 17920), (256, 5120, 17920))
MATMUL_FORMATS = {"qmatmul": ("takum8", "takum16", "posit8", "posit16"),
                  "lns_qmatmul": ("lns-takum8", "lns-takum16")}
ATTN_T = (1024, 8192)
ATTN_FORMATS = ("takum8", "takum16", "lns-takum8", "posit8", "none")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Sweep the kernels' launch plans at the standard "
                    "problems on the card and write the local autotune "
                    "cache (REPRO_AUTOTUNE_CACHE or .repro_autotune.json), "
                    "which later runs with REPRO_AUTOTUNE=1 read.")
    ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("autotune: no CUDA device: the sweep times the kernels on "
              "the card")
        return 2
    os.environ["REPRO_AUTOTUNE"] = "force"
    clear()
    for op, fmts in MATMUL_FORMATS.items():
        for fmt in fmts:
            for shape in MATMUL_SHAPES:
                sweep_matmul(op, fmt, shape)
    for fmt in ATTN_FORMATS:
        for t in ATTN_T:
            sweep_attention(fmt, t)
    print(f"# wrote {local_cache_path()}: runs from this directory "
          "(or with this REPRO_AUTOTUNE_CACHE) now launch its plans")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
