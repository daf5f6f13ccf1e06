"""Time the port's wire matmul, and the build-time choices of its kernels,
on one CUDA card.

    python3 tools/torch_kernel_times.py [--src DIR] [--attention]
        [--variants] [--out F]

Times ``takum_matmul.qmatmul`` for takum8, takum16, posit8 (through the
table) and posit16 words at every projection shape of a phi3-medium-14b
layer (decode M = 4 and a prefill chunk M = 256), with CUDA events. The
package is imported from ``--src`` (default: this checkout's ``src``), so
two trees can be timed in one call on one card, an older one too: only
``formats.get``, ``takum_codec.encode`` and ``takum_matmul.qmatmul`` are
used there.

``--attention`` also times contiguous attention at the 1024-row chunk
of a 256-token prefill for every KV format the tree's kernels take.

``--variants`` (this checkout's kernels only) also builds the sources
again with the defines that undo one choice each, and times them against
the default build on the same inputs:

* ``FLASH_KSPLIT=1`` / ``=2``: contiguous attention with one group of 4
  warps, or two groups splitting the keys, for every KV format (the
  default takes two for 16-bit words decoded by computation);
* ``TF32_GUARD_ALWAYS=1``: the prefill matmul and contiguous attention
  with tf32.cuh's guards on every tile (the default takes them only on
  tiles that hold a value that needs them);
* ``WIRE_TAKUM8_COMPUTED=1``: takum8 words by the computed decode in
  every kernel instead of the 256-entry table.

Prints the card (``nvidia-smi``'s name and power limit) and one JSON
object as its last line; ``--out`` writes the same object to a file.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

MM_SHAPES = [(4, 5120, 5120), (4, 5120, 1280), (4, 5120, 17920),
             (4, 17920, 5120), (256, 5120, 5120), (256, 5120, 1280),
             (256, 5120, 17920), (256, 17920, 5120)]
MM_FORMATS = ("takum8", "takum16", "posit8", "posit16")
KV_FORMATS = ("takum8", "takum16", "lns-takum8", "lns-takum16", "posit8",
              "posit16", "bf16", "f32")
# variant builds: name -> (sources, defines)
VARIANTS = {
    "ksplit1": (("flash_attention",), ("-DFLASH_KSPLIT=1",)),
    "ksplit2": (("flash_attention",), ("-DFLASH_KSPLIT=2",)),
    "guard_always": (("qmatmul", "flash_attention"),
                     ("-DTF32_GUARD_ALWAYS=1",)),
    "takum8_computed": (("qmatmul", "flash_attention", "attention", "codec"),
                        ("-DWIRE_TAKUM8_COMPUTED=1",)),
}


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` warm launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def matmul_times(torch, dev, formats, takum_codec, takum_matmul,
                 names=MM_FORMATS, shapes=MM_SHAPES):
    """{"<format> MxKxN": ms} on seeded N(0, 1/K) weights."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for name in names:
        spec = formats.get(name)
        for m, k, n in shapes:
            x = torch.randn((m, k), generator=g, device=dev)
            w = takum_codec.encode(torch.randn((k, n), generator=g,
                                               device=dev) / k ** 0.5, spec)
            out[f"{name} {m}x{k}x{n}"] = cuda_ms(
                torch, lambda: takum_matmul.qmatmul(x, w, spec))
            del x, w
    return out


def attention_times(torch, dev, names=KV_FORMATS):
    """{"<format>": ms} of contiguous attention at the 1024-row chunk
    (G 4 x 256 rows, 10 KV heads, hd 128, pos 768)."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec
    from repro_torch.kernels import takum_attention as kattn
    hkv, grp, hd, tq, pos0, tcache = 10, 4, 128, 256, 768, 1280
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((1, tq, hkv * grp, hd), generator=g, device=dev)
    q4 = kattn.to_rows(q, hkv).contiguous()
    kf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    vf = torch.randn((1, tcache, hkv, hd), generator=g, device=dev)
    start0 = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    for name in names:
        if name in ("bf16", "f32"):
            spec = formats.get("none")
            dt = torch.bfloat16 if name == "bf16" else torch.float32
            kc, vc = kf.to(dt), vf.to(dt)
        else:
            spec = formats.get(name)
            kc, vc = takum_codec.encode(kf, spec), takum_codec.encode(vf, spec)
        try:
            out[name] = cuda_ms(torch, lambda: kattn.attention(
                q4, kc, vc, pos0, start0, spec=spec, bk=256, tq=tq),
                iters=50)
        except (NotImplementedError, TypeError):
            out[name] = None       # a format this tree's kernels refuse
    return out


def takum8_times(torch, dev):
    """The kernels that decode takum8 words, at the serving shapes."""
    from repro_torch import formats
    from repro_torch.kernels import takum_codec, takum_matmul
    from repro_torch.kernels import takum_attention as kattn
    t8 = formats.get("takum8")
    out = matmul_times(torch, dev, formats, takum_codec, takum_matmul,
                       names=("takum8",),
                       shapes=[(4, 5120, 17920), (256, 5120, 17920)])
    out["attention"] = attention_times(torch, dev, ("takum8",))["takum8"]
    g = torch.Generator(device=dev).manual_seed(5)
    hkv, hd = 10, 128
    kp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), t8)
    vp = takum_codec.encode(torch.randn((24, 256, hkv, hd), generator=g,
                                        device=dev), t8)
    qd4 = kattn.to_rows(torch.randn((4, 1, 4 * hkv, hd), generator=g,
                                    device=dev), hkv).contiguous()
    table = torch.tensor([[1, 2, 0, 0, 0], [3, 4, 5, 0, 0],
                          [6, 7, 8, 9, 10], [0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([76, 520, 1023, 4000], dtype=torch.int32, device=dev)
    startp = torch.zeros(4, dtype=torch.int32, device=dev)
    out["paged_attention"] = cuda_ms(torch, lambda: kattn.paged_attention(
        qd4, kp, vp, pos, startp, table, spec=t8), iters=50)
    w = takum_codec.encode(torch.randn((5120, 17920), generator=g,
                                       device=dev), t8)
    out["decode [5120, 17920]"] = cuda_ms(
        torch, lambda: takum_codec.decode(w, t8))
    return out


def build_variants(build):
    """{variant: {source: library path}}, one nvcc per library, all
    started together, into ``build/repro_torch/variants``."""
    dst = build.BUILD_DIR / "variants"
    dst.mkdir(parents=True, exist_ok=True)
    procs, paths = [], {}
    for var, (sources, defines) in VARIANTS.items():
        for src in sources:
            lib = dst / f"lib{src}-{var}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I",
                   str(build.CSRC), "-o", str(lib),
                   str(build.CSRC / f"{src}.cu")]
            procs.append((var, src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            paths.setdefault(var, {})[src] = lib
    for var, src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src}.cu ({var}) failed:\n{log}")
    return paths


def swap_in(build, libs):
    """Load ``{source: path}`` in place of the default libraries (the
    wrappers' ctypes signatures); returns what it replaced."""
    from repro_torch.kernels import takum_attention, takum_codec, takum_matmul
    sigs = {"qmatmul": takum_matmul._SIGNATURES,
            "codec": takum_codec._SIGNATURES,
            **takum_attention._SIGNATURES}
    old = {}
    for src, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in sigs[src].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        old[src] = build._LIBS.get(src)
        build._LIBS[src] = lib
    return old


def variant_times(torch, dev):
    """Each variant build against the default build, on the same inputs."""
    from repro_torch import formats
    from repro_torch.kernels import build, takum_codec, takum_matmul
    build.build_all()
    paths = build_variants(build)
    prefill = [(256, 5120, 17920), (256, 17920, 5120)]

    def measure():
        return {
            "attention": attention_times(torch, dev),
            "prefill_matmul": matmul_times(torch, dev, formats, takum_codec,
                                           takum_matmul, shapes=prefill),
            "takum8": takum8_times(torch, dev)}

    res = {"default": measure()}
    for var, libs in paths.items():
        old = swap_in(build, libs)
        res[var] = measure()
        for src, lib in old.items():
            build._LIBS[src] = lib
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import formats
    from repro_torch.kernels import takum_codec, takum_matmul
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    res = {"src": str(Path(args.src).resolve()), "card": card,
           "qmatmul_ms": matmul_times(torch, dev, formats, takum_codec,
                                      takum_matmul)}
    if args.attention:
        res["attention_ms"] = attention_times(torch, dev)
    if args.variants:
        res["variants_ms"] = variant_times(torch, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
