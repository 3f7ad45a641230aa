"""Time the compile-time choices of the bf16 attention kernels on one NVIDIA GPU.

    python3 attention_variants.py        # from the root of a checkout

``csrc/flash_attention.cu`` (K2) and ``csrc/decode_attention_paged.cu`` (K3)
fix three choices as constants: ``WGS``, the consumer warpgroups (64 query
rows each) of a block (1 in K2, 2 in K3), and K3's ``PREFILL_MIN_ROWS``, the
T*G at or above which bf16 takes paged_prefill_kernel (32).  This writes a
copy of a source with one constant changed under ``build/variants/``, builds
the copies with the port's nvcc flags (one nvcc each, all at once), holds
each against the plain version and times it beside the kernel as built, at
the main path's shapes (inputs rotated past the L2, CUDA events), all in one
process on one card.  Prints the card and one line per variant and shape.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ARGTYPES = {"flash_attention": fa._ARGTYPES, "decode_attention_paged": da._PAGED_ARGTYPES}
# (source, label, the constant as built, the constant in the copy)
VARIANTS = [
    ("flash_attention", "WGS=2", "constexpr int WGS = 1;", "constexpr int WGS = 2;"),
    ("decode_attention_paged", "WGS=1", "constexpr int WGS = 2;", "constexpr int WGS = 1;"),
    ("decode_attention_paged", "paged_prefill_kernel", "constexpr int PREFILL_MIN_ROWS = 32;",
     "constexpr int PREFILL_MIN_ROWS = 1;"),
    ("decode_attention_paged", "paged_decode_kernel", "constexpr int PREFILL_MIN_ROWS = 32;",
     "constexpr int PREFILL_MIN_ROWS = 1 << 30;"),
]


def build_variants() -> dict:
    """{(source, label): C entry point} of every variant, built at once."""
    procs = {}
    for name, label, old, new in VARIANTS:
        src = (build.CSRC / f"{name}.cu").read_text()
        if src.count(old) != 1:
            cs.fail(f"{name}.cu: no single line {old!r} to change")
        out = ROOT / "build" / "variants" / f"{name}-{label}"
        out.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out)
        (out / f"{name}.cu").write_text(src.replace(old, new))
        lib = out / f"{name}.so"
        procs[name, label] = lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (name, label), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for {name} {label}:\n{log}")
        fns[name, label] = fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes, fn.restype = ARGTYPES[name], ctypes.c_int
    return fns


def flash(fn, q, k, v):
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H,
             k.shape[2], D, 1, -1, 0, D ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        cs.fail(f"flash_attention: CUDA error {err}")
    return out


def paged(fn, q, kp, vp, clen, bt):
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), clen.data_ptr(), bt.data_ptr(),
             out.data_ptr(), B, T, H, kp.shape[2], D, kp.shape[0], kp.shape[1], bt.shape[1],
             -1, D ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        cs.fail(f"decode_attention_paged: CUDA error {err}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    fns = build_variants()
    for name in ARGTYPES:
        fns[name, "as built"] = build.load(name, ARGTYPES[name])
    g = torch.Generator(device="cuda").manual_seed(0)
    H, K, D = 16, 8, 128
    for B, S in ((4, 512), (2, 256)):
        sets = cs.copies(lambda B=B, S=S: tuple(
            torch.randn(B, S, h, D, generator=g, device="cuda").to(torch.bfloat16)
            for h in (H, K, K)), 2 * B * S * (H + 2 * K) * D)
        want = ref.flash_attention(*sets[0])
        for label in ("as built", "WGS=2"):
            fn = fns["flash_attention", label]
            e = cs.check(f"flash {label} B={B} S={S}", flash(fn, *sets[0]), want, "bfloat16")
            ms = cs.timed(lambda i, fn=fn, sets=sets: flash(fn, *sets[i % len(sets)]), 50)
            print(f"flash_wgmma_kernel {label} B={B} S={S} causal: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")

    pools = tuple(torch.randn(4096, 16, K, D, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
    perm = torch.randperm(4096, generator=g, device="cuda").tolist()
    for label, Ts in (("as built", (256, 1024)), ("WGS=1", (256, 1024)),
                      ("paged_prefill_kernel", (5, 9, 16, 32)),
                      ("paged_decode_kernel", (5, 9, 16, 32))):
        fn = fns["decode_attention_paged", label]
        for T in Ts:  # 8 disjoint page sets of 8 rows x 1024 positions
            sets = [cs.paged_case(g, 8, T, "bfloat16", [1024] * 8, K=K, D=D,
                                  perm=perm[i * 512:(i + 1) * 512], pools=pools)
                    for i in range(8)]
            e = cs.check(f"paged {label} T={T}", paged(fn, *sets[0]),
                         ref.decode_attention_paged(*sets[0]), "bfloat16")
            ms = cs.timed(lambda i, fn=fn, sets=sets: paged(fn, *sets[i % 8]),
                          20 if T > 100 else 100)
            print(f"decode_attention_paged {label} B=8 T={T} over 1024 positions: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")
    print(f"nvidia-smi: {smi}")


if __name__ == "__main__":
    main()
