"""Time the compile-time choices of the bf16 tensor-core kernels on one NVIDIA GPU.

    python3 attention_variants.py        # from the root of a checkout

The kernels fix their choices as constants.  ``csrc/flash_attention.cu`` (K2)
has ``WGS``, the consumer warpgroups (64 query rows each) of a block (1).
``csrc/attention_tile.cuh`` has those of the split-KV walk that K1
(``decode_attention.cu``) and K3 (``decode_attention_paged.cu``) share:
``STAGES``, the K/V tiles a block keeps staged or in flight (3);
``MAX_SPLIT``, the most splits of a query tile's KV range (8; 1 turns
split-KV off); ``FILL``, the blocks per SM the split count aims for (1; 2
puts two blocks on an SM, each over half the range, which is what two
warpgroups splitting one block's range would walk).  ``csrc/ssd_scan.cu``
(K4) has ``MAX_BLOCKS``, the most spans (blocks of one cluster) a (row,
head)'s chunks are cut into (8; fewer make each block walk more chunks in
series, 1 is one block a head), ``STAGES``, its chunk stages (1; 2 lets a
block whose span holds more than one chunk prefetch the next), and
``MIN_BLOCKS``, the blocks an SM its registers are held to (3; 2 lifts the
cap from 168 registers a thread to 255).  This writes copies of
the sources with one of those lines changed under ``build/variants/``,
builds them with the port's nvcc flags (one nvcc each, all at once), holds
each against the plain version and times it beside the kernels as built, at
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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

ARGTYPES = {"flash_attention": fa._ARGTYPES, "decode_attention": da._ARGTYPES,
            "decode_attention_paged": da._PAGED_ARGTYPES, "ssd_scan": ssd._ARGTYPES}
HEADER = "attention_tile.cuh"
# (edited file, label, [(the line as built, the line in the copy), ...]); an
# edit of the header builds every source that includes it
VARIANTS = [
    ("flash_attention.cu", "WGS=2", [("constexpr int WGS = 1;", "constexpr int WGS = 2;")]),
    (HEADER, "no split", [("constexpr int MAX_SPLIT = 8;", "constexpr int MAX_SPLIT = 1;")]),
    (HEADER, "FILL=2", [("constexpr int FILL = 1;", "constexpr int FILL = 2;")]),
    (HEADER, "FILL=2 STAGES=2", [("constexpr int FILL = 1;", "constexpr int FILL = 2;"),
                                 ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    (HEADER, "STAGES=2", [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]),
    (HEADER, "STAGES=4", [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]),
    ("ssd_scan.cu", "MAX_BLOCKS=4", [("constexpr int MAX_BLOCKS = 8;",
                                      "constexpr int MAX_BLOCKS = 4;")]),
    ("ssd_scan.cu", "MAX_BLOCKS=2", [("constexpr int MAX_BLOCKS = 8;",
                                      "constexpr int MAX_BLOCKS = 2;")]),
    ("ssd_scan.cu", "MAX_BLOCKS=1", [("constexpr int MAX_BLOCKS = 8;",
                                      "constexpr int MAX_BLOCKS = 1;")]),
    ("ssd_scan.cu", "STAGES=2", [("constexpr int STAGES = 1;       // chunk stages",
                                  "constexpr int STAGES = 2;       // chunk stages")]),
    ("ssd_scan.cu", "MIN_BLOCKS=2", [("constexpr int MIN_BLOCKS = 3;",
                                      "constexpr int MIN_BLOCKS = 2;")]),
]


def compile_lib(out: Path, name: str):
    return subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants() -> dict:
    """{(source, label): C entry point} of every variant, built at once."""
    procs = {}
    for edited, label, edits in VARIANTS:
        text = (build.CSRC / edited).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                cs.fail(f"{edited}: no single line {old!r} to change")
            text = text.replace(old, new)
        names = [edited[:-3]] if edited.endswith(".cu") else \
            ["decode_attention", "decode_attention_paged"]
        for name in names:
            out = ROOT / "build" / "variants" / f"{name}-{label.replace(' ', '_')}"
            out.mkdir(parents=True, exist_ok=True)
            for src in (*build.CSRC.glob("*.cuh"), build.CSRC / f"{name}.cu"):
                shutil.copy(src, out)
            (out / edited).write_text(text)
            procs[name, label] = out / f"{name}.so", compile_lib(out, name)
    fns = {}
    for (name, label), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed for {name} {label}:\n{log}")
        fns[name, label] = fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes, fn.restype = ARGTYPES[name], ctypes.c_int
    return fns


def call(name, fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        cs.fail(f"{name}: CUDA error {err}")


def flash(fn, q, k, v):
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    call("flash_attention", fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
         B, Sq, k.shape[1], H, k.shape[2], D, 1, -1, 0, D ** -0.5, 1)
    return out


def decode(fn, q, k, v, clen, pos):
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    call("decode_attention", fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), clen.data_ptr(),
         pos.data_ptr(), out.data_ptr(), B, T, H, k.shape[2], D, k.shape[1], -1, D ** -0.5, 1)
    return out


def paged(fn, q, kp, vp, clen, bt):
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    call("decode_attention_paged", fn, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
         clen.data_ptr(), bt.data_ptr(), out.data_ptr(), B, T, H, kp.shape[2], D, kp.shape[0],
         kp.shape[1], bt.shape[1], -1, D ** -0.5, 1)
    return out


def ssd(fn, x, dt, A, Bm, C):
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    sf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    call("ssd_scan", fn, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
         None, y.data_ptr(), sf.data_ptr(), B, S, H, G, P, N, *x.stride()[:2], *dt.stride()[:2],
         *Bm.stride()[:2], *C.stride()[:2], 1)
    return y, sf


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    fns = build_variants()
    for name in ARGTYPES:
        fns[name, "as built"] = build.load(name, ARGTYPES[name])
    labels = {name: [lb for n, lb in fns if n == name] for name in ARGTYPES}
    g = torch.Generator(device="cuda").manual_seed(0)
    H, K, D = 16, 8, 128
    for B, S in ((4, 512), (2, 256)):
        sets = cs.copies(lambda B=B, S=S: tuple(
            torch.randn(B, S, h, D, generator=g, device="cuda").to(torch.bfloat16)
            for h in (H, K, K)), 2 * B * S * (H + 2 * K) * D)
        want = ref.flash_attention(*sets[0])
        for label in labels["flash_attention"]:
            fn = fns["flash_attention", label]
            e = cs.check(f"flash {label} B={B} S={S}", flash(fn, *sets[0]), want, "bfloat16")
            ms = cs.timed(lambda i, fn=fn, sets=sets: flash(fn, *sets[i % len(sets)]), 50)
            print(f"flash_wgmma_kernel {label} B={B} S={S} causal: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")

    S = 512
    # the cache full, as chip_smoke.py times K1: decode and verify, and the
    # chunked serve's chunk step (4 staging rows, a chunk of 64)
    for B, T in ((8, 1), (8, 5), (8, 9), (4, 64)):
        sets = cs.copies(lambda B=B, T=T: cs.decode_case(g, B, T, S, H, K, D, "bfloat16",
                                                         [S - T] * B, poison=False),
                         2 * B * S * K * D * 2)
        want = ref.decode_attention(*sets[0][:4], kv_positions=sets[0][4])
        for label in labels["decode_attention"]:
            fn = fns["decode_attention", label]
            e = cs.check(f"decode {label} T={T}", decode(fn, *sets[0]), want, "bfloat16")
            ms = cs.timed(lambda i, fn=fn, sets=sets: decode(fn, *sets[i % len(sets)]), 200)
            print(f"decode_attention {label} B={B} T={T} S={S}: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")

    pools = tuple(torch.randn(4096, 16, K, D, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
    perm = torch.randperm(4096, generator=g, device="cuda").tolist()
    for T in (1, 9, 256, 1024):  # 8 disjoint page sets of 8 rows x 1024 positions
        sets = [cs.paged_case(g, 8, T, "bfloat16", [1024] * 8, K=K, D=D,
                              perm=perm[i * 512:(i + 1) * 512], pools=pools)
                for i in range(8)]
        want = ref.decode_attention_paged(*sets[0])
        for label in labels["decode_attention_paged"]:
            fn = fns["decode_attention_paged", label]
            e = cs.check(f"paged {label} T={T}", paged(fn, *sets[0]), want, "bfloat16")
            ms = cs.timed(lambda i, fn=fn, sets=sets: paged(fn, *sets[i % 8]),
                          20 if T > 100 else 200)
            print(f"decode_attention_paged {label} B=8 T={T} over 1024 positions: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")

    for S in (400, 1000, 2048):  # the serve shape, and 2 and 4 chunks a block
        sets = cs.copies(lambda S=S: cs.ssd_case(g, 1, S, 80, 64, 1, 128, "bfloat16"),
                         S * (80 * 64 * 2 + 256 * 2 + 80 * 4))
        wy, ws = ref.ssd_scan(*sets[0][:5], chunk=256)
        for label in labels["ssd_scan"]:
            fn = fns["ssd_scan", label]
            y, sf = ssd(fn, *sets[0][:5])
            e = max(cs.check(f"ssd {label} S={S}", y, wy, "bfloat16", cs.SSD_TOL),
                    cs.check(f"ssd {label} S={S} state", sf, ws, "bfloat16", cs.SSD_TOL))
            ms = cs.timed(lambda i, fn=fn, sets=sets: ssd(fn, *sets[i % len(sets)][:5]), 100)
            print(f"ssd_scan {label} B=1 S={S} H=80 P=64 N=128: {ms:.4f} ms "
                  f"(max_abs_err {e:.3g})")
    print(f"nvidia-smi: {smi}")


if __name__ == "__main__":
    main()
