"""Run the port's tensor-core kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu, csrc/softmax_xent.cu) on the CPU through an
emulation of the CUDA they use, and hold them against their plain
PyTorch versions, so that fragment addresses, swizzles, masks and
pipelines can be checked where there is no nvcc and no card.

    python3 port_tools/cuda_emu/emulate.py [--dims 32 64 128 256]
        [--kernels flash xent] [--src DIR]

Each source is compiled by g++ (C++20) with this directory's headers in
front of CUDA's: `kernel<<<grid, block, smem, stream>>>(...)` becomes
`emu_launch(kernel, grid, block, smem, ...)`, and the inline-PTX helpers
of csrc/mma_bf16.cuh (cp.async, ldmatrix, mma.sync) are replaced by
emulations of their PTX semantics (emu_tc.h); everything else of the
header (the swizzle, the fragment addressing, the bf16 packing) is
compiled as written. Each CUDA thread is a host thread and the blocks
of a grid run one after another, so use small shapes (T = 128 and 192
for the flash kernels, each without and with the dropout keep mask and
the lse cotangent, a full run of the four head dims taking
several minutes; N = 144 rows and V = 200 or 203 for the bf16 softmax-xent
head, K8 and both K9 kernels, at d = 256 and 384). The emulation says
nothing about speed, registers or what nvcc accepts.
`--src` points at another copy of csrc/ (for a deliberately broken
copy, to see a check fail). Exits 1 if any case disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.ops import (  # noqa: E402
    fused_softmax_xent as fsx)

BUILD = ROOT / "deeplearning4j_tpu_torch" / "_build" / "emu"
ASM_HELPERS = ("smem_addr", "cp_async", "cp_async_commit", "cp_async_wait",
               "ldsm_x4", "ldsm_x4_t", "mma")
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<\s*(.+?)\s*,\s*(\w+)\s*,"
                    r"\s*(\w+)\s*,\s*(\w+)\s*>>>\s*\(", re.S)
DEFS = """
namespace { alignas(128) float smem[232448 / 4];
namespace tcf { alignas(128) unsigned char smem_raw[232448]; }
namespace tcx { alignas(128) unsigned char smem_raw[232448]; } }
thread_local uint3e threadIdx, blockIdx;
dim3 blockDim, gridDim;
EmuBlock* g_blk;
thread_local std::deque<std::vector<tc::EmuCopy>> tc::emu_groups;
thread_local std::vector<tc::EmuCopy> tc::emu_open;
static void poison() {
  std::memset(smem, 0xff, sizeof smem);
  std::memset(tcf::smem_raw, 0xff, sizeof tcf::smem_raw);
  std::memset(tcx::smem_raw, 0xff, sizeof tcx::smem_raw);
}
void (*emu_poison)() = poison;
"""


def emulated_header(src_dir):
    """csrc/mma_bf16.cuh with its inline-PTX helpers swapped for
    emu_tc.h."""
    text = (src_dir / "mma_bf16.cuh").read_text()
    head = re.compile(r"^(template <[^\n]*>\n)?__device__ __forceinline__ "
                      r"[^\n(]*?\b(\w+)\(", re.M)
    out, last, placed = [], 0, False
    for m in head.finditer(text):
        if m.group(2) not in ASM_HELPERS:
            continue
        depth, j = 0, text.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            j += 1
            if depth == 0:
                break
        out.append(text[last:m.start()])
        if not placed:
            out.append('#include "emu_tc.h"\n')
            placed = True
        last = j
    out.append(text[last:])
    return "".join(out)


def build(name, src_dir, out_dir=BUILD):
    """csrc/<name>.cu compiled for the emulation into out_dir, loaded."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_bf16.cuh").write_text(emulated_header(src_dir))
    src = (src_dir / f"{name}.cu").read_text()
    src = src.replace('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                      '"f"(x));', "y = std::exp2(x);")
    src = LAUNCH.sub(lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, "
                     f"{m.group(3)}, {m.group(4)}, ", src)
    cpp, lib = out_dir / f"{name}.cpp", out_dir / f"lib{name}.so"
    cpp.write_text(src + DEFS)
    out = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
         f"-I{out_dir}", f"-I{HERE}", f"-I{src_dir}", "-o", str(lib),
         str(cpp)],
        capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"g++ failed for {name}.cu:\n{out.stderr[:6000]}")
    return ctypes.CDLL(str(lib))


def bht(t):
    return fa._bht(t)


def run_case(fwd, bwd, D, dtype, causal, masked, packed, T, gen,
             dropout=False, dlse=False):
    """One forward and one backward through the emulated kernels against
    `_flash_fwd_reference` and `_flash_bwd_reference`; returns (ok,
    report line). `dropout`: the keep mask at rate 0.1 (the flat layout
    at the window origin (T, 0) of a sequence of 4T, as a chunk tile
    sees it; the packed layout at origin 0), in both the kernels and the
    plain versions. `dlse`: a random lse cotangent into the backward."""
    B, H = (2, 2) if packed else (3, 1)
    if packed:
        qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(dtype)
        q, k, v = (t.unflatten(-1, (H, D)).transpose(1, 2)
                   for t in qkv.split(H * D, -1))
    else:
        q, k, v = (torch.randn(B, H, T, D, generator=gen).to(dtype)
                   for _ in range(3))
    km = None
    if masked:  # ragged rows, the last one all masked
        km = torch.zeros(B, T)
        for r in range(B - 1):
            km[r, :int(torch.randint(T // 4, T, (1,), generator=gen))] = 1
    kmr = None if km is None else km.repeat_interleave(H, 0)

    def flat(t):
        return t.reshape(B * H, T, D)

    scale = D ** -0.5
    dt = fa._KERNEL_DTYPES[dtype]
    kmp = None if km is None else km.data_ptr()
    drop = None
    if dropout:
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             dtype=torch.int32)
        drop = (fa._Drop(seed, 0.1) if packed
                else fa._Drop(seed, 0.1, T, 0, 4 * T))
    drop_args = fa._drop_args(drop, T)

    o = torch.empty(B, T, H, D, dtype=dtype).transpose(1, 2)
    lse = torch.empty(B * H, T)
    rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmp, o.data_ptr(),
             lse.data_ptr(), dt, D, B, H, T, *bht(q), *bht(k), *bht(v),
             *bht(o), scale, int(causal), *drop_args, None)
    ro, rlse = fa._flash_fwd_reference(flat(q), flat(k), flat(v), kmr,
                                       scale, causal, drop)
    err_o = float((flat(o).float() - ro.float()).abs().max())
    err_l = float((lse - rlse).abs().max())
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    ok = rc == 0 and err_o <= tol[0] and err_l <= tol[1]
    if masked:
        ok = ok and bool((o[-1] == 0).all()) \
            and float(lse.view(B * H, T)[-1].max()) < -1e19

    do = torch.randn(B, H, T, D, generator=gen).to(dtype)
    ro4 = ro.reshape(B, H, T, D)
    grads = [torch.empty(B, H, T, D, dtype=dtype) for _ in range(3)]
    delta = torch.empty(B * H, T)
    dl = torch.randn(B * H, T, generator=gen) if dlse else None
    views = [q, k, v, ro4, do] + grads
    st = (ctypes.c_longlong * 24)(*[s for t in views for s in bht(t)])
    rc_b = bwd(*(t.data_ptr() for t in (q, k, v, ro4, do)), rlse.data_ptr(),
               kmp, delta.data_ptr(),
               *(g.data_ptr() for g in grads), dt, D, B, H, T, st, scale,
               int(causal), None if dl is None else dl.data_ptr(),
               *drop_args, None)
    refs = fa._flash_bwd_reference(flat(q), flat(k), flat(v), ro, rlse,
                                   flat(do), kmr, scale, causal, dl, drop)
    err_b = max(float((flat(g).float() - r.float()).abs().max())
                / float(r.float().abs().max()) for g, r in zip(grads, refs))
    ok_b = rc_b == 0 and err_b <= (1e-4 if dtype == torch.float32 else 2e-2)
    line = (f"D={D} T={T} {str(dtype)[6:]} causal={causal} masked={masked} "
            f"packed={packed} dropout={dropout} dlse={dlse}: fwd |o| "
            f"{err_o:.2e} |lse| {err_l:.2e} "
            f"{'ok' if ok else 'FAIL'}; bwd rel {err_b:.2e} "
            f"{'ok' if ok_b else 'FAIL'}")
    return ok and ok_b, line


def entry_points(src_dir, out_dir=BUILD):
    """(flash_fwd, flash_bwd) of the emulated sources, typed as the
    wrappers in ops/flash_attention.py call them."""
    fwd = build("flash_fwd", src_dir, out_dir).flash_fwd
    bwd = build("flash_bwd", src_dir, out_dir).flash_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes, bwd.argtypes = fa._FWD_ARGTYPES, fa._BWD_ARGTYPES
    return fwd, bwd


def xent_entry_points(src_dir, out_dir=BUILD):
    """The C entry points of the emulated csrc/softmax_xent.cu by name,
    typed as ops/fused_softmax_xent.py calls them."""
    lib = build("softmax_xent", src_dir, out_dir)
    fns = {}
    for name, types in fsx._FN_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
        fns[name] = fn
    return fns


def rel_err(x, ref):
    """max |x - ref| over max |ref|."""
    ref = ref.float()
    return float((x.float() - ref).abs().max()) / float(ref.abs().max())


def run_xent_case(fns, N, d, V, gen):
    """The bf16 head through the emulated kernels: K8 (`xent_fwd`)
    against `_xent_fwd_reference`, and K9 (`xent_bwd_dx`,
    `xent_bwd_dwdb` with its slices and reduce) against
    `_xent_bwd_reference` on the reference's lse; each output within
    phase 2b's limit of its largest entry: 1e-4 for K8's loss and lse
    (f32 in both, from the same exact products), 2e-2 for K9's bf16
    gradients. Returns (ok, report line)."""
    x = torch.randn(N, d, generator=gen).bfloat16()
    w = (0.05 * torch.randn(d, V, generator=gen)).bfloat16()
    b = (0.01 * torch.randn(V, generator=gen)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    g = torch.rand(N, generator=gen) / N
    ptr = [t.data_ptr() for t in (x, w, b, labels)]

    loss, lse = torch.empty(N), torch.empty(N)
    rc = fns["xent_fwd"](*ptr, loss.data_ptr(), lse.data_ptr(), 1, N, d, V,
                         None)
    rloss, rlse = fsx._xent_fwd_reference(x, w, b, labels)
    err_f = max(rel_err(loss, rloss), rel_err(lse, rlse))

    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty(V)
    slices = fns["xent_dw_slices"](N, d, V)
    work = torch.empty(max(slices, 1) * (d + 1) * (-(-V // 64) * 64))
    rc_b = [fns["xent_bwd_dx"](*ptr, rlse.data_ptr(), g.data_ptr(),
                               dx.data_ptr(), 1, N, d, V, None),
            fns["xent_bwd_dwdb"](*ptr, rlse.data_ptr(), g.data_ptr(),
                                 dw.data_ptr(), db.data_ptr(),
                                 work.data_ptr(), slices, 1, N, d, V, None)]
    refs = fsx._xent_bwd_reference(x, w, b, labels, rlse, g)
    err_b = max(rel_err(a, r) for a, r in zip((dx, dw, db), refs))
    ok = rc == 0 and err_f <= 1e-4 and bool(torch.isfinite(loss).all())
    ok_b = rc_b == [0, 0] and slices >= 1 and err_b <= 2e-2
    line = (f"xent N={N} d={d} V={V} bf16: K8 loss/lse rel {err_f:.2e} "
            f"{'ok' if ok else 'FAIL'}; K9 dx/dW/db rel {err_b:.2e} "
            f"({slices} slices) {'ok' if ok_b else 'FAIL'}")
    return ok and ok_b, line


XENT_SHAPES = ((144, 256, 200), (144, 256, 203), (144, 384, 200))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="*",
                    default=[32, 64, 128, 256])
    ap.add_argument("--kernels", nargs="*", choices=["flash", "xent"],
                    default=["flash", "xent"])
    ap.add_argument("--src", type=Path,
                    default=ROOT / "deeplearning4j_tpu_torch" / "csrc")
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(0)
    failed = 0
    if "xent" in args.kernels:
        fns = xent_entry_points(args.src)
        for N, d, V in XENT_SHAPES:
            ok, line = run_xent_case(fns, N, d, V, gen)
            print(line, flush=True)
            failed += not ok
    fwd, bwd = entry_points(args.src) if "flash" in args.kernels else (
        None, None)
    for D in args.dims if "flash" in args.kernels else ():
        for dtype in (torch.bfloat16, torch.float32):
            for causal, masked, packed in ((True, True, False),
                                           (True, False, True),
                                           (False, False, False)):
                for T in (128, 192):
                    for on in (False, True):
                        ok, line = run_case(fwd, bwd, D, dtype, causal,
                                            masked, packed, T, gen,
                                            dropout=on, dlse=on and not packed)
                        print(line, flush=True)
                        failed += not ok
    print(f"{failed} case(s) failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
