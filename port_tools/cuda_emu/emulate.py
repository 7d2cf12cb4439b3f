"""Run the port's hand-written kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu, csrc/softmax_xent.cu, csrc/layernorm.cu,
csrc/sampling.cu) on the CPU through an emulation of the CUDA they use,
and hold them against their plain PyTorch versions, so that fragment
addresses, swizzles, masks, pipelines and cluster reductions can be
checked where there is no nvcc and no card.

    python3 port_tools/cuda_emu/emulate.py [--dims 32 64 128 256]
        [--kernels flash xent ln sample] [--src DIR]

Each source is compiled by g++ (C++20) with this directory's headers in
front of CUDA's: `kernel<<<grid, block, smem, stream>>>(...)` becomes
`emu_launch(kernel, grid, block, smem, ...)`, and the inline-PTX helpers
of csrc/mma_bf16.cuh (cp.async, ldmatrix, mma.sync) are replaced by
emulations of their PTX semantics (emu_tc.h); everything else of the
header (the swizzle, the fragment addressing, the bf16 packing) is
compiled as written. Each CUDA thread is a host thread and the blocks
of a grid run one after another, except the blocks of a thread-block
cluster (a cudaLaunchKernelEx launch, csrc/sampling.cu), which run
together, each with its own dynamic shared memory, with cluster.sync()
a barrier of all their threads and map_shared_rank the address in
another block's (cooperative_groups.h). Use small shapes (T = 128 and
192 for the flash kernels, each without and with the dropout keep mask
and the lse cotangent, a full run of the four head dims taking several
minutes; N = 144 rows and V = 200 or 203 for the bf16 softmax-xent head,
K8 and both K9 kernels, at d = 256 and 384; LN_CASES for K10 and K11;
SAMPLE_SHAPES and SAMPLE_PLANS for K12, in every mode of chip_smoke.py's
SAMPLE_MODES, a few seconds). The emulation says nothing about speed,
registers or what nvcc accepts.
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

from chip_smoke import LN_TOL, SAMPLE_MODES, same_bits  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.ops import fused_layernorm as fln  # noqa: E402
from deeplearning4j_tpu_torch.ops import fused_sampling as fsm  # noqa: E402
from deeplearning4j_tpu_torch.ops import (  # noqa: E402
    fused_softmax_xent as fsx)

BUILD = ROOT / "deeplearning4j_tpu_torch" / "_build" / "emu"
ASM_HELPERS = ("smem_addr", "cp_async", "cp_async_commit", "cp_async_wait",
               "ldsm_x4", "ldsm_x4_t", "mma")
# csrc/sampling.cu's accessor of the block's dynamic shared memory, which
# the emulation gives each block of a cluster its own of
BLOCK_SMEM = """__device__ __forceinline__ uint32_t* block_smem() {
  extern __shared__ __align__(16) uint32_t smem_words[];
  return smem_words;
}"""
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<\s*(.+?)\s*,\s*(\w+)\s*,"
                    r"\s*(\w+)\s*,\s*(\w+)\s*>>>\s*\(", re.S)
DEFS = """
namespace { alignas(128) float smem[232448 / 4];
namespace tcf { alignas(128) unsigned char smem_raw[232448]; }
namespace tcx { alignas(128) unsigned char smem_raw[232448]; } }
thread_local uint3e threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local EmuBlock* g_blk;
thread_local EmuCluster* g_cluster;
thread_local unsigned g_rank;
thread_local unsigned char* g_smem;
static void poison() {
  std::memset(smem, 0xff, sizeof smem);
  std::memset(tcf::smem_raw, 0xff, sizeof tcf::smem_raw);
  std::memset(tcx::smem_raw, 0xff, sizeof tcx::smem_raw);
}
void (*emu_poison)() = poison;
"""
# the cp.async groups of emu_tc.h, for the sources that include
# csrc/mma_bf16.cuh
TC_DEFS = """
thread_local std::deque<std::vector<tc::EmuCopy>> tc::emu_groups;
thread_local std::vector<tc::EmuCopy> tc::emu_open;
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
    src = src.replace(BLOCK_SMEM, "inline uint32_t* block_smem() {\n"
                      "  return static_cast<uint32_t*>(emu_block_smem());\n}")
    src = LAUNCH.sub(lambda m: f"emu_launch({m.group(1)}, {m.group(2)}, "
                     f"{m.group(3)}, {m.group(4)}, ", src)
    cpp, lib = out_dir / f"{name}.cpp", out_dir / f"lib{name}.so"
    cpp.write_text(src + DEFS + (TC_DEFS if '"mma_bf16.cuh"' in src else ""))
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


def ln_entry_points(src_dir, out_dir=BUILD):
    """The C entry points of the emulated csrc/layernorm.cu by name,
    typed as ops/fused_layernorm.py calls them."""
    lib = build("layernorm", src_dir, out_dir)
    fns = {}
    for name, types in fln._FN_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
        fns[name] = fn
    return fns


def _offset(t):
    """A contiguous copy of t one element past a 16-byte boundary (a view
    of a flat buffer)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    return out.copy_(t)


def run_ln_case(fns, N, C, dtype, gen, misaligned="", nv=None, blocks=None):
    """K10 and K11 through the emulated kernels against
    `_ln_fwd_reference` and `_ln_bwd_reference`: y, mu, rstd, dx,
    dgamma and dbeta within phase 9's LN_TOL of their largest entry (mu
    and rstd, f32 in both, within the f32 limit). K10's instantiation is
    `_fwd_plan`'s (or `nv`, to force one), K11's `_bwd_plan`'s, its
    block count forced to `blocks` where given (several rows a warp and
    partials from several blocks at a small N). `misaligned` ("x" or
    "dy") puts that tensor one element past a 16-byte boundary, which
    the plans must send to the general path. K11 runs twice and must
    repeat bit for bit. Returns (ok, report line)."""
    dname = str(dtype).split(".")[-1]
    x = (1.5 * torch.randn(N, C, generator=gen) + 0.3).to(dtype)
    if misaligned == "x":
        x = _offset(x)
    g = (1 + 0.2 * torch.randn(C, generator=gen)).to(dtype)
    b = (0.1 * torch.randn(C, generator=gen)).to(dtype)
    dy = torch.randn(N, C, generator=gen).to(dtype)
    if misaligned == "dy":
        dy = _offset(dy)
    y, stats = torch.empty(N, C, dtype=dtype), torch.empty(2, N)
    ptrs = tuple(t.data_ptr() for t in (x, g, b, y))
    plan = fln._fwd_plan(C, x.element_size(), ptrs) if nv is None else nv
    dt = fln._KERNEL_DTYPES[dtype]
    rc = fns["ln_fwd"](*ptrs, stats.data_ptr(), dt, plan, N, C, 1e-5, None)
    ry, rmu, rrstd = fln._ln_fwd_reference(x, g, b, 1e-5)
    err_f = rel_err(y, ry)
    err_s = max(rel_err(stats[0], rmu), rel_err(stats[1], rrstd))

    runs, rc_b = [], []
    for _ in range(2):
        dx = torch.empty_like(x)
        bnv, nblocks = fln._bwd_plan(N, C, x.element_size(), tuple(
            t.data_ptr() for t in (x, g, dy, dx)))
        nblocks = nblocks if blocks is None else blocks
        dgdb = torch.full((1 + nblocks, 2, C), float("nan"))
        rc_b.append(fns["ln_bwd"](x.data_ptr(), g.data_ptr(), rmu.data_ptr(),
                                  rrstd.data_ptr(), dy.data_ptr(),
                                  dx.data_ptr(), dgdb.data_ptr(), dt, bnv,
                                  nblocks, N, C, None))
        runs.append((dx, dgdb[0, 0], dgdb[0, 1]))
    refs = fln._ln_bwd_reference(x, g, rmu, rrstd, dy)
    err_b = max(rel_err(a, r) for a, r in zip(runs[0], refs))
    repeat = same_bits(torch, *runs)
    tol = LN_TOL[dname]
    ok = rc == 0 and err_f <= tol and err_s <= LN_TOL["float32"]
    ok_b = rc_b == [0, 0] and err_b <= tol and repeat
    kind = f"vector nv={plan}" if plan else "general"
    bkind = f"vector nv={bnv}" if bnv else "general"
    line = (f"ln N={N} C={C} {dname}"
            f"{f' misaligned {misaligned}' if misaligned else ''}: K10 "
            f"({kind}) y rel {err_f:.2e} mu/rstd {err_s:.2e} "
            f"{'ok' if ok else 'FAIL'}; K11 ({bkind}, {nblocks} partials) "
            f"rel {err_b:.2e}, two runs "
            f"{'equal bit for bit' if repeat else 'DIFFER'} "
            f"{'ok' if ok_b else 'FAIL'}")
    return ok and ok_b, line


# (N, C, dtype, misaligned, K10's nv, K11's blocks). K10: both
# instantiations (bf16 C = 256 and f32 C = 256: 1 and 2 vectors a lane;
# the same shape forced onto the general kernel), rows that are no
# multiple of a block's 8, the ragged C = 200 and C = 7, and an x one
# element off its 16-byte boundary. K11 on the same cases, its vector
# kernel at bf16 C = 256 and 512 and f32 C = 256 (1, 2 and 2 vectors a
# lane), 3 blocks at N = 40 (warps of several rows, the sum over
# blocks), N = 1 and N = 5 (fewer rows than a block's 8 warps), and its
# general path for C = 200, C = 7, f32 C = 512 and bf16 C = 1024 (past 2
# vectors a lane) and an unaligned x or dy
LN_CASES = ((40, 256, torch.bfloat16, "", None, None),
            (40, 256, torch.float32, "", None, None),
            (40, 256, torch.bfloat16, "", 0, None),
            (13, 512, torch.bfloat16, "", None, None),
            (13, 200, torch.float32, "", None, None),
            (13, 200, torch.bfloat16, "", None, None),
            (5, 7, torch.float32, "", None, None),
            (11, 256, torch.bfloat16, "x", None, None),
            (40, 256, torch.bfloat16, "", None, 3),
            (40, 256, torch.float32, "", None, 3),
            (1, 256, torch.bfloat16, "", None, None),
            (5, 256, torch.float32, "", None, None),
            (13, 512, torch.float32, "", None, None),
            (9, 1024, torch.bfloat16, "", None, None),
            (11, 256, torch.bfloat16, "dy", None, None))


def sample_entry_point(src_dir, out_dir=BUILD):
    """The emulated csrc/sampling.cu `fused_sample`, typed as
    ops/fused_sampling.py calls it."""
    fn = build("sampling", src_dir, out_dir).fused_sample
    fn.restype, fn.argtypes = ctypes.c_int, fsm._FN_ARGTYPES
    return fn


def run_sample_case(fn, B, V, dtype, mode, gen, plan=None, ties=0):
    """K12 through the emulated kernel against `_select_reference` on
    the same Gumbel noise, in `plan` (threads, cluster; `_plan(B, V)` by
    default): every row's id equal (phase 13 allows a top-p row apart
    only where the nucleus mass lies within an ulp of top_p, which these
    rows do not reach), and the top-k thresholds the kernel writes equal
    `_thresholds_reference`'s binary walk bit for bit. `ties`: that
    many of each row's first logits set to the row's max (more than CAP
    at the top: the top-k walk runs every round). Returns (ok, report
    line)."""
    logits = 3.0 * torch.randn(B, V, generator=gen)
    if ties:
        logits[:, :ties] = logits.amax(-1, keepdim=True)
    logits = logits.to(dtype)
    noise = fsm.gumbel_noise(gen, B, V, "cpu")
    temperature = mode.get("temperature", 1.0)
    k, p = fsm._modes(logits, mode.get("top_k", 0), mode.get("top_p", 1.0))
    threads, cluster = fsm._plan(B, V) if plan is None else plan
    out, thr = torch.empty(B, dtype=torch.int32), torch.empty(B, 2)
    rc = fn(logits.data_ptr(), noise.data_ptr(), out.data_ptr(),
            thr.data_ptr(), fsm._KERNEL_DTYPES[dtype], B, V, temperature,
            k, p, threads, cluster, None)
    ref = fsm._select_reference(logits, noise, **mode)
    rk, _ = fsm._thresholds_reference(logits, temperature, k, p)
    diff = int((out != ref).sum())
    same_k = bool(torch.equal(thr[:, 0], rk))
    ok = rc == 0 and diff == 0 and same_k
    line = (f"sample [{B},{V}] {str(dtype)[6:]} {mode} plan "
            f"{(threads, cluster)}{f' ties {ties}' if ties else ''}: "
            f"{diff} of {B} rows differ, top-k "
            f"thresholds {'equal' if same_k else 'DIFFER'} -> "
            f"{'ok' if ok else 'FAIL'}")
    return ok, line


# K12: `_plan`'s one block at V = 128 (no round over the cluster: every
# element is finished by one warp) and V = 1000, a cluster of 5 at V =
# 4099,
# clusters forced at V = 1000, and a row whose slice overflows shared
# memory (z, P and the score recomputed from global memory)
SAMPLE_SHAPES = ((8, 128), (3, 1000), (2, 4099))
SAMPLE_PLANS = (((3, 1000), (128, 4)), ((2, 1000), (256, 2)),
                ((1, 17500), (128, 1)))
# rows with 200 logits tied at the max, in a cluster of 4
SAMPLE_TIES = ((2, 1000), (128, 4), 200)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, nargs="*",
                    default=[32, 64, 128, 256])
    ap.add_argument("--kernels", nargs="*",
                    choices=["flash", "xent", "ln", "sample"],
                    default=["flash", "xent", "ln", "sample"])
    ap.add_argument("--src", type=Path,
                    default=ROOT / "deeplearning4j_tpu_torch" / "csrc")
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(0)
    failed = 0
    if "ln" in args.kernels:
        fns = ln_entry_points(args.src)
        for N, C, dtype, misaligned, nv, blocks in LN_CASES:
            ok, line = run_ln_case(fns, N, C, dtype, gen, misaligned, nv,
                                   blocks)
            print(line, flush=True)
            failed += not ok
    if "sample" in args.kernels:
        fn = sample_entry_point(args.src)
        cases = [((B, V), dtype, mode, None) for B, V in SAMPLE_SHAPES
                 for dtype in (torch.float32, torch.bfloat16)
                 for _, mode in SAMPLE_MODES]
        cases += [(shape, torch.float32, mode, plan)
                  for shape, plan in SAMPLE_PLANS
                  for _, mode in SAMPLE_MODES[1:4:2]]
        (B, V), plan, ties = SAMPLE_TIES
        cases += [((B, V), torch.float32, mode, plan, ties)
                  for _, mode in SAMPLE_MODES[1:4:2]]
        for (B, V), dtype, mode, plan, *ties in cases:
            ok, line = run_sample_case(fn, B, V, dtype, mode, gen, plan,
                                       *ties)
            print(line, flush=True)
            failed += not ok
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
