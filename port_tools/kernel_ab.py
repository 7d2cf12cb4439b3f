#!/usr/bin/env python3
"""Time the LayerNorm and sampling kernels (K10, K11, K12) of two
checkouts of the port on one card, in turns: other, this, this, other.

    python3 port_tools/kernel_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is another version of the repository (e.g. the parent
commit unpacked by `git archive` into a git-ignored directory). Each
turn is its own process that imports `chip_smoke` and the port from its
checkout, builds that checkout's csrc/layernorm.cu and csrc/sampling.cu,
and runs its phase 9 LayerNorm check (`check_layernorm`) and phase 13
(`check_sampling`), which check each kernel against its plain version
and time it (CUDA events and device time). Prints, for every timed
shape, the device time a launch and the CUDA-event time a call of both
checkouts' turns side by side, each with the other's over this
checkout's, and the device time of each kernel a call ran where the
checkout's phase 9 records it, beside the card's name and power limit;
then, for each kernel of csrc/layernorm.cu and csrc/sampling.cu, whether
the two checkouts' builds hold the same machine code for it (`cuobjdump
-sass`), which tells a kernel that changed from one whose time moved
with the run around it. Kernels are paired by their demangled names,
with a template argument that repeats the one before it dropped, so
that `lnv::fwd_vec<float, float, 2>` (x's type, gamma's type, vectors a
lane) pairs with a checkout's `lnv::fwd_vec<float, 2>` from before the
kernels took a second parameter type. Each turn's log and the records go to
chiprun_out/kernel_ab/. Exits non-zero if a turn fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "kernel_ab"
SOURCES = ("layernorm", "sampling")


def turn(root: Path) -> None:
    """One turn, in this process: phases 9 (K10, K11) and 13 (K12) of
    the checkout at `root`; the records as the last line of stdout."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm

    for mod in (chip_smoke, fln):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise SystemExit(f"kernel_ab: imported {mod.__file__}, not "
                             f"the one of {root}")
    cuda_build.build(SOURCES)
    records = chip_smoke.check_layernorm(torch, fln)
    records.update(chip_smoke.check_sampling(torch, fsm))
    print(json.dumps({"root": str(root),
                      "card": chip_smoke.nvidia_smi("name,power.limit"),
                      "records": records}), flush=True)


def canonical(names: list[str]) -> list[str]:
    """The kernels' mangled `names` demangled (CUDA's cu++filt, else
    c++filt; the anonymous namespace's name, which holds a hash of the
    source's text, becomes "(anonymous namespace)"), with a template
    argument equal to the one before it dropped."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cu++filt")
    text = subprocess.run([str(tool) if tool.exists() else "c++filt"],
                          input="\n".join(names), check=True,
                          capture_output=True, text=True).stdout
    plain = text.splitlines()
    if len(plain) != len(names) or any(n.startswith("_Z") for n in plain):
        raise SystemExit(f"kernel_ab: could not demangle {names[:3]}")
    return [re.sub(r"([<,] ?)([\w:]+), \2(?=[,>])", r"\1\2",
                   _without_parameters(n)) for n in plain]


def _without_parameters(name: str) -> str:
    """A demangled function name without its parameter list (the last
    balanced parentheses), which cu++filt writes in template parameter
    names (T1, T2) that differ where the template's parameters do."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def sass(lib: Path) -> dict[str, str]:
    """Each kernel's SASS in `lib` by its `canonical` name, without the
    instruction addresses and without the hash of the source's text that
    nvcc puts into the anonymous namespace's name."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
        elif name:
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line))
    return dict(zip(canonical(list(out)),
                    ("\n".join(v) for v in out.values())))


def compare_sass(other: Path) -> None:
    """Print, for each kernel of SOURCES, whether this checkout's build
    and `other`'s hold the same SASS; both SASS listings go to
    OUT/sass_<source>_<this|other>.txt."""
    for src in SOURCES:
        rel = Path("deeplearning4j_tpu_torch") / "_build" / f"lib{src}.so"
        mine, theirs = sass(ROOT / rel), sass(other / rel)
        for who, table in (("this", mine), ("other", theirs)):
            (OUT / f"sass_{src}_{who}.txt").write_text("".join(
                f"== {name}\n{text}\n" for name, text in sorted(
                    table.items())))
        for name in sorted(mine.keys() | theirs.keys()):
            state = ("only this" if name not in theirs else "only other"
                     if name not in mine else "same SASS"
                     if mine[name] == theirs[name] else "SASS differs")
            print(f"sass {src} {name}: {state}")


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--turn":
        turn(Path(args[1]).resolve())
        return 0
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, root in enumerate((other, ROOT, ROOT, other)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn",
             str(root)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=1200)
        (OUT / f"turn{i}.log").write_text(proc.stdout)
        if proc.returncode:
            print(proc.stdout[-4000:])
            print(f"kernel_ab: the turn of {root} failed "
                  f"({proc.returncode})")
            return 1
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    (OUT / "records.json").write_text(json.dumps(turns))
    print(f"kernel_ab: card {turns[0]['card']}; other {other}, this {ROOT}")
    for kern in ("K10", "K11", "K12"):
        rows = {}
        for t, who in zip(turns, ("other", "this", "this", "other")):
            for rec in t["records"].get(kern, []):
                row = rows.setdefault(rec["label"], {})
                for key in ("device_ms", "ms", "device_ms_by_kernel"):
                    row.setdefault(key, {"other": [], "this": []})[
                        who].append(rec.get(key))
        for label, row in rows.items():
            for key, name in (("device_ms", "device ms"),
                              ("ms", "event ms")):
                o, n = row[key]["other"], row[key]["this"]
                ratio = (sum(o) / sum(n) if None not in o + n
                         and len(o) == 2 and len(n) == 2 else None)
                print(f"{kern} {label}: {name} other {o}, this {n}; other "
                      f"over this "
                      f"{ratio if ratio is None else f'{ratio:.3f}'}")
            for who in ("other", "this"):
                for by in row["device_ms_by_kernel"][who]:
                    if by:
                        print(f"{kern} {label}: {who}'s device ms by "
                              f"kernel {by}")
    sys.path.insert(0, str(ROOT))
    compare_sass(other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
