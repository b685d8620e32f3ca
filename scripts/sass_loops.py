#!/usr/bin/env python3
"""The loops of a CUDA source's kernels in SASS, with their instruction counts.

    python scripts/sass_loops.py SRC.cu [SRC.cu ...] [--out DIR]

Compiles each source with the port's nvcc flags (gsplat_tpu_torch/_build.py,
sm_90a, --fmad=false) into a cubin under build/sass/, disassembles it with
cuobjdump -sass, and for each kernel lists every loop (a branch back to a
lower address): its address range, its instruction count, its forward
branches that stay inside it (an instruction count for the path through
each), and its mix of opcodes. The full listing of each loop goes to
DIR/<tree>-<source stem>-<n>.sass (default build/sass). Needs nvcc and
cuobjdump (the CUDA toolkit); runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gsplat_tpu_torch import _build  # noqa: E402

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FUNC = re.compile(r"Function : (\S+)")
BRA = re.compile(r"\bBRA(?:\.\w+)*\s+(?:\S+,\s*)?(?:`\()?(0x[0-9a-f]+)")
WIDTH = 16   # bytes per SASS instruction on sm_90


def disassemble(src: Path, build_dir: Path) -> str:
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = build_dir / f"{src.parent.parent.parent.name}-{src.stem}.cubin"
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout


def kernels(sass: str):
    """{kernel: [(address, instruction text)]}"""
    out, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else "?"


def loops(instrs):
    """[(start, end, [(branch, target, path length)])] of every back edge"""
    found = []
    for addr, text in instrs:
        m = BRA.search(text)
        if not m or opcode(text) != "BRA":
            continue
        target = int(m.group(1), 16)
        if target <= addr:
            inner = []
            for a2, t2 in instrs:
                m2 = BRA.search(t2)
                if target <= a2 < addr and m2 and opcode(t2) == "BRA":
                    tg = int(m2.group(1), 16)
                    if a2 < tg <= addr:
                        # [target, a2] then [tg, addr]
                        inner.append((a2, tg, (a2 - target) // WIDTH + 1
                                      + (addr - tg) // WIDTH + 1))
            found.append((target, addr, inner))
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, default=REPO / "build" / "sass")
    args = ap.parse_args()
    build_dir = REPO / "build" / "sass"
    build_dir.mkdir(parents=True, exist_ok=True)
    args.out.mkdir(parents=True, exist_ok=True)
    for src in args.sources:
        src = src.resolve()
        print(f"== {src.relative_to(REPO) if src.is_relative_to(REPO) else src}")
        for name, instrs in kernels(disassemble(src, build_dir)).items():
            print(f"  kernel {name}: {len(instrs)} instructions")
            for i, (start, end, inner) in enumerate(loops(instrs)):
                body = [(a, t) for a, t in instrs if start <= a <= end]
                mix = collections.Counter(opcode(t) for _, t in body)
                tag = f"{src.parent.parent.parent.name}-{src.stem}-{i}"
                (args.out / f"{tag}.sass").write_text(
                    "\n".join(f"/*{a:04x}*/ {t}" for a, t in body) + "\n")
                print(f"    loop {i} [{start:#06x}, {end:#06x}]: {len(body)} instructions "
                      f"({tag}.sass)")
                for br, tg, n in inner:
                    print(f"      forward branch at {br:#06x} to {tg:#06x}: "
                          f"{n} instructions on the path that takes it")
                print("      mix: " + ", ".join(f"{k} {v}" for k, v in mix.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
