"""Kernel F's tap loops in SASS, counted by class.

    python -m zig_vulkan_tpu_torch.benchmarks.kernel_f [OTHER_LIBRARY.so ...]

Builds the port's kernel library from csrc/ (`_build.build`) and counts
the SASS instructions of each kernel F function's tap loop by class
(`cuobjdump -sass`; the loop is the longest backward branch's body in the
function), in that library and in each library given (another tree's
kernel F). One JSON line a library. Needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from .. import _build

# SASS opcodes by class (the opcode before its first '.')
_CLASSES = {
    "MUFU": ("MUFU",),
    "FP32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "FSWZADD"),
    "conversion": ("I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND"),
    "integer": ("IADD3", "IMAD", "IMNMX", "VIMNMX", "ISETP", "LOP3", "SHF",
                "LEA", "SEL", "IABS", "MOV", "PRMT", "IADD", "IMUL", "POPC",
                "FLO", "P2R", "R2P", "PLOP3", "UIADD3", "UMOV", "ULOP3",
                "ULEA", "USEL", "UISETP", "UIMAD", "USHF", "S2R", "S2UR",
                "CS2R", "UPRMT", "VIADD"),
    "LDG": ("LDG", "LD"),
    "LDS": ("LDS",),
    "LDC": ("LDC", "ULDC"),
    "store": ("STG", "STS", "ST", "STL"),
    "branch": ("BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET", "EXIT",
               "WARPSYNC", "BAR", "JMP", "BMOV"),
}
_CLASS_OF = {op: k for k, ops in _CLASSES.items() for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def sass_loops(path) -> dict:
    """{function: the longest loop's instruction counts by class} of the
    kernel F functions in the library at `path` (`cuobjdump -sass`)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if "denoise_kernel" not in name and "resample_kernel" not in name:
            continue
        insns, labels, pending = [], {}, []
        for ln in chunk.splitlines():
            m = _LABEL.match(ln)
            if m:
                pending.append(m[1])
                continue
            m = _INSN.search(ln)
            if not m:
                continue
            addr = int(m[1], 16)
            for label in pending:
                labels[label] = addr
            pending = []
            insns.append((addr, m[2].split(".")[0], m[3]))
        best = None
        for addr, op, rest in insns:
            if op != "BRA":
                continue
            t = _TARGET.search(rest)
            if not t:
                continue
            target = labels.get(t[1]) if t[1] else int(t[2], 16)
            if target is not None and target <= addr and (
                    best is None or addr - target > best[1] - best[0]):
                best = (target, addr)
        if best is None:
            continue
        counts = {}
        for addr, op, _ in insns:
            if best[0] <= addr <= best[1]:
                k = _CLASS_OF.get(op, "other")
                counts[k] = counts.get(k, 0) + 1
        counts["total"] = sum(counts.values())
        out[name] = counts
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("libraries", nargs="*", default=[])
    args = p.parse_args(argv)
    for path in [_build.build(), *args.libraries]:
        print(json.dumps(dict(library=str(path), tap_loops=sass_loops(path))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
