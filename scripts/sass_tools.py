"""Static SASS of the kernels in a built library, read with the toolkit's
``cuobjdump``: the instructions of a kernel, their count, and a fingerprint
that moves with any of them.  Used by ``chip_smoke.py`` (B1's SASS pin, B11's
static instruction count) and ``scripts/kernel_ab.py`` (instruction mixes).
Needs the CUDA toolkit.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess

from auvtpu_torch.kernels import build as kbuild

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);")


def sass_functions(lib_path: str, matches: list[str]):
    """(demangled kernel name, SASS text) of the kernels in the library whose
    name, demangled with its template arguments as plain numbers and
    true/false, holds one of ``matches``."""
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc_path()), "cuobjdump")
    filt = shutil.which("cu++filt", path=os.path.dirname(kbuild.nvcc_path())) or shutil.which("c++filt")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    blocks = re.split(r"\n\s*Function : ", text)[1:]
    found = []
    for block in blocks:
        name = block.split("\n", 1)[0].strip()
        if filt:
            name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip() or name
        name = re.sub(r"\((?:unsigned )?int\)", "", name.replace("(bool)1", "true").replace("(bool)0", "false"))
        if any(m in name for m in matches):
            found.append((name, block))
    if not found:
        print(f"SASS {lib_path}: {len(blocks)} functions, none named {matches} (demangler {filt})", flush=True)
    return found


def sass_instructions(lib_path, match: str) -> int:
    """The static SASS instruction count of the one kernel of the library
    whose demangled name holds ``match``: every instruction of the build,
    whether a given launch runs it or not."""
    found = sass_functions(str(lib_path), [match])
    if len(found) != 1:
        raise AssertionError(f"SASS of {lib_path}: {len(found)} kernels named {match!r}")
    return len(_INSTRUCTION.findall(found[0][1]))


def loop_instructions(lib_path, match: str, marker: str) -> list[int]:
    """The static instruction counts of the innermost loops of the one
    kernel whose demangled name holds ``match`` that hold an instruction
    whose opcode starts with ``marker`` (a loop: a branch back to an earlier
    instruction, by address or by label), in address order; a loop that
    holds another such loop is not counted."""
    found = sass_functions(str(lib_path), [match])
    if len(found) != 1:
        raise AssertionError(f"SASS of {lib_path}: {len(found)} kernels named {match!r}")
    at, labels, branches, marked, n = {}, {}, [], [], 0
    for line in found[0][1].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = n
            continue
        ins = _INSTRUCTION.search(line)
        if not ins:
            continue
        at[int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16)] = n
        op = _OPCODE.search(line)
        if op and op.group(1).startswith(marker):
            marked.append(n)
        target = re.search(r"\bBRA\S*\s+(?:!?U?P\w+\s*,\s*)?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins.group(1))
        if target:
            branches.append((n, target.group(1) or int(target.group(2), 16)))
        n += 1
    loops = set()
    for i, t in branches:
        j = labels.get(t) if isinstance(t, str) else at.get(t)
        if j is not None and j <= i:
            loops.add((j, i))
    hits = [(lo, hi) for lo, hi in sorted(loops) if any(lo <= m <= hi for m in marked)]
    inner = [(lo, hi) for lo, hi in hits if not any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in hits)]
    return [hi - lo + 1 for lo, hi in inner]


def sass_fingerprint(lib_path, match: str) -> dict:
    """{kernel<template arguments>: (static instruction count, sha256 of
    the instructions' text, 16 hex digits)} of the library's kernels whose
    demangled name holds ``match``: equal fingerprints are the same SASS
    instruction for instruction."""
    out = {}
    for name, block in sass_functions(str(lib_path), [match]):
        ins = _INSTRUCTION.findall(block)
        key = re.search(re.escape(match) + r"<[^>]*>", name)
        out[key.group(0) if key else name] = (len(ins), hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16])
    return out


def sass_digest(fingerprint: dict) -> tuple[int, int, str]:
    """(kernels, static instructions, 16 hex digits of sha256) of a
    :func:`sass_fingerprint`: one value that moves with any of its
    kernels."""
    digest = hashlib.sha256(json.dumps(sorted(fingerprint.items())).encode()).hexdigest()[:16]
    return len(fingerprint), sum(n for n, _ in fingerprint.values()), digest


# the FP64 pipe's instructions: f64 arithmetic, compares and min/max, the
# conversions to and from f64, and the f64 reciprocal and root seeds
_FP64 = re.compile(r"^(?:DADD|DMUL|DFMA|DSETP|DSET|DMNMX|MUFU\.(?:RCP|RSQ)64H|[FI]2[FI]\.\S*F64)\b")
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def fp64_instructions(lib_path, match: str) -> int:
    """The static count of FP64-pipe instructions (:data:`_FP64`) in the one
    kernel of the library whose demangled name holds ``match``: every one
    of the build, whether a given launch runs it or not."""
    found = sass_functions(str(lib_path), [match])
    if len(found) != 1:
        raise AssertionError(f"SASS of {lib_path}: {len(found)} kernels named {match!r}")
    return sum(bool(_FP64.match(op)) for op in _OPCODE.findall(found[0][1]))
