"""Instruction counts of the port's CUDA kernels, read from their SASS.

    python -m vcs_h264_tpu_torch.sass_report [--out FILE]

Builds the kernel library as `ops._build` does (or loads it when it is
built), disassembles it with `cuobjdump -sass` and prints, for every
kernel: the instructions of its listing (NOPs left out; every loop of the
strip kernels is unrolled, so the count is what one thread issues, a
guarded slow path such as the division's included), the most frequent
opcodes, and its registers and static shared memory from `cuobjdump
-res-usage`. `--out` also writes the whole listing there. Needs the CUDA
toolkit beside nvcc; it runs where the kernels are built.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
from pathlib import Path

from vcs_h264_tpu_torch.ops import _build

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_RES = re.compile(r"Function\s+(\S+):\s*(.*)")


def _tool(name: str) -> str:
    return str(Path(_build.find_nvcc()).with_name(name))


def _demangle(names: list) -> dict:
    """Mangled -> readable names, by the toolkit's cu++filt where it is."""
    filt = _tool("cu++filt")
    if not Path(filt).exists():
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def count_listing(sass: str) -> dict:
    """{mangled kernel name: Counter of its opcodes} of a `cuobjdump -sass`
    listing, NOPs left out, a predicate not counted as an opcode."""
    counts, current = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.match(line)
        if m and current is not None and m.group(1) != "NOP":
            current[m.group(1)] += 1
    return counts


def kernel_counts(lib: Path):
    """`count_listing` of the library's listing, and the listing."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return count_listing(sass), sass


def resources(lib: Path) -> dict:
    out = subprocess.run([_tool("cuobjdump"), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    lines = out.splitlines()
    res = {}
    for i, line in enumerate(lines):
        m = _RES.search(line)
        if m:
            rest = m.group(2) or (lines[i + 1] if i + 1 < len(lines) else "")
            res[m.group(1)] = " ".join(
                w for w in rest.split() if w.split(":")[0] in
                ("REG", "SHARED", "LOCAL", "STACK"))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the whole SASS listing here")
    args = ap.parse_args()
    _build.load_library()
    lib = _build.library_path()
    counts, sass = kernel_counts(lib)
    res = resources(lib)
    names = _demangle(sorted(counts))
    for mangled in sorted(counts, key=lambda n: names[n]):
        c = counts[mangled]
        top = ", ".join(f"{op} {n}" for op, n in c.most_common(12))
        print(f"[sass] {names[mangled]}: {sum(c.values())} instructions; "
              f"{res.get(mangled, 'resources not read')}; {top}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(sass)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
