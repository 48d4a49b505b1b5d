#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernels in two built trees.

    python3 scripts/sass_diff.py <tree A>/hnsw_tpu_torch/_build \\
        <tree B>/hnsw_tpu_torch/_build [nameA=nameB ...]

For each library built from csrc/ (hnsw_tpu_torch/ops/_cuda.py builds them
at first use) it disassembles both trees' copies with cuobjdump, and for
every kernel present in both prints its instruction count in each and how
many instructions differ (0: the same machine code). A pair nameA=nameB
compares two kernels whose names differ (pieces of the mangled names, as in
chip_smoke.KERNEL_ENTRIES, e.g. 20last_tile_min_kernel=16last_tile_kernelILb1E).
Needs the CUDA toolkit's cuobjdump; run it where the kernels were built.
"""

import difflib
import re
import subprocess
import sys
from pathlib import Path

CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def kernels(lib: Path) -> dict:
    """{mangled kernel name: [instruction, ...]}, the file's anonymous
    namespace tag removed so that two builds' names agree."""
    out = subprocess.run([CUOBJDUMP, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    out = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "ANON", out)
    res = {}
    for part in out.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        res[name.strip()] = [re.sub(r"\s+", " ", m.group(1)) for m in
                             re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body)]
    return res


def differing(a: list, b: list) -> int:
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return sum(max(i2 - i1, j2 - j1) for op, i1, i2, j1, j2 in sm.get_opcodes()
               if op != "equal")


def main() -> int:
    dir_a, dir_b = Path(sys.argv[1]), Path(sys.argv[2])
    renames = dict(arg.split("=", 1) for arg in sys.argv[3:])
    for lib_a in sorted(dir_a.glob("lib*.so")):
        stem = lib_a.name.rsplit("_", 1)[0]
        found = sorted(dir_b.glob(f"{stem}_*.so"))
        if not found:
            continue
        ka, kb = kernels(lib_a), kernels(found[-1])
        pairs = [(n, n) for n in sorted(ka) if n in kb]
        for piece_a, piece_b in renames.items():
            na = [n for n in ka if piece_a in n]
            nb = [n for n in kb if piece_b in n]
            if na and nb:
                pairs.append((na[0], nb[0]))
        for na, nb in pairs:
            print(stem, na if na == nb else f"{na} -> {nb}", "instructions",
                  len(ka[na]), len(kb[nb]), "differing",
                  differing(ka[na], kb[nb]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
