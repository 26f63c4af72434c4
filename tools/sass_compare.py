#!/usr/bin/env python3
"""Function-by-function SASS of a kernel source against a parent's.

    python3 tools/sass_compare.py PARENT.cu [SOURCE.cu]

Builds both sources with the package's ``nvcc`` flags
(``ops/cuda_build.py``), disassembles them with ``cuobjdump -sass``,
demangles each function's name with ``cu++filt`` and pairs the
functions by name, a ``false`` (``(bool)0``) template argument of the
source dropped: an instantiation that a new ``bool`` template parameter
turned off is compared with the parent's function it was.  The source's
instantiations with a ``true`` argument are counted and set aside.  For
each pair it prints the instruction counts, whether the instructions
are the same (addresses, encodings and branch targets aside) and the
first lines that differ.  ``SOURCE`` defaults to
``lightgbm_tpu_torch/csrc/hist_wide.cu``.  Needs the CUDA toolkit.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(cuda_build, src: str, out: str) -> None:
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", out, src], check=True)


def functions(bindir: str, so: str) -> dict:
    """Demangled name -> its instructions."""
    text = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = subprocess.run(
                [os.path.join(bindir, "cu++filt"), m.group(1)],
                capture_output=True, text=True, check=True).stdout.strip()
            out[name] = []
            continue
        if name is None:
            continue
        s = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
        if s and not re.search(r"\b(BRA|BSSY|CALL)\b", s) \
                and not s.startswith((".", "=")):
            out[name].append(s)
    return out


def switched_on(name: str) -> bool:
    return "true" in name or "(bool)1" in name


def key(name: str) -> str:
    name = re.sub(r", (false|\(bool\)0)>", ">", name)
    name = re.sub(r"<(false|\(bool\)0)>", "", name)
    name = re.sub(r"^void ", "", name)
    return re.sub(r"\(.*\)$", "", name)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lightgbm_tpu_torch.ops import cuda_build
    parent = sys.argv[1]
    source = (sys.argv[2] if len(sys.argv) > 2
              else str(cuda_build.CSRC / "hist_wide.cu"))
    bindir = os.path.dirname(cuda_build.nvcc_path())
    tmp = tempfile.mkdtemp(prefix="sass_compare_")
    build(cuda_build, parent, f"{tmp}/parent.so")
    build(cuda_build, source, f"{tmp}/source.so")
    p = functions(bindir, f"{tmp}/parent.so")
    c = functions(bindir, f"{tmp}/source.so")
    cur = {key(n): v for n, v in c.items() if not switched_on(n)}
    same_all = True
    for n, v in sorted(p.items()):
        k = key(n)
        w = cur.get(k)
        same = w == v
        same_all &= same
        print(f"{k}: {len(v)} instructions (source: "
              f"{len(w) if w is not None else 'missing'}), same: {same}")
        if w is not None and not same:
            diffs = [(i, a, b) for i, (a, b) in enumerate(zip(v, w))
                     if a != b]
            print(f"  {len(diffs)} lines differ; first: {diffs[:4]}")
    print(f"instantiations with a true argument: "
          f"{sum(switched_on(n) for n in c)}")
    print(f"all the same: {same_all}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
