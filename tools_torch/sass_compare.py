#!/usr/bin/env python3
"""Compare the SASS of one CUDA source between this checkout and another.

    python3 tools_torch/sass_compare.py --base build/base \
        [--source fused_mlp.cu] [--pattern Lb0E]

Compiles ``vanerf_tpu_torch/csrc/<source>`` of both checkouts to a cubin
with the flags the library is built with (``ops/_cuda.py::NVCC_FLAGS``),
disassembles each with ``cuobjdump -sass`` and compares, function by
function, the functions whose mangled names contain ``--pattern`` (by
default ``Lb0E``: csrc/fused_mlp.cu's float32 instantiations, BF = false).
Prints one line a function (equal or not, instruction counts) and one JSON
line; exits 1 where a function differs or exists in one checkout only.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit on the card's machine).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def sass_functions(checkout: str, source: str, nvcc: str, flags,
                   work: str) -> dict:
    """{mangled name: [instruction text, ...]} of ``source`` in
    ``checkout``, the instructions' addresses and encodings dropped."""
    src = os.path.join(checkout, "vanerf_tpu_torch", "csrc", source)
    cubin = os.path.join(work, "kernels.cubin")
    keep = [f for f in flags if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *keep, "-cubin", "-o", cubin, src], check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="the other checkout's root (e.g. the parent "
                         "unpacked with git archive)")
    ap.add_argument("--source", default="fused_mlp.cu")
    ap.add_argument("--pattern", default="Lb0E")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from vanerf_tpu_torch.ops._cuda import NVCC_FLAGS, _nvcc
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as work:
        got = {}
        for tag, root in (("this", REPO),
                          ("base", os.path.abspath(args.base))):
            os.makedirs(os.path.join(work, tag))
            got[tag] = {k: v for k, v in sass_functions(
                root, args.source, nvcc, NVCC_FLAGS,
                os.path.join(work, tag)).items() if args.pattern in k}
    names = sorted(set(got["this"]) | set(got["base"]))
    rows, same = [], True
    for n in names:
        a, b = got["this"].get(n), got["base"].get(n)
        equal = a is not None and a == b
        same &= equal
        rows.append({"function": n, "equal": equal,
                     "instructions": len(a) if a else None,
                     "base_instructions": len(b) if b else None})
        print(f"{'equal ' if equal else 'DIFFER'} {n}: "
              f"{rows[-1]['instructions']} / {rows[-1]['base_instructions']}"
              " instructions")
    print(json.dumps({"source": args.source, "pattern": args.pattern,
                      "functions": len(names), "all_equal": same,
                      "instructions": sum(r["instructions"] or 0
                                          for r in rows)}))
    return 0 if same and names else 1


if __name__ == "__main__":
    sys.exit(main())
