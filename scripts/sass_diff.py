"""Compare the SASS of two builds of one CUDA kernel library, function by
function: the instruction count of each and the opcodes whose counts
differ.

Run on a machine with the CUDA toolkit (``cuobjdump``), naming the two
shared libraries (for kernel 3, ``build/kernels/block_datapath-*.so`` of
each checkout, built by ``scripts/time_block.py``)::

    python3 scripts/sass_diff.py A.so B.so [--match REGEX]

``--match`` picks the functions by their mangled name (by default kernel
3's f32-carrier, 4-byte-source, 32-bit-index output, tiled output and
mask instances).  The last line is one JSON object: for each function in
both libraries, its instruction count in A and B and the opcode counts
that differ (B minus A).
"""
import collections
import json
import re
import subprocess
import sys

ARGS = [a for a in sys.argv[1:] if not a.startswith("--match")]
MATCH = next((a.split("=", 1)[1] for a in sys.argv[1:]
              if a.startswith("--match=")),
             r"(out_kernel|out_tiled_kernel|mask_kernel)IfLi4EjE")
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def functions(lib):
    """{function name without its file-local prefix: [opcode, ...]}."""
    txt = subprocess.run([CUOBJDUMP, "--dump-sass", lib], check=True,
                         capture_output=True, text=True).stdout
    out = {}
    for block in re.split(r"\n(?=\s+Function : )", txt):
        m = re.match(r"\s+Function : (\S+)", block)
        if not m or not re.search(MATCH, m.group(1)):
            continue
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
        out[name] = [op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            block)]
    return out


def main():
    a, b = (functions(lib) for lib in ARGS[:2])
    report = {}
    for name in sorted(set(a) & set(b)):
        ca, cb = collections.Counter(a[name]), collections.Counter(b[name])
        diff = {op: cb[op] - ca[op] for op in sorted(set(ca) | set(cb))
                if cb[op] != ca[op]}
        report[name] = {"a": len(a[name]), "b": len(b[name]), "diff": diff}
        top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12]
        print(f"{name}: {len(a[name])} -> {len(b[name])} instructions; "
              f"{top}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
