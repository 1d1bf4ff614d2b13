"""Compare the machine code of two versions of one kernel source, kernel
by kernel.

    python -m sevennet_exp_tpu_torch.tools.sass_compare OTHER.cu [NAME] [OUT.json]

Compiles ``csrc/`` 's source of library NAME (default ``fused_conv``) and
OTHER.cu (for example the same file from an earlier commit, unpacked with
``git archive``) to sm_90a cubins with the port's nvcc flags, disassembles
both with ``cuobjdump -sass`` and reads the registers with ``cuobjdump
-res-usage``. Prints, per kernel, its registers on each side, its
instruction count and whether the SASS is identical; writes the same as
JSON to OUT.json when given. Exits 1 when a kernel's SASS differs or a
kernel is on one side only. Needs nvcc and cuobjdump, not a card.

``digests(NAME)`` gives each kernel's SASS digest (the card tests hold
the conv kernels that a change did not touch to their earlier digests).
``count(NAME)`` gives the static opcode counts of one source's kernels
instead (``chip_smoke.py`` checks with it that the micro-benchmarks'
repeated passes and dense products are all issued, and that the fp32 dot
kernels use no tensor-core opcode).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict

from ..ops import cuda_build

_FUNC = re.compile(r'^\s*Function\s*:\s*(\S+)\s*$')
_RES = re.compile(r'^\s*Function\s+([^\s:]+)\s*:(.*)$')
_REG = re.compile(r'\bREG:(\d+)')
_INSTR = re.compile(r'^\s*/\*[0-9a-f]{4,}\*/\s')
_OPCODE = re.compile(r'^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)')
# the arithmetic and data-movement opcodes the micro-benchmarks count,
# the tensor-core opcodes (warp-level mma.sync, Hopper's wgmma, integer
# and fp8 forms), of which a kernel meant for the CUDA cores has none, and
# the local-memory opcodes (spills, stack arrays)
TENSOR_CORE_OPS = ('HMMA', 'HGMMA', 'IMMA', 'IGMMA', 'QGMMA', 'BMMA',
                   'BGMMA', 'DMMA')
LOCAL_OPS = ('LDL', 'STL')
OPS = ('FFMA', 'FMUL', 'FADD', 'SHFL', 'LDS', 'STS', 'LDG', 'STG',
       *TENSOR_CORE_OPS, *LOCAL_OPS)
# nvcc names an anonymous namespace by a hash of the file's path, which
# differs between two checkouts of one source
_ANON = re.compile(r'_GLOBAL__N__[0-9a-f]+_')
_BLANKS = re.compile(r'\s+')


def _plain_name(text: str) -> str:
    return _ANON.sub('_GLOBAL__N__', text)


def split_functions(sass: str) -> Dict[str, str]:
    """``cuobjdump -sass`` text -> {mangled kernel name: its SASS lines},
    anonymous-namespace hashes taken out of both and each run of blanks
    made one space (cuobjdump pads the encoding column to the longest
    instruction of the whole file, so a kernel added beside another moves
    the other's padding, not its code)."""
    out, name = {}, None
    for line in _plain_name(sass).splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(_BLANKS.sub(' ', line.strip()))
    return {k: '\n'.join(v) for k, v in out.items()}


def registers(res_usage: str) -> Dict[str, int]:
    """``cuobjdump -res-usage`` text -> {mangled kernel name: registers}
    (the REG field on the kernel's line or on the line after it)."""
    out, name = {}, None
    for line in _plain_name(res_usage).splitlines():
        m = _RES.match(line)
        if m:
            name, line = m.group(1), m.group(2)
        r = _REG.search(line)
        if r and name is not None:
            out[name] = int(r.group(1))
            name = None
    return out


def compare(a_sass: str, b_sass: str, a_res: str = '',
            b_res: str = '') -> Dict:
    """Per kernel: present on each side, identical SASS, instruction
    counts and registers; 'equal' is True when every kernel is on both
    sides with identical SASS."""
    fa, fb = split_functions(a_sass), split_functions(b_sass)
    ra, rb = registers(a_res), registers(b_res)
    kernels = {}
    for k in sorted(set(fa) | set(fb)):
        kernels[k] = {
            'in_a': k in fa, 'in_b': k in fb,
            'identical': k in fa and k in fb and fa[k] == fb[k],
            'instructions': [sum(bool(_INSTR.match(ln))
                                 for ln in f[k].splitlines())
                             if k in f else None for f in (fa, fb)],
            'registers': [ra.get(k), rb.get(k)],
            'sha1': [hashlib.sha1(f[k].encode()).hexdigest()[:12]
                     if k in f else None for f in (fa, fb)]}
    return {'equal': bool(kernels) and all(v['identical']
                                           for v in kernels.values()),
            'kernels': kernels}


def opcode_counts(sass: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -sass`` text -> {mangled kernel name: {opcode: static
    count}} for the opcodes ``OPS`` (predicates and modifiers such as
    ``.FTZ`` or ``.IDX`` are not part of the opcode)."""
    out = {}
    for name, text in split_functions(sass).items():
        counts = dict.fromkeys(OPS, 0)
        for line in text.splitlines():
            m = _OPCODE.match(line)
            if m and m.group(1) in counts:
                counts[m.group(1)] += 1
        out[name] = counts
    return out


def _cubin(src: str, out_dir: str, tag: str) -> str:
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    out = os.path.join(out_dir, f'{tag}.cubin')
    subprocess.run([cuda_build.nvcc_path(), *flags, '-cubin', '-o', out, src],
                   check=True, capture_output=True, text=True)
    return out


def _cuobjdump(*args) -> str:
    tool = shutil.which('cuobjdump') or os.path.join(
        os.path.dirname(cuda_build.nvcc_path()), 'cuobjdump')
    return subprocess.run([tool, *args], check=True, capture_output=True,
                          text=True).stdout


def run(other: str, name: str = 'fused_conv') -> Dict:
    """Compile both sources and compare them; a = OTHER, b = csrc/'s."""
    with tempfile.TemporaryDirectory() as tmp:
        texts = []
        for tag, src in (('a', other), ('b', cuda_build.source_path(name))):
            cubin = _cubin(src, tmp, tag)
            texts.append((_cuobjdump('-sass', cubin),
                          _cuobjdump('-res-usage', cubin)))
    res = compare(texts[0][0], texts[1][0], texts[0][1], texts[1][1])
    res.update(a=os.path.abspath(other), b=cuda_build.source_path(name))
    return res


def count(name: str) -> Dict[str, Dict[str, int]]:
    """Static opcode counts of every kernel of library NAME's source
    (``opcode_counts``), compiled with the port's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = _cubin(cuda_build.source_path(name), tmp, name)
        return opcode_counts(_cuobjdump('-sass', cubin))


def digests(name: str, src: str = None) -> Dict[str, str]:
    """{kernel: sha1[:12] of its SASS as ``compare`` reads it} of library
    NAME's source (or of SRC), compiled with the port's flags: a kernel's
    digest is unchanged exactly when ``compare`` calls it identical."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = _cubin(src or cuda_build.source_path(name), tmp, name)
        funcs = split_functions(_cuobjdump('-sass', cubin))
    return {k: hashlib.sha1(v.encode()).hexdigest()[:12]
            for k, v in funcs.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    res = run(argv[0], argv[1] if len(argv) > 1 else 'fused_conv')
    for k, v in res['kernels'].items():
        print(f'{k}: registers {v["registers"][0]} / {v["registers"][1]}, '
              f'instructions {v["instructions"][0]} / '
              f'{v["instructions"][1]}, SASS '
              f'{"identical" if v["identical"] else "DIFFERS"}', flush=True)
    print(f'SASS of every kernel identical: {res["equal"]}', flush=True)
    if len(argv) > 2:
        os.makedirs(os.path.dirname(os.path.abspath(argv[2])), exist_ok=True)
        with open(argv[2], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0 if res['equal'] else 1


if __name__ == '__main__':
    sys.exit(main())
