"""The SASS comparison tool's parsing, on text laid out as ``cuobjdump``
prints it (the tool itself needs nvcc and runs where the kernels build)."""

import pytest

from sevennet_exp_tpu_torch.tools import sass_compare

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]

\tcode for sm_90a
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
\t\t.........................


\t\tFunction : _Z3barPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   {OP} ;
        /*0020*/                   EXIT ;
\t\t.........................
"""

RES = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z3barPf:
  REG:{R} STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:536 TEXTURE:0 SURFACE:0
 Function _Z3fooPf:REG:8 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:528
"""


def test_split_and_registers():
    funcs = sass_compare.split_functions(SASS.replace('{OP}', 'NOP'))
    assert sorted(funcs) == ['_Z3barPf', '_Z3fooPf']
    assert 'EXIT' in funcs['_Z3fooPf'] and 'NOP' not in funcs['_Z3fooPf']
    assert sass_compare.registers(RES.replace('{R}', '72')) == {
        '_Z3barPf': 72, '_Z3fooPf': 8}


@pytest.mark.parametrize('op, reg, equal', [('NOP', '72', True),
                                            ('BAR.SYNC 0x0', '72', False),
                                            ('NOP', '80', True)])
def test_compare_kernel_by_kernel(op, reg, equal):
    a = SASS.replace('{OP}', 'NOP')
    res = sass_compare.compare(a, SASS.replace('{OP}', op),
                               RES.replace('{R}', '72'),
                               RES.replace('{R}', reg))
    assert res['equal'] is equal
    assert res['kernels']['_Z3fooPf']['identical']
    assert res['kernels']['_Z3barPf']['identical'] is equal
    assert res['kernels']['_Z3barPf']['instructions'] == [3, 3]
    assert res['kernels']['_Z3barPf']['registers'] == [72, int(reg)]


def test_anonymous_namespace_hash_is_not_a_difference():
    """nvcc names an anonymous namespace by the file's path: the same
    source in two checkouts gives two names for one kernel."""
    a = SASS.replace('{OP}', 'NOP').replace(
        '_Z3barPf', '_ZN46_GLOBAL__N__882dfa53_13_k_cu_97ac331b3barEPf')
    b = a.replace('882dfa53', '12f52560')
    res = sass_compare.compare(a, b, RES.replace('{R}', '72').replace(
        '_Z3barPf', '_ZN46_GLOBAL__N__882dfa53_13_k_cu_97ac331b3barEPf'))
    assert res['equal'] and len(res['kernels']) == 2
    assert res['kernels']['_ZN46_GLOBAL__N__13_k_cu_97ac331b3barEPf'][
        'registers'] == [72, None]


def test_a_kernel_on_one_side_only_is_a_difference():
    a = SASS.replace('{OP}', 'NOP')
    b = a[:a.index('\t\tFunction : _Z3barPf')]
    res = sass_compare.compare(a, b)
    assert not res['equal']
    assert res['kernels']['_Z3barPf']['in_b'] is False


def test_needs_a_source():
    assert sass_compare.main([]) == 2


def test_opcode_counts_per_kernel():
    sass = SASS.replace('{OP}', 'FFMA R5, R2, R3, R5 ;\n'
                        '        /*0018*/               @!P0 FFMA R5, R2, R3, '
                        'R5 ;\n        /*001c*/                   SHFL.IDX '
                        'PT, R4, R4, RZ, 0x1f ;')
    counts = sass_compare.opcode_counts(sass)
    assert counts['_Z3barPf']['FFMA'] == 2
    assert counts['_Z3barPf']['SHFL'] == 1
    assert counts['_Z3fooPf']['FFMA'] == 0
    assert set(counts['_Z3fooPf']) == set(sass_compare.OPS)


def test_opcode_counts_of_tensor_core_ops():
    """The tensor-core opcodes are counted by their stem (``HMMA.16816.F32
    .BF16`` is an HMMA)."""
    sass = SASS.replace('{OP}', 'HMMA.16816.F32.BF16 R8, R12, R16, R8 ;\n'
                        '        /*0018*/                   FFMA R5, R2, R3, '
                        'R5 ;')
    counts = sass_compare.opcode_counts(sass)
    assert counts['_Z3barPf']['HMMA'] == 1 and counts['_Z3barPf']['FFMA'] == 1
    assert not any(counts['_Z3fooPf'][op]
                   for op in sass_compare.TENSOR_CORE_OPS)


@pytest.mark.parametrize('pad, equal', [(' ' * 9, True), ('', True),
                                        (' R0', False)])
def test_column_padding_is_not_a_difference(pad, equal):
    """cuobjdump pads each line's encoding comment to the longest
    instruction of the file: a kernel added to a source moves the padding
    of the others. Blanks are not code; an operand is."""
    a = SASS.replace('{OP}', 'NOP ;                   /* 0x0000000000007918 */')
    b = a.replace('NOP ;', f'NOP{pad} ;')
    res = sass_compare.compare(a, b)
    assert res['equal'] is equal
    assert res['kernels']['_Z3fooPf']['identical']


@pytest.mark.parametrize('op', ['LDL.64 R4, [R1+0x8]', 'STL [R1+0x4], R3'])
def test_local_memory_opcodes_are_counted(op):
    """Spills and stack arrays show as LDL / STL, which the geometry-fused
    kernels must not have."""
    counts = sass_compare.opcode_counts(SASS.replace('{OP}', op + ' ;'))
    assert sum(counts['_Z3barPf'][o] for o in sass_compare.LOCAL_OPS) == 1
    assert not any(counts['_Z3fooPf'][o] for o in sass_compare.LOCAL_OPS)


def test_digests_agree_with_compare(monkeypatch):
    """A kernel's digest changes exactly when ``compare`` calls it
    different (padding blanks are not a difference)."""
    a = SASS.replace('{OP}', 'NOP ;')
    texts = {'a': a, 'b': a.replace('NOP ;', 'NOP          ;'),
             'c': a.replace('NOP ;', 'NOP R0 ;')}
    monkeypatch.setattr(sass_compare, '_cubin',
                        lambda src, out_dir, tag: src)
    monkeypatch.setattr(sass_compare, '_cuobjdump',
                        lambda flag, cubin: texts[cubin])
    d = {k: sass_compare.digests('fused_conv', k) for k in texts}
    assert d['a'] == d['b'] and d['a']['_Z3fooPf'] == d['c']['_Z3fooPf']
    assert d['a']['_Z3barPf'] != d['c']['_Z3barPf']
    res = sass_compare.compare(texts['a'], texts['c'])
    assert res['kernels']['_Z3barPf']['sha1'] == [d['a']['_Z3barPf'],
                                                  d['c']['_Z3barPf']]
