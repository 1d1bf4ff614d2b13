"""Each cell's run path, started in a fresh process on the CPU, loads no
module whose top-level name is JAX's or the JAX package's (names compared
whole: the port's own name begins with the JAX package's); so does the
MD path, whose cells wait (PERF.md)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + '/portbench', {root!r} + '/portbench/tests']
import run
from conftest import MD_LIMITS, md_cell, small_mix
cell = md_cell({mix!r}) if {md} else None
with small_mix({mix!r}) as mix:
    res, lines = run.execute({name!r}, 7, 0.2, {trace}, 'cpu', 0.0, mix=mix,
                             limits=MD_LIMITS if {md} else None, cell=cell)
print(json.dumps({{'forbidden': run.loaded_forbidden(),
                   'keys': list(res)}}))
"""


@pytest.mark.parametrize('name,mix,md,trace', [
    ('sevennet-0.nacl.nvt-8k', 'nvt-8k', True, True),
    ('sevennet-0.nacl.train-b16', 'train-b16', False, True)])
def test_fresh_process_loads_no_jax(name, mix, md, trace):
    code = SCRIPT.format(root=ROOT, name=name, mix=mix, md=md, trace=trace)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got['forbidden'] == []
    assert got['keys'][:5] == ['correct', 'attempted', 'failed', 'metrics',
                               'device']
    assert got['keys'][-1] == 'checks'
